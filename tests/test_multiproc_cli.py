"""Multi-process CLI plumbing (SURVEY.md §7 step 6): REAL 2-OS-process
`find_circ --nproc` runs —
jax.distributed init, batch-granular sharding on the NATIVE fast path,
per-process local detection, file-based junction merge on process 0,
psum'd stats — must produce byte-identical BED + stats to a
single-process run. Covered combinations: fastq (native fast path,
small and ~10k-read libraries), SAM input (per-read path), journal
write + resume, and journal sharding-mismatch rejection."""

import json
import os
import socket
import subprocess
import sys

import pytest

from find_circ2_tpu.utils.simulate import simulate

CLI = [sys.executable, "-m", "find_circ2_tpu.cli.main", "find_circ"]


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_genome(tmp_path, sim):
    from find_circ2_tpu.io.fasta import write_fasta
    from find_circ2_tpu.io.twobit import codes_to_seq

    fa = tmp_path / "g.fa"
    write_fasta(fa, [(n, codes_to_seq(
        sim.genome.codes[sim.genome.chrom_offsets[i]:
                         sim.genome.chrom_offsets[i]
                         + sim.genome.chrom_lengths[i]]))
        for i, n in enumerate(sim.genome.chrom_names)])
    return fa


def _write_inputs(tmp_path, **sim_kw):
    from find_circ2_tpu.io.fastq import FastqRecord, write_fastq

    kw = dict(seed=91, n_circ=4, n_linear=2, reads_per_junction=3,
              n_contiguous=8, n_random=4, err_rate=0.3)
    kw.update(sim_kw)
    sim = simulate(**kw)
    fa = _write_genome(tmp_path, sim)
    fq = tmp_path / "r.fastq"
    with open(fq, "wt") as fh:
        for name, seq in sim.reads:
            write_fastq(fh, FastqRecord(name, seq, "I" * len(seq)))
    return fa, fq


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ("/root/repo" + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env["JAX_PLATFORMS"] = "cpu"
    # The workers form their own tiny distributed job; drop the test
    # session's virtual-device forcing so each process is 1 CPU device.
    env.pop("XLA_FLAGS", None)
    return env


def _args_for(tmp_path, tag, inputs, base):
    a = list(base)
    a[a.index(None)] = str(tmp_path / f"{tag}.stats")
    a[a.index(None)] = str(tmp_path / f"{tag}.bed")
    return CLI + [str(f) for f in inputs] + a


def _run_single(tmp_path, inputs, base, timeout=900):
    out = subprocess.run(_args_for(tmp_path, "single", inputs, base),
                         env=_env(), timeout=timeout,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    return out


def _run_nproc(tmp_path, inputs, base, extra=(), tag="nproc",
               timeout=900, expect_fail=False):
    port = _free_port()
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            _args_for(tmp_path, tag, inputs, base)
            + ["--nproc", "2", "--proc-id", str(pid),
               "--coordinator", f"localhost:{port}"] + list(extra),
            env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    if expect_fail:
        assert any(p.returncode != 0 for p in procs), \
            "\n====\n".join(o[-2000:] for o in outs)
        return outs
    for p in procs:
        assert p.returncode == 0, "\n====\n".join(o[-2000:] for o in outs)
    return outs


def _assert_equal_outputs(tmp_path, tag="nproc"):
    single_bed = (tmp_path / "single.bed").read_text()
    assert (tmp_path / f"{tag}.bed").read_text() == single_bed
    assert (tmp_path / f"{tag}.stats").read_text() == \
        (tmp_path / "single.stats").read_text()
    assert "circ_" in single_bed
    # Part files were cleaned up after the merge.
    assert not list(tmp_path.glob(f"{tag}.bed.part*"))


def test_nproc2_cli_byte_identical(tmp_path):
    fa, fq = _write_inputs(tmp_path)
    base = ["--reads-format", "fastq", "-G", str(fa), "-s", None,
            "-o", None, "--batch-size", "32"]
    _run_single(tmp_path, [fq], base)
    _run_nproc(tmp_path, [fq], base)
    _assert_equal_outputs(tmp_path)


def test_nproc2_native_large_library(tmp_path):
    """~10k reads through the native fast path (batch-granular shard):
    multi-proc output must stay byte-identical at a realistic batch
    count."""
    from find_circ2_tpu import native
    if not native.available():
        pytest.skip("native loader unavailable")
    fa, fq = _write_inputs(tmp_path, seed=17, n_circ=40, n_linear=20,
                           reads_per_junction=100, n_contiguous=800,
                           n_random=200, err_rate=0.2,
                           chrom_lengths={"chrS1": 600_000,
                                          "chrS2": 400_000})
    n_reads = sum(1 for line in open(fq) if line.startswith("@"))
    assert n_reads >= 7000
    base = ["--reads-format", "fastq", "-G", str(fa), "-s", None,
            "-o", None, "--batch-size", "512"]
    _run_single(tmp_path, [fq], base, timeout=900)
    _run_nproc(tmp_path, [fq], base, timeout=900)
    _assert_equal_outputs(tmp_path)


def test_nproc2_sam_input(tmp_path):
    """--nproc with SAM text input (per-read path, islice sharding)."""
    from find_circ2_tpu.io.fastq import read_fastq
    fa, fq = _write_inputs(tmp_path)
    sam = tmp_path / "r.sam"
    with open(sam, "wt") as fh:
        fh.write("@HD\tVN:1.6\n")
        for rec in read_fastq(fq):
            fh.write(f"{rec.name}\t4\t*\t0\t0\t*\t*\t0\t0\t"
                     f"{rec.seq}\t{rec.qual}\n")
    base = ["--reads-format", "sam", "-G", str(fa), "-s", None,
            "-o", None, "--batch-size", "32", "--no-prefilter"]
    _run_single(tmp_path, [sam], base)
    _run_nproc(tmp_path, [sam], base)
    _assert_equal_outputs(tmp_path)


def test_nproc2_journal_resume(tmp_path):
    """--nproc with per-rank journals: first run writes {out}.r{rank}
    with a sharding header; rerun replays every batch from the journal
    and produces byte-identical output."""
    fa, fq = _write_inputs(tmp_path)
    # batch 8 -> ~4 batches, so BOTH ranks own batches and write their
    # per-rank journals.
    base = ["--reads-format", "fastq", "-G", str(fa), "-s", None,
            "-o", None, "--batch-size", "8"]
    jpath = tmp_path / "run.journal"
    _run_single(tmp_path, [fq], base)
    _run_nproc(tmp_path, [fq], base, extra=["--journal", str(jpath)])
    _assert_equal_outputs(tmp_path)
    # Per-rank journal files exist and carry the sharding header.
    for rank in range(2):
        jf = tmp_path / f"run.journal.r{rank}"
        assert jf.exists()
        head = json.loads(jf.read_text().splitlines()[0])
        assert head == {"meta": {"nproc": 2, "proc_id": rank}}
    # Resume: same sharding, same journals -> pure replay, same bytes.
    _run_nproc(tmp_path, [fq], base, extra=["--journal", str(jpath)],
               tag="resumed")
    assert (tmp_path / "resumed.bed").read_text() == \
        (tmp_path / "nproc.bed").read_text()
    assert (tmp_path / "resumed.stats").read_text() == \
        (tmp_path / "nproc.stats").read_text()


def test_journal_sharding_mismatch_rejected(tmp_path):
    """A journal written under one (nproc, proc_id) must refuse replay
    under another."""
    from find_circ2_tpu.utils.journal import RunJournal

    j = RunJournal(tmp_path / "j", meta={"nproc": 2, "proc_id": 0})
    j.record(0, [])
    # Same sharding: fine.
    RunJournal(tmp_path / "j",
               meta={"nproc": 2, "proc_id": 0}).completed_batches()
    # Different sharding: loud failure.
    with pytest.raises(ValueError, match="journal"):
        RunJournal(tmp_path / "j",
                   meta={"nproc": 4, "proc_id": 0}).completed_batches()
    # A metaless reader (single-proc legacy) ignores the header.
    out = RunJournal(tmp_path / "j").completed_batches()
    assert 0 in out
