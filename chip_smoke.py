"""End-to-end check that the detection pipeline runs on one GPU.

    python chip_smoke.py                 # one card (the default run)
    python chip_smoke.py --four-cards    # --mesh 2x2 and --nproc 4 vs one card
    python chip_smoke.py --cpu-rehearsal # tiny sizes, XLA CPU backend

Default phases, in order; any failure exits non-zero before the last line:

1. device    the card's name and power limit (nvidia-smi), then JAX's
             platform, device kind and count in a child process; fails
             unless JAX runs on a GPU.
2. main path the bench's RNase-R library (seed 7, 6,000 circles, 800
             linear junctions, depth 12, ~95k reads of 100 bp) on one
             64 Mbp chromosome with 45% repeats, written as FASTA and
             FASTQ.gz; the index is built once with `find_circ2 index`
             (cached under .smoke/), then `find_circ2 run reads.fastq.gz
             -x INDEX --filter --profile` runs in a child process.
3. checks    (a) the same command on the XLA CPU backend: splice_sites.bed,
             circ_candidates.bed and stats.txt byte-identical; (b) a
             1,200-read slice, device BED == `--backend oracle` BED;
             (c) precision and recall of the filtered calls against the
             planted circles.
4. gpu tests `pytest -m gpu tests/test_gpu.py`: every test marked for
             the card runs and passes.
5. kernel    dispatch_packed on the 64 Mbp index for three batches of
             4,096 reads, rows == the CPU oracle's call_read on 500 reads
             that need no host follow-up; compiled memory analysis and
             peak device memory.

The last line of standard output is the JSON
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
The smoke's own process opens the card only in phase 5, after every
child that used it has exited (one JAX process per card).
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")      # listed in .gitignore

# The library: bench.py's filter-stack traffic at its default scale
# (fs_scale=4), on one human-chr20-sized chromosome (BASELINE configs[1]).
FULL = dict(seed=7, genome_bp=64_000_000, n_circ=6000, n_linear=800,
            depth=12.0, repeat_frac=0.45, slice_reads=1200,
            kernel_batches=3, kernel_sample=500)
TINY = dict(seed=7, genome_bp=2_000_000, n_circ=300, n_linear=40,
            depth=12.0, repeat_frac=0.45, slice_reads=1024,
            kernel_batches=1, kernel_sample=100)
CLI = [sys.executable, "-m", "find_circ2_tpu.cli.main"]
OUT_FILES = ("splice_sites.bed", "circ_candidates.bed", "stats.txt")
# ReadCall fields a junction row carries (non-junction rows: status only).
JUNCTION_FIELDS = ("kind", "chrom_idx", "start", "end", "sense",
                   "align_strand", "edits", "n_bp", "overlap", "qual_left",
                   "qual_right", "signal")


def log(msg: str) -> None:
    print(f"[smoke +{time.time() - T0:7.1f}s] {msg}", flush=True)


T0 = time.time()


def child_env(cpu: bool, **extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if cpu:
        env["JAX_PLATFORMS"] = "cpu"
        env["CUDA_VISIBLE_DEVICES"] = ""
    env.update(extra)
    return env


def run_child(args, env, what: str, timeout: float = 900) -> tuple[str, float]:
    """Run a child to completion; fail the phase on a non-zero exit.
    Returns (stderr, seconds)."""
    t = time.time()
    p = subprocess.run(args, env=env, capture_output=True, text=True,
                       timeout=timeout, cwd=ROOT)
    dt = time.time() - t
    if p.returncode != 0:
        sys.stdout.write(p.stdout[-4000:])
        sys.stdout.write(p.stderr[-8000:])
        raise SystemExit(f"smoke: {what} exited {p.returncode}")
    return p.stderr, dt


def quiet(stderr: str) -> str:
    """Child stderr without XLA's own log lines."""
    return "\n".join(line for line in stderr.splitlines()
                     if not line[:1] in ("E", "W", "I")
                     or not line[1:5].isdigit())


def phase_device(cpu: bool, want: int) -> dict:
    if not cpu:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        for line in smi.stdout.strip().splitlines():
            print(line.strip(), flush=True)
    code = ("import jax, json; d = jax.devices(); print(json.dumps(dict("
            "backend=jax.default_backend(), platform=d[0].platform, "
            "kind=d[0].device_kind, count=len(d))))")
    p = subprocess.run([sys.executable, "-c", code], env=child_env(cpu),
                       capture_output=True, text=True, timeout=300,
                       check=True)
    dev = json.loads(p.stdout.strip().splitlines()[-1])
    log(f"jax: platform={dev['platform']} device_kind={dev['kind']} "
        f"count={dev['count']}")
    if dev["backend"] != ("cpu" if cpu else "gpu"):
        raise SystemExit(f"smoke: JAX runs on '{dev['backend']}', not a GPU")
    if not cpu and dev["count"] < want:
        raise SystemExit(f"smoke: {want} card(s) needed, JAX sees "
                         f"{dev['count']}")
    return dev


def card_label(cpu: bool) -> str:
    if cpu:
        return "XLA CPU (rehearsal)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0].strip()


def make_library(size: dict) -> dict:
    """Genome FASTA, reads FASTQ.gz, a read slice and the planted truths,
    generated from the seed once per size (cached under .smoke/)."""
    from find_circ2_tpu.config import Config
    from find_circ2_tpu.index.hashtable import TABLE_FORMAT
    key = hashlib.sha1(json.dumps(
        [size, TABLE_FORMAT, repr(Config())]).encode()).hexdigest()[:12]
    d = os.path.join(WORK, f"lib-{key}")
    paths = dict(dir=d, genome=os.path.join(d, "genome.fa"),
                 reads=os.path.join(d, "reads.fastq.gz"),
                 slice=os.path.join(d, "slice.fastq.gz"),
                 truths=os.path.join(d, "truths.json"),
                 index=os.path.join(d, "index"))
    if os.path.exists(paths["truths"]):
        log(f"library: cached in {os.path.relpath(d, ROOT)}")
        return paths
    from find_circ2_tpu.io.fasta import write_fasta
    from find_circ2_tpu.io.twobit import codes_to_seq
    from find_circ2_tpu.utils.simulate import rnase_r_library
    t = time.time()
    sim = rnase_r_library(seed=size["seed"],
                          chrom_lengths={"chr20": size["genome_bp"]},
                          n_circ=size["n_circ"], n_linear=size["n_linear"],
                          depth_mean=size["depth"],
                          repeat_frac=size["repeat_frac"])
    tmp = d + f".tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    g = sim.genome
    write_fasta(os.path.join(tmp, "genome.fa"), [
        (n, codes_to_seq(g.codes[g.chrom_offsets[i]:
                                 g.chrom_offsets[i] + g.chrom_lengths[i]]))
        for i, n in enumerate(g.chrom_names)])
    for name, reads in (("reads.fastq.gz", sim.reads),
                        ("slice.fastq.gz", sim.reads[:size["slice_reads"]])):
        with gzip.open(os.path.join(tmp, name), "wt") as fh:
            fh.writelines(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                          for n, s in reads)
    with open(os.path.join(tmp, "truths.json"), "w") as fh:
        json.dump([[t_.kind, t_.chrom, t_.start, t_.end, len(t_.reads)]
                   for t_ in sim.truths], fh)
    if os.path.exists(d):
        shutil.rmtree(d)
    os.replace(tmp, d)
    log(f"library: {len(sim.reads)} reads, {len(sim.truths)} planted "
        f"junctions, {size['genome_bp']:,} bp genome, generated in "
        f"{time.time() - t:.1f}s")
    return paths


def build_index(lib: dict, cpu: bool) -> None:
    if os.path.exists(os.path.join(lib["index"], "meta.json")):
        log("setup: index cached (find_circ2 index output reused)")
        return
    _, dt = run_child(CLI + ["index", lib["genome"], "-o", lib["index"]],
                      child_env(cpu), "find_circ2 index", timeout=1800)
    log(f"setup: index + query table + neighbor table built in {dt:.1f}s "
        f"(find_circ2 index, host work)")


def cli_run(lib: dict, reads: str, out: str, cpu: bool,
            backend: str = "device") -> tuple[str, float]:
    args = CLI + ["run", reads, "-x", lib["index"], "-o", out, "-n", "smoke",
                  "--filter", "--backend", backend, "--profile"]
    return run_child(args, child_env(cpu), f"find_circ2 run ({out})")


def same_files(a: str, b: str, names) -> None:
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            if fa.read() != fb.read():
                raise SystemExit(f"smoke: {name} differs between "
                                 f"{os.path.relpath(a, ROOT)} and "
                                 f"{os.path.relpath(b, ROOT)}")


def stage_value(stderr: str, name: str) -> str | None:
    for line in stderr.splitlines():
        parts = line.split("\t")
        if parts[0] == name and len(parts) > 1:
            return parts[1]
    return None


def precision_recall(lib: dict, out: str) -> tuple[float, float, int]:
    from find_circ2_tpu.config import Config
    from find_circ2_tpu.io.bed import read_bed
    cfg = Config()
    truth = {(c, s, e) for kind, c, s, e, n in json.load(open(lib["truths"]))
             if kind == "circular" and n >= cfg.min_support}
    called = {(r.chrom, r.start, r.end) for r in
              read_bed(os.path.join(out, "circ_candidates.bed"))}
    tp = len(truth & called)
    return tp / max(1, len(called)), tp / max(1, len(truth)), len(truth)


def phase_main(lib: dict, cpu: bool, label: str) -> str:
    out_dev = os.path.join(WORK, "out_device")
    err, dt = cli_run(lib, lib["reads"], out_dev, cpu)
    print(quiet(err), flush=True)
    wall = float(stage_value(err, "wall").rstrip("s"))
    rps = stage_value(err, "reads_per_s")
    rescue = ("worker thread" if stage_value(err, "rescue_dispatch")
              else "in line")
    log(f"main path: child {dt:.1f}s; setup {stage_value(err, 'setup')} "
        f"(index load); compile {stage_value(err, 'compile')}; streaming "
        f"wall {wall:.3f}s")
    log(f"main path: {rps} reads/s end to end (streaming wall, compile "
        f"included) on {label} — measured once, not a benchmark")
    log(f"main path: 2-mm rescue ran on the {rescue}")
    return out_dev


def phase_checks(lib: dict, out_dev: str, cpu: bool) -> None:
    out_cpu = os.path.join(WORK, "out_cpu")
    _, dt = cli_run(lib, lib["reads"], out_cpu, cpu=True)
    same_files(out_dev, out_cpu, OUT_FILES)
    log(f"check (a): device == XLA CPU, byte-identical {', '.join(OUT_FILES)}"
        f" (CPU run {dt:.1f}s)")
    s_dev = os.path.join(WORK, "slice_device")
    s_orc = os.path.join(WORK, "slice_oracle")
    cli_run(lib, lib["slice"], s_dev, cpu)
    cli_run(lib, lib["slice"], s_orc, cpu=True, backend="oracle")
    same_files(s_dev, s_orc, OUT_FILES[:2])
    n = sum(1 for _ in gzip.open(lib["slice"], "rt")) // 4
    log(f"check (b): {n}-read slice, device BED == oracle BED")
    prec, rec, n_truth = precision_recall(lib, out_dev)
    log(f"check (c): filtered calls precision {prec:.4f}, recall {rec:.4f} "
        f"vs {n_truth} planted circles with >= min_support reads")


def phase_gpu_tests(cpu: bool) -> None:
    # The gpu-marked tests live in tests/test_gpu.py. Naming the file
    # keeps collection away from modules that import `tests.<name>`,
    # which an installed top-level `tests` package would shadow.
    p = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                        "-p", "no:cacheprovider", "tests/test_gpu.py"],
                       env=child_env(cpu) if cpu
                       else child_env(False, JAX_PLATFORMS="cuda"),
                       capture_output=True, text=True,
                       timeout=900, cwd=ROOT)
    tail = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    if p.returncode != 0 or (not cpu and ("skipped" in tail
                                          or "passed" not in tail)):
        sys.stdout.write(p.stdout[-6000:] + p.stderr[-3000:])
        raise SystemExit(f"smoke: gpu-marked tests: {tail}")
    log(f"gpu tests: {tail}")


def phase_kernel(lib: dict, size: dict) -> None:
    import jax
    import numpy as np

    from find_circ2_tpu.config import RPAD_CODE, Config
    from find_circ2_tpu.index.build import load_index_dir
    from find_circ2_tpu.io.twobit import seq_to_codes
    from find_circ2_tpu.models.oracle import call_read
    from find_circ2_tpu.models.pipeline import (DeviceIndex,
                                                call_from_row,
                                                detect_batch_packed_fast,
                                                dispatch_packed,
                                                redo_if_overflow,
                                                revcomp_batch,
                                                unpack_results)
    from find_circ2_tpu.utils import device

    device.enable_compile_cache()
    cfg = Config()
    genome, index = load_index_dir(lib["index"])
    dindex = DeviceIndex.build(genome, index, cfg)
    assert dindex.ntable is not None, "index carries no neighbor table"
    B, Lp = cfg.batch_size, cfg.max_read_len
    recs = []
    with gzip.open(lib["reads"], "rt") as fh:
        while len(recs) < size["kernel_batches"] * B:
            head = fh.readline()
            if not head:
                break
            seq = fh.readline().strip()
            fh.readline()
            fh.readline()
            if 2 * cfg.anchor_len <= len(seq) <= Lp:
                recs.append((head[1:].strip(), seq))
    n_b = len(recs) // B
    assert n_b >= 1, "library too small for one kernel batch"
    arrs, lens = [], []
    for b in range(n_b):
        arr = np.full((B, Lp), RPAD_CODE, np.uint8)
        ln = np.zeros(B, np.int32)
        for i, (_, seq) in enumerate(recs[b * B:(b + 1) * B]):
            c = seq_to_codes(seq)
            arr[i, :c.size] = c
            ln[i] = c.size
        arrs.append(arr)
        lens.append(ln)
    t = time.time()
    packed = dispatch_packed(dindex, arrs[0], lens[0], cfg, True)
    jax.block_until_ready(packed)
    log(f"kernel: dispatch_packed compile + first batch {time.time() - t:.1f}s")
    t = time.time()
    outs = [dispatch_packed(dindex, a, ln, cfg, True)
            for a, ln in zip(arrs, lens)]
    jax.block_until_ready(outs)
    dt = time.time() - t
    rows = [redo_if_overflow(dindex, unpack_results(np.asarray(o)), a, ln,
                             cfg, True)
            for o, a, ln in zip(outs, arrs, lens)]
    log(f"kernel: {n_b} batches of {B} reads in {dt:.3f}s "
        f"({n_b * B / dt:,.0f} reads/s detect only, measured once)")
    # Rows the served path takes as they are: no §2b tie to explore
    # (multi bit 0) and no 2-mm rescue (bit 1). The oracle's call_read
    # runs both, so flagged rows differ from it by design; their final
    # calls are held to the oracle by checks (a) and (b).
    plain = np.flatnonzero(np.concatenate(
        [(r["multi"] & 3) == 0 for r in rows]))
    rng = np.random.default_rng(size["seed"])
    pick = np.sort(rng.choice(plain, size["kernel_sample"], replace=False))
    for k in pick:
        name, seq = recs[k]
        want = call_read(genome, index, name, seq, cfg, True)
        got = call_from_row(rows[k // B], k % B, name, seq)
        fields = ("status",) + (JUNCTION_FIELDS if want.status == 0
                                else ())
        if any(getattr(want, f) != getattr(got, f) for f in fields):
            raise SystemExit(f"smoke: detect row {k} ({name}) differs from "
                             f"the oracle:\n  oracle {want}\n  device {got}")
    log(f"kernel: {pick.size} sampled rows (of {plain.size} unflagged) == "
        f"oracle call_read")
    compiled = detect_batch_packed_fast.lower(
        dindex.gpacked, dindex.nbases, dindex.table, dindex.ntable,
        dindex.meta, dindex.chrom_offsets, arrs[0], lens[0], cfg, True,
        rc=revcomp_batch(arrs[0], lens[0])).compile()
    log(f"kernel: memory_analysis {compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"kernel: peak_bytes_in_use {stats.get('peak_bytes_in_use')} of "
        f"bytes_limit {stats.get('bytes_limit')}")


def four_cards(lib: dict, cpu: bool) -> None:
    """--mesh 2x2 and --nproc 4 (one card per process) against the
    one-card run: BED and stats byte-identical."""
    fc = CLI + ["find_circ", lib["reads"], "--reads-format", "fastq",
                "-x", lib["index"], "-n", "smoke"]

    def out(tag):
        return ["-o", os.path.join(WORK, f"{tag}.bed"),
                "-s", os.path.join(WORK, f"{tag}.stats")]

    plat = ["--platform", "cpu"] if cpu else []
    one_env = child_env(cpu, CUDA_VISIBLE_DEVICES="0") if not cpu \
        else child_env(cpu)
    _, dt = run_child(fc + out("one") + plat, one_env, "one-card run")
    log(f"four cards: one-card run {dt:.1f}s")
    mesh_env = child_env(cpu, XLA_FLAGS=(
        "--xla_force_host_platform_device_count=4")) if cpu \
        else child_env(cpu)
    _, dt = run_child(fc + out("mesh") + plat + ["--mesh", "2x2"], mesh_env,
                      "--mesh 2x2 run")
    log(f"four cards: --mesh 2x2 run {dt:.1f}s")
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    t = time.time()
    procs = [subprocess.Popen(
        fc + out("nproc") + plat + ["--nproc", "4", "--proc-id", str(i),
                                    "--coordinator", f"localhost:{port}"],
        env=child_env(cpu), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(4)]
    logs = [p.communicate(timeout=900)[0] for p in procs]
    if any(p.returncode != 0 for p in procs):
        for i, text in enumerate(logs):
            sys.stdout.write(f"--- rank {i}\n{text[-3000:]}\n")
        raise SystemExit("smoke: --nproc 4 run failed")
    log(f"four cards: --nproc 4 run {time.time() - t:.1f}s")
    for tag in ("mesh", "nproc"):
        for ext in ("bed", "stats"):
            a = os.path.join(WORK, f"one.{ext}")
            b = os.path.join(WORK, f"{tag}.{ext}")
            if open(a, "rb").read() != open(b, "rb").read():
                raise SystemExit(f"smoke: {tag}.{ext} differs from one.{ext}")
    n = sum(1 for _ in open(os.path.join(WORK, "one.bed")))
    log(f"four cards: --mesh 2x2, --nproc 4 and one-card BED + stats "
        f"byte-identical ({n} BED lines)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths and the one-card "
                    "run they are compared with")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny sizes on the XLA CPU backend, to check the "
                    "script's control flow; prints no contract line")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import find_circ2_tpu  # noqa: F401  (fails outside the checkout)
    from find_circ2_tpu import native
    cpu = args.cpu_rehearsal
    size = TINY if cpu else FULL
    os.makedirs(WORK, exist_ok=True)

    want = 4 if args.four_cards else 1
    phase_device(cpu, want)
    if not native.available():
        raise SystemExit("smoke: the native FASTQ loader did not build")
    label = card_label(cpu)
    lib = make_library(size)
    build_index(lib, cpu)
    if args.four_cards:
        four_cards(lib, cpu)
    else:
        out_dev = phase_main(lib, cpu, label)
        phase_checks(lib, out_dev, cpu)
        phase_gpu_tests(cpu)
        if cpu:
            import jax
            jax.config.update("jax_platforms", "cpu")
        phase_kernel(lib, size)
    import jax
    if cpu:
        jax.config.update("jax_platforms", "cpu")
    d = jax.devices()
    if cpu:
        log(f"rehearsal ok on {d[0].platform}; no contract line")
        return 0
    if d[0].platform != "gpu" or len(d) != want:
        raise SystemExit(f"smoke: expected {want} GPU(s), JAX reports "
                         f"{len(d)} x {d[0].platform}")
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
