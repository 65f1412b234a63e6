"""CLI end-to-end tests: the reference's pipeline recipes (SURVEY.md §3.1)
exercised through our command surface, including the two-stage
unmapped2anchors -> find_circ flow and the post-processing utilities."""

import numpy as np

from find_circ2_tpu.cli import main as cli_main
from find_circ2_tpu.config import Config
from find_circ2_tpu.io.bed import read_bed
from find_circ2_tpu.io.fasta import write_fasta
from find_circ2_tpu.io.fastq import FastqRecord, write_fastq
from find_circ2_tpu.io.twobit import codes_to_seq
from find_circ2_tpu.utils.simulate import simulate

CFG = Config(batch_size=256)


def _write_inputs(tmp_path, sim):
    fa = tmp_path / "genome.fa"
    write_fasta(fa, [(n, codes_to_seq(
        sim.genome.codes[sim.genome.chrom_offsets[i]:
                         sim.genome.chrom_offsets[i]
                         + sim.genome.chrom_lengths[i]]))
        for i, n in enumerate(sim.genome.chrom_names)])
    fq = tmp_path / "reads.fastq"
    with open(fq, "wt") as fh:
        for name, seq in sim.reads:
            write_fastq(fh, FastqRecord(name, seq, "I" * len(seq)))
    return fa, fq


def test_full_pipeline_run_and_utilities(tmp_path):
    sim = simulate(seed=21, n_circ=4, n_linear=2, reads_per_junction=3,
                   n_contiguous=6, n_random=4)
    fa, fq = _write_inputs(tmp_path, sim)
    outdir = tmp_path / "out"

    # Orchestrated run (oracle backend keeps the test fast on CPU).
    rc = cli_main.main(["run", str(fq), "-G", str(fa), "-o", str(outdir),
                        "-n", "tissueX", "--backend", "oracle", "--filter"])
    assert rc == 0
    rows = list(read_bed(outdir / "splice_sites.bed"))
    assert rows, "no junctions called"
    truth = {(t.chrom, t.start, t.end) for t in sim.truths
             if t.kind == "circular"}
    called_circ = {(r.chrom, r.start, r.end) for r in rows
                   if "CIRCULAR" in r.category}
    assert len(truth & called_circ) >= len(truth) - 1
    stats = (outdir / "stats.txt").read_text()
    assert "reads_total" in stats
    cand = list(read_bed(outdir / "circ_candidates.bed"))
    assert all("CIRCULAR" in r.category for r in cand)

    # Two-stage flow: unmapped2anchors | find_circ --reads-format anchors.
    anchors = tmp_path / "anchors.fastq"
    rc = cli_main.main(["unmapped2anchors", str(fq), "-o", str(anchors)])
    assert rc == 0
    two_stage = tmp_path / "two_stage.bed"
    rc = cli_main.main(["find_circ", str(anchors), "-G", str(fa),
                        "-o", str(two_stage), "-n", "tissueX",
                        "--backend", "oracle"])
    assert rc == 0
    assert [r.to_line() for r in read_bed(two_stage)] \
        == [r.to_line() for r in rows]

    # cmp_bed: identical tables concordant, perturbed tables not.
    assert cli_main.main(["cmp_bed", str(outdir / "splice_sites.bed"),
                          str(two_stage)]) == 0
    perturbed = tmp_path / "perturbed.bed"
    import dataclasses
    rows2 = [dataclasses.replace(r) for r in rows]
    rows2[0].start += 1
    from find_circ2_tpu.io.bed import write_bed
    write_bed(perturbed, rows2)
    assert cli_main.main(["cmp_bed", str(outdir / "splice_sites.bed"),
                          str(perturbed)]) == 1

    # merge_bed: merging a table with itself doubles support counts.
    merged = tmp_path / "merged.bed"
    assert cli_main.main(["merge_bed", str(two_stage), str(two_stage),
                          "-o", str(merged)]) == 0
    mrows = {r.key(): r for r in read_bed(merged)}
    for r in rows:
        m = mrows[r.key()]
        assert m.n_reads == 2 * r.n_reads
        assert m.tissues == "tissueX,tissueX"

    # maxlength: span filter drops wide junctions.
    clipped = tmp_path / "clipped.bed"
    span = sorted(r.end - r.start for r in rows)[len(rows) // 2]
    assert cli_main.main(["maxlength", str(two_stage), str(span),
                          "-o", str(clipped)]) == 0
    assert all(r.end - r.start <= span for r in read_bed(clipped))


def test_cli_unknown_command(capsys):
    assert cli_main.main(["bogus"]) == 2
    assert "unknown command" in capsys.readouterr().err


def test_index_build_and_reuse(tmp_path):
    sim = simulate(seed=71, n_circ=3, n_linear=1)
    fa, fq = _write_inputs(tmp_path, sim)
    idx_path = tmp_path / "g.idx.npz"
    assert cli_main.main(["index", str(fa), "-o", str(idx_path)]) == 0
    direct = tmp_path / "direct.bed"
    viaidx = tmp_path / "viaidx.bed"
    base = ["find_circ", str(fq), "--reads-format", "fastq",
            "--backend", "oracle", "-n", "s"]
    assert cli_main.main(base + ["-G", str(fa), "-o", str(direct)]) == 0
    assert cli_main.main(base + ["-x", str(idx_path),
                                 "-o", str(viaidx)]) == 0
    assert direct.read_text() == viaidx.read_text()
    # Missing both -G and -x errors out.
    import pytest
    with pytest.raises(SystemExit):
        cli_main.main(["find_circ", str(fq), "-o", "/dev/null"])


def test_filter_stack(tmp_path):
    """BASELINE configs[2]: full filter stack — uniqueness, edit distance,
    breakpoint ambiguity, support counts — on an enriched (circRNA-heavy,
    RNase-R-like) simulated library."""
    sim = simulate(seed=91, n_circ=10, n_linear=2, reads_per_junction=5,
                   n_contiguous=4, n_random=2, err_rate=0.5)
    fa, fq = _write_inputs(tmp_path, sim)
    out = tmp_path / "all.bed"
    assert cli_main.main(["find_circ", str(fq), "-G", str(fa),
                          "--reads-format", "fastq", "--backend", "oracle",
                          "-o", str(out), "-n", "rr"]) == 0
    rows = list(read_bed(out))
    filtered = tmp_path / "filt.bed"
    assert cli_main.main(["find_circ", str(fq), "-G", str(fa),
                          "--reads-format", "fastq", "--backend", "oracle",
                          "-o", str(filtered), "-n", "rr", "--filter",
                          "--min-support", "3", "--max-edits", "1"]) == 0
    frows = list(read_bed(filtered))
    from find_circ2_tpu.io.bed import passes_filter
    want = [r for r in rows if passes_filter(r, 100_000, 3, 1)]
    assert [r.key() for r in frows] == [r.key() for r in want]
    assert frows, "filter should retain well-supported circular junctions"
    for r in frows:
        assert r.n_reads >= 3 and r.edits <= 1
        assert "CIRCULAR" in r.category and "UNAMBIGUOUS_BP" in r.category


def test_rnase_r_library_filter_stack():
    """BASELINE configs[2] shape: an RNase-R-enriched simulated library run
    through the full pipeline + frozen filter stack recovers the planted,
    well-supported circles with high precision."""
    from find_circ2_tpu.index.build import build_index
    from find_circ2_tpu.io.bed import passes_filter
    from find_circ2_tpu.models.aggregate import Aggregator
    from find_circ2_tpu.models.oracle import call_read
    from find_circ2_tpu.utils.simulate import rnase_r_library

    cfg = CFG
    # repeat_frac kept mild here: junctions planted inside repeat arrays
    # are *legitimately* ambiguous (breakpoints > 1) and the frozen stack
    # drops them by design; the bench reports that honestly, the test
    # wants mostly-unique flanks so recall is a meaningful assertion.
    sim = rnase_r_library(seed=11, chrom_lengths={"chrR": 400_000},
                          n_circ=12, n_linear=3, depth_mean=6.0,
                          repeat_frac=0.08, cfg=cfg)
    index = build_index(sim.genome, cfg)
    agg = Aggregator(sim.genome, cfg)
    for name, seq in sim.reads:
        agg.add(call_read(sim.genome, index, name, seq, cfg))
    rows = agg.rows(sample_name="rr")
    filt = [r for r in rows if passes_filter(r, cfg.max_span,
                                             cfg.min_support,
                                             cfg.filter_max_edits)]
    truth = {(t.chrom, t.start, t.end) for t in sim.truths
             if t.kind == "circular" and len(t.reads) >= cfg.min_support}
    called = {(r.chrom, r.start, r.end) for r in filt}
    assert truth, "simulation must plant well-supported circles"
    tp = len(truth & called)
    assert tp / len(truth) >= 0.75, f"recall too low: {tp}/{len(truth)}"
    # Every filtered call not in truth must at least be a real junction
    # signature (false calls can arise from repeat-mediated ambiguity,
    # but the stack should keep them rare on this library).
    assert tp / max(1, len(called)) >= 0.8, (truth, called)


def test_merge_bed_recomputes_category_from_evidence():
    """Merged flags must come from models.aggregate.category_flags applied
    to the MERGED evidence — e.g. one run's ambiguous/non-unique junction
    becomes UNAMBIGUOUS_BP + ANCHOR_UNIQUE once another run contributes a
    unique unambiguous read."""
    from find_circ2_tpu.cli.merge_bed import merge_rows
    from find_circ2_tpu.io.bed import JunctionRow

    def row(uniq_bridges, breakpoints, category):
        return JunctionRow(
            chrom="chr1", start=100, end=900, name="x", n_reads=1,
            strand="+", n_uniq=1, uniq_bridges=uniq_bridges,
            best_qual_left=0, best_qual_right=0, tissues="t",
            tiss_counts="1", edits=1, anchor_overlap=0,
            breakpoints=breakpoints, signal="GTAG", strandmatch="NA",
            category=category)

    weak = row(0, 2, "CIRCULAR,NO_UNIQ_BRIDGES,CANONICAL")
    strong = row(1, 1, "CIRCULAR,UNAMBIGUOUS_BP,ANCHOR_UNIQUE,CANONICAL")
    (m,) = merge_rows([[weak], [strong]])
    assert m.category == "CIRCULAR,UNAMBIGUOUS_BP,ANCHOR_UNIQUE,CANONICAL"
    assert m.uniq_bridges == 1 and m.breakpoints == 1 and m.n_reads == 2


def test_merge_bed_equals_joint_run(tmp_path):
    """Splitting a library in two, running each half, and merge_bed-ing the
    BEDs must agree with one joint run on every evidence field that merges
    exactly (all but n_uniq/tissues/tiss_counts, which are per-run)."""
    sim = simulate(seed=97, n_circ=4, n_linear=2, reads_per_junction=4,
                   n_contiguous=4, n_random=2)
    fa, fq = _write_inputs(tmp_path, sim)
    lines = fq.read_text().splitlines(keepends=True)
    recs = ["".join(lines[i:i + 4]) for i in range(0, len(lines), 4)]
    h1, h2 = tmp_path / "h1.fastq", tmp_path / "h2.fastq"
    h1.write_text("".join(recs[::2]))
    h2.write_text("".join(recs[1::2]))
    base = ["find_circ", "--reads-format", "fastq", "--backend", "oracle",
            "-G", str(fa)]
    b1, b2, joint = (tmp_path / f"{n}.bed" for n in ("b1", "b2", "joint"))
    assert cli_main.main(base + [str(h1), "-o", str(b1), "-n", "s1"]) == 0
    assert cli_main.main(base + [str(h2), "-o", str(b2), "-n", "s2"]) == 0
    assert cli_main.main(base + [str(fq), "-o", str(joint),
                                 "-n", "sj"]) == 0
    merged_tbl = tmp_path / "merged.bed"
    assert cli_main.main(["merge_bed", str(b1), str(b2),
                          "-o", str(merged_tbl)]) == 0
    jrows = {r.key(): r for r in read_bed(joint)}
    mrows = {r.key(): r for r in read_bed(merged_tbl)}
    assert jrows.keys() == mrows.keys()
    for k, j in jrows.items():
        m = mrows[k]
        for f in ("n_reads", "uniq_bridges", "best_qual_left",
                  "best_qual_right", "edits", "anchor_overlap",
                  "breakpoints", "signal", "strandmatch", "category",
                  "name"):
            assert getattr(m, f) == getattr(j, f), (k, f)


def test_multiple_input_files(tmp_path):
    """Paired-end style: R1 + R2 processed as one stream."""
    sim = simulate(seed=95, n_circ=3, n_linear=1, reads_per_junction=4)
    fa, fq = _write_inputs(tmp_path, sim)
    # Split reads across two files.
    lines = fq.read_text().splitlines(keepends=True)
    recs = ["".join(lines[i:i + 4]) for i in range(0, len(lines), 4)]
    r1, r2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
    r1.write_text("".join(recs[::2]))
    r2.write_text("".join(recs[1::2]))
    single = tmp_path / "single.bed"
    paired = tmp_path / "paired.bed"
    base = ["find_circ", "--reads-format", "fastq", "--backend", "oracle",
            "-G", str(fa), "-n", "s"]
    assert cli_main.main(base[:1] + [str(fq)] + base[1:]
                         + ["-o", str(single)]) == 0
    assert cli_main.main(base[:1] + [str(r1), str(r2)] + base[1:]
                         + ["-o", str(paired)]) == 0
    assert single.read_text() == paired.read_text()


def test_index_dir_matches_genome_build(tmp_path):
    """`find_circ2 index -o DIR` stores the query table, §2b extras and
    neighbor table; a device run on `-x DIR` is byte-identical to one
    that builds everything from `-G`."""
    import os
    sim = simulate(seed=73, n_circ=4, n_linear=2, reads_per_junction=3,
                   n_contiguous=6, n_random=4, err_rate=0.3)
    fa, fq = _write_inputs(tmp_path, sim)
    idx_dir = tmp_path / "g.idx"
    assert cli_main.main(["index", str(fa), "-o", str(idx_dir)]) == 0
    for name in ("qtable", "qext", "qext_id", "qnbr"):
        assert os.path.exists(idx_dir / f"{name}.npy"), name
    for tag, src in (("built", ["-G", str(fa)]),
                     ("loaded", ["-x", str(idx_dir)])):
        assert cli_main.main(["run", str(fq), *src, "-o",
                              str(tmp_path / tag), "--filter"]) == 0
    for name in ("splice_sites.bed", "circ_candidates.bed", "stats.txt"):
        assert (tmp_path / "built" / name).read_bytes() == \
            (tmp_path / "loaded" / name).read_bytes()
    assert "circ_" in (tmp_path / "built" / "splice_sites.bed").read_text()
