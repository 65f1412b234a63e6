"""`find_circ` — the junction caller CLI (reference's find_circ.py,
SURVEY.md §2.1/§3.3).

Differences from the reference, by design: the external bowtie2 anchor
pass is integrated (the engine aligns anchors itself on the GPU), so the
input is either anchor FASTQ produced by `unmapped2anchors` (full reads
recovered from the name codec) or plain read FASTQ via --reads-format.
Flags mirror the reference where known: -G genome, -a anchor length,
-p prefix, -n name, -s stats, --stranded.
"""

from __future__ import annotations

import argparse
import os
import sys

from find_circ2_tpu.config import Config
from find_circ2_tpu.index.build import build_index, load_index
from find_circ2_tpu.io.bed import write_bed
from find_circ2_tpu.io.fastq import decode_anchor_name, read_fastq
from find_circ2_tpu.io.genome import Genome
from find_circ2_tpu.models.aggregate import Aggregator
from find_circ2_tpu.models.pipeline import DeviceIndex, run_reads
from find_circ2_tpu.models.oracle import call_read


def reads_from_anchor_fastq(path):
    """Recover unique original reads from anchor records (codec names)."""
    seen = set()
    for rec in read_fastq(path):
        name, seq, _qual, _side = decode_anchor_name(rec.name)
        if name in seen:
            continue
        seen.add(name)
        yield name, seq


def reads_from_fastq(path):
    for rec in read_fastq(path):
        yield rec.name, rec.seq


def reads_from_sam_file(path, pe: bool, fmt: str = "sam"):
    """Unmapped primary records from SAM text or binary BAM (SURVEY §3.1
    `samtools view -f 4` front end); with --pe, mate-2 reads are
    reverse-complemented to mate-1 orientation (SPEC.md §7) using the
    0x80 flag."""
    from find_circ2_tpu.io.twobit import revcomp_seq
    if fmt == "bam":
        from find_circ2_tpu.io.bam import reads_from_bam as reader
    else:
        from find_circ2_tpu.io.sam import reads_from_sam as reader
    for name, seq, _qual, mate2 in reader(path):
        yield name, revcomp_seq(seq) if pe and mate2 else seq


def rc_stream(it):
    """Reverse-complement every read of a (name, seq) stream."""
    from find_circ2_tpu.io.twobit import revcomp_seq
    for name, seq in it:
        yield name, revcomp_seq(seq)


def build_parser() -> argparse.ArgumentParser:
    d = Config()
    p = argparse.ArgumentParser(
        prog="find_circ", description="detect circRNA junctions")
    p.add_argument("input", nargs="+",
                   help="anchor FASTQ from unmapped2anchors, or plain "
                   "FASTQ with --reads-format fastq; several files "
                   "(e.g. paired-end mates R1 R2) are processed as one "
                   "stream")
    p.add_argument("-G", "--genome", default=None,
                   help="genome FASTA(.gz)")
    p.add_argument("-x", "--index", default=None,
                   help="prebuilt index from `find_circ2 index` (.npz "
                   "file or directory; replaces -G; bowtie2 -x analog)")
    p.add_argument("-o", "--output", default="-",
                   help="junction BED output (default stdout)")
    p.add_argument("-s", "--stats", default=None, help="stats file")
    p.add_argument("-p", "--prefix", default="",
                   help="prefix for junction names")
    p.add_argument("-n", "--name", default="unknown",
                   help="sample/tissue name for the tissues column")
    p.add_argument("-a", "--anchor", type=int, default=d.anchor_len)
    p.add_argument("--reads-format",
                   choices=("anchors", "fastq", "sam", "bam"),
                   default="anchors",
                   help="anchors: unmapped2anchors output; fastq: plain "
                   "reads; sam: SAM text (.gz ok); bam: binary BAM — "
                   "for sam/bam, unmapped primary records are taken, "
                   "the `samtools view -f 4` front end of the reference "
                   "pipeline")
    p.add_argument("--pe", action="store_true",
                   help="paired-end mate handling (SPEC.md §7): mate-2 "
                   "reads are reverse-complemented to mate-1 orientation "
                   "before detection, so --stranded strandmatch counts "
                   "both mates in protocol orientation. With fastq/"
                   "anchors input, files alternate R1 R2 R1 R2...; with "
                   "sam input, mate 2 comes from the 0x80 flag")
    p.add_argument("--stranded", action="store_true",
                   help="library is stranded: fill strandmatch column")
    p.add_argument("--no-prefilter", action="store_true",
                   help="input reads are already unmapped; skip the "
                   "contiguous-alignment prefilter")
    p.add_argument("--backend", choices=("device", "oracle"),
                   default="device",
                   help="device = JAX path on the GPU, oracle = numpy "
                   "reference")
    p.add_argument("--filter", action="store_true",
                   help="emit only junctions passing the frozen filter "
                   "stack: CIRCULAR & UNAMBIGUOUS_BP & ANCHOR_UNIQUE, "
                   ">= --min-support reads, <= --max-edits edits, "
                   "span <= --max-span (SPEC.md §5)")
    p.add_argument("--max-span", type=int, default=d.max_span)
    p.add_argument("--min-support", type=int, default=d.min_support)
    p.add_argument("--max-edits", type=int, default=d.filter_max_edits)
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--mesh", default=None, metavar="DATAxINDEX",
                   help="run the sharded engine over a DATAxINDEX mesh "
                   "of the host's cards (e.g. 2x2: data-parallel reads, "
                   "k-mer-range-sharded index); output is byte-identical "
                   "to the single-card path (BASELINE configs[3])")
    p.add_argument("--nproc", type=int, default=None,
                   help="multi-process run on one host: total number of "
                   "processes, one card each (rank i opens card i; more "
                   "processes than cards is refused). Each process "
                   "streams every --nproc'th batch, detects on its card, "
                   "and process 0 merges the junction tables; stats are "
                   "psum'd across processes (parallel.distributed"
                   ".allreduce_counts). Requires --proc-id and a real "
                   "-o path; output is byte-identical to a "
                   "single-process run")
    p.add_argument("--proc-id", type=int, default=None,
                   help="this process's rank in [0, --nproc)")
    p.add_argument("--coordinator", default="localhost:9377",
                   help="jax.distributed coordinator address "
                   "(host:port); process 0 hosts it")
    p.add_argument("--journal", default=None,
                   help="JSONL resume journal: completed batches replay "
                   "from disk on rerun")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto",
                   help="auto: the GPU (the device backend refuses to run "
                   "without one); cpu: the XLA CPU backend, on purpose "
                   "(same as JAX_PLATFORMS=cpu; virtual-device meshes via "
                   "XLA_FLAGS=--xla_force_host_platform_device_count=N)")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timings to stderr")
    return p


def run(args) -> int:
    import time

    import jax
    from find_circ2_tpu.utils import device
    t_start = time.time()
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    nproc = args.nproc or 1
    if nproc > 1:
        # Multi-process plumbing (SURVEY.md §7 step 6): jax.distributed
        # first, before any backend touch. Detection is per-process on
        # the process's own card, so processes never run in lockstep;
        # only the final stats psum and the file-based junction merge
        # synchronize.
        if args.proc_id is None or not 0 <= args.proc_id < nproc:
            raise SystemExit("--nproc requires --proc-id in [0, nproc)")
        if args.output == "-":
            raise SystemExit("--nproc requires -o FILE "
                             "(process 0 writes the merged table)")
        if args.mesh:
            raise SystemExit("--mesh shards within one process; combine "
                             "processes with --nproc OR cards with "
                             "--mesh, not both")
        # One card per process: JAX reserves most of a card's memory
        # when it opens it, so a second process on the card would fail.
        cards = None
        if args.backend == "device" and not device.cpu_requested():
            cards = [device.card_for_process(args.proc_id, nproc,
                                             device.visible_card_count())]
        from find_circ2_tpu.parallel.distributed import init_distributed
        init_distributed(args.coordinator, nproc, args.proc_id,
                         local_device_ids=cards)
    compiles = None
    if args.backend == "device":
        device.require_gpu()
        print(f"find_circ: {device.device_line()}", file=sys.stderr)
        device.enable_compile_cache()
        if args.profile:
            from find_circ2_tpu.utils.profiling import CompileStats
            compiles = CompileStats().listen()
    cfg = Config(anchor_len=args.anchor,
                 prefix_len=min(12, args.anchor - 8),
                 stranded=args.stranded, batch_size=args.batch_size)
    if args.index:
        if os.path.isdir(args.index):
            # Whole-genome raw-.npy artifact directory (mmap'd; see
            # index.build.load_index_dir) — the configs[4]/[5] shape.
            from find_circ2_tpu.index.build import load_index_dir
            genome, index = load_index_dir(args.index)
        else:
            genome, index = load_index(args.index)
        if index.anchor_len != cfg.anchor_len:
            raise SystemExit(f"index was built with -a {index.anchor_len}, "
                             f"run requested -a {cfg.anchor_len}")
    elif args.genome:
        genome = Genome.from_fasta(args.genome, cfg)
        index = build_index(genome, cfg)
    else:
        raise SystemExit("one of -G/--genome or -x/--index is required")
    import itertools
    if (args.pe and args.reads_format not in ("sam", "bam")
            and len(args.input) % 2):
        raise SystemExit("--pe expects an even number of input files "
                         "(R1 R2 pairs); SAM/BAM input carries mate "
                         "flags instead")

    def file_stream(fi: int, f: str):
        if args.reads_format in ("sam", "bam"):
            return reads_from_sam_file(f, args.pe, args.reads_format)
        reader = (reads_from_anchor_fastq if args.reads_format == "anchors"
                  else reads_from_fastq)
        it = reader(f)
        # --pe: odd-indexed files are mate-2 -> mate-1 orientation.
        return rc_stream(it) if args.pe and fi % 2 else it

    src = itertools.chain.from_iterable(
        file_stream(fi, f) for fi, f in enumerate(args.input))
    if nproc > 1:
        # Round-robin read sharding: deterministic, streaming, no
        # pre-scan; the junction merge is order-free so any disjoint
        # split yields the joint result.
        src = itertools.islice(src, args.proc_id, None, nproc)
    prefilter = not args.no_prefilter
    agg = Aggregator(genome, cfg)
    journal = times = None
    if args.journal:
        from find_circ2_tpu.utils.journal import RunJournal
        if nproc > 1:
            # Per-rank journal: batch ids are only meaningful within one
            # (nproc, proc_id) sharding, so each rank journals its own
            # file and the header pins the sharding — resume under a
            # different --nproc fails loudly instead of replaying
            # another rank's batches.
            journal = RunJournal(
                f"{args.journal}.r{args.proc_id}",
                meta={"nproc": nproc, "proc_id": args.proc_id})
        else:
            journal = RunJournal(args.journal)
    if args.profile:
        from find_circ2_tpu.utils.profiling import StageTimes
        times = StageTimes()
        t_stream = time.time()
        print(f"setup\t{t_stream - t_start:.3f}s\tgenome + host index "
              f"load/build", file=sys.stderr)
    if args.backend == "device" and args.mesh:
        # Sharded end-to-end run: same streaming loop + aggregation, the
        # device step swapped for the collective (data, index) engine.
        from find_circ2_tpu.parallel.mesh import make_mesh
        from find_circ2_tpu.parallel.sharded import ShardedEngine
        dshape = tuple(int(x) for x in args.mesh.lower().split("x"))
        if len(dshape) != 2:
            raise SystemExit("--mesh expects DATAxINDEX, e.g. 2x4")
        mesh = make_mesh(dshape[0] * dshape[1], dshape)
        eng = ShardedEngine(genome, index, mesh, cfg, prefilter)
        bs = -(-cfg.batch_size // eng.n_data) * eng.n_data
        from find_circ2_tpu import native
        if args.reads_format == "fastq" and native.available():
            # Sharded runs ride the same chunked native encode as the
            # single-card fast path — only the
            # device step is swapped for the collective engine.
            from find_circ2_tpu.models.stream import run_fastq
            for fi, f in enumerate(args.input):
                jr = journal
                if journal is not None and len(args.input) > 1:
                    from find_circ2_tpu.utils.journal import RunJournal
                    # Per-file journals keep the sharding-pinned meta
                    # header (as the device branch does): resuming under
                    # a different sharding must be rejected, not
                    # silently replayed.
                    jr = RunJournal(f"{journal.path}.{fi}",
                                    meta=journal.meta)
                run_fastq(None, f, agg, cfg, prefilter, batch_size=bs,
                          times=times, slowpath=(genome, index),
                          journal=jr, revcomp=bool(args.pe and fi % 2),
                          dispatch=eng.dispatch_packed,
                          redo=eng.redo_packed)
        else:
            for call in run_reads(None, src, cfg, prefilter,
                                  batch_size=bs, journal=journal,
                                  times=times, slowpath=(genome, index),
                                  dispatch=eng.dispatch_packed,
                                  redo=eng.redo_packed):
                agg.add(call)
    elif args.backend == "device":
        from find_circ2_tpu import native
        from find_circ2_tpu.models.stream import run_fastq
        import contextlib
        # Neighbor table (when the index lacks one) + device upload.
        with (times.stage("device_index") if times is not None
              else contextlib.nullcontext()):
            dindex = DeviceIndex.build(genome, index, cfg)
        slowpath = (genome, index)
        if args.reads_format == "fastq" and native.available():
            # Fast path: native C FASTQ scanning + batch encoding; gzip
            # and resume journals ride it too (multi-file runs use one
            # journal per input so batch ids stay per-file). Multi-proc
            # runs ride it as well: each process owns every --nproc'th
            # batch (run_fastq shard=), so multi-host throughput is not
            # host-parse-bound
            shard = (args.proc_id, nproc) if nproc > 1 else None
            for fi, f in enumerate(args.input):
                jr = journal
                if journal is not None and len(args.input) > 1:
                    from find_circ2_tpu.utils.journal import RunJournal
                    jr = RunJournal(f"{journal.path}.{fi}",
                                    meta=journal.meta)
                run_fastq(dindex, f, agg, cfg, prefilter, times=times,
                          slowpath=slowpath, journal=jr,
                          revcomp=bool(args.pe and fi % 2), shard=shard)
        else:
            if args.reads_format == "fastq":
                # Loud, not silent: the production fast path was
                # requested (fastq input) but the native loader did not
                # build — per-read Python parsing will bound throughput.
                print("find_circ: WARNING: native loader unavailable; "
                      "falling back to the per-read Python path",
                      file=sys.stderr)
            for call in run_reads(dindex, src, cfg, prefilter,
                                  journal=journal, times=times,
                                  slowpath=slowpath):
                agg.add(call)
    else:
        for name, seq in src:
            agg.add(call_read(genome, index, name, seq, cfg, prefilter))
    if times is not None:
        print(times.report(wall=time.time() - t_stream), file=sys.stderr)
        if compiles is not None:
            print(compiles.line(), file=sys.stderr)
    if nproc > 1:
        import pickle
        from find_circ2_tpu.models.aggregate import Stats
        from find_circ2_tpu.parallel.distributed import (allreduce_counts,
                                                         stats_to_vec)
        order = Stats.REDUCE_ORDER
        part = f"{args.output}.part{args.proc_id}"
        agg._drain_batches()     # buffered summaries -> junction dict
        with open(part, "wb") as fh:
            pickle.dump(agg.junctions, fh)
        # The psum doubles as the barrier: every process has written its
        # part file before any process returns from the collective.
        total = allreduce_counts(stats_to_vec(agg.stats, order))
        if args.proc_id != 0:
            return 0
        for i in range(1, nproc):
            pi = f"{args.output}.part{i}"
            with open(pi, "rb") as fh:
                agg.merge_from(pickle.load(fh))
            os.remove(pi)
        os.remove(part)
        # Replace only the reduced per-read counters; any other counter
        # (journal-replay extras, future additions) stays as-is.
        for k in order:
            agg.stats.counts.pop(k, None)
        agg.stats.counts.update(
            {k: int(v) for k, v in zip(order, total) if v})
    rows = agg.rows(sample_name=args.name, prefix=args.prefix)
    if args.filter:
        from find_circ2_tpu.io.bed import passes_filter
        rows = [r for r in rows
                if passes_filter(r, args.max_span, args.min_support,
                                 args.max_edits)]
    out = sys.stdout if args.output == "-" else open(args.output, "wt")
    try:
        write_bed(out, rows)
    finally:
        if out is not sys.stdout:
            out.close()
    if args.stats:
        with open(args.stats, "wt") as fh:
            fh.write("\n".join(agg.stats.lines()) + "\n")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
