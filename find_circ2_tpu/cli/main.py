"""`find_circ2` — umbrella CLI: the reference's shell-pipeline orchestration
(SURVEY.md §1 L6, §3.1) as one command plus the individual tools as
subcommands.

    python -m find_circ2_tpu.cli.main run -G genome.fa reads.fastq -o out/
    python -m find_circ2_tpu.cli.main unmapped2anchors ...
    python -m find_circ2_tpu.cli.main find_circ ...
    python -m find_circ2_tpu.cli.main merge_bed ...
    python -m find_circ2_tpu.cli.main cmp_bed ...
    python -m find_circ2_tpu.cli.main maxlength ...

`run` replaces the reference's bowtie2|samtools|unmapped2anchors|bowtie2|
find_circ pipe chain: the integrated engine performs the contiguous
prefilter (pass 1), anchor alignment (pass 2) and breakpoint search in
one pass over the reads.
"""

from __future__ import annotations

import argparse
import os
import sys

from find_circ2_tpu.cli import (cmp_bed, find_circ, maxlength, merge_bed,
                                unmapped2anchors)


def run_cmd(argv) -> int:
    p = argparse.ArgumentParser(prog="find_circ2 run",
                                description="full pipeline in one command")
    p.add_argument("reads", help="FASTQ(.gz) of RNA-seq reads")
    p.add_argument("-G", "--genome", default=None)
    p.add_argument("-x", "--index", default=None,
                   help="prebuilt index from `find_circ2 index` (.npz "
                   "file or directory); alternative to -G")
    p.add_argument("-o", "--outdir", default="find_circ2_out")
    p.add_argument("-n", "--name", default="sample")
    p.add_argument("-p", "--prefix", default="")
    p.add_argument("--backend", choices=("device", "oracle"),
                   default="device")
    p.add_argument("--stranded", action="store_true")
    p.add_argument("--no-prefilter", action="store_true")
    p.add_argument("--filter", action="store_true",
                   help="also write circ_candidates.bed with the frozen "
                   "quality filters applied")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timings to stderr")
    args = p.parse_args(argv)
    if not args.genome and not args.index:
        p.error("one of -G/--genome or -x/--index is required")
    os.makedirs(args.outdir, exist_ok=True)
    bed = os.path.join(args.outdir, "splice_sites.bed")
    stats = os.path.join(args.outdir, "stats.txt")
    fc_args = [args.reads, "-o", bed, "-s", stats,
               "-n", args.name, "-p", args.prefix,
               "--reads-format", "fastq", "--backend", args.backend]
    if args.index:
        fc_args += ["-x", args.index]
    else:
        fc_args += ["-G", args.genome]
    if args.stranded:
        fc_args.append("--stranded")
    if args.no_prefilter:
        fc_args.append("--no-prefilter")
    if args.profile:
        fc_args.append("--profile")
    rc = find_circ.main(fc_args)
    if rc:
        return rc
    if args.filter:
        cand = os.path.join(args.outdir, "circ_candidates.bed")
        rc = _filter_existing(bed, cand)
    print(f"find_circ2: wrote {bed} and {stats}", file=sys.stderr)
    return rc


def _filter_existing(bed_path: str, out_path: str) -> int:
    from find_circ2_tpu.config import Config
    from find_circ2_tpu.io.bed import passes_filter, read_bed, write_bed
    cfg = Config()
    rows = [r for r in read_bed(bed_path)
            if passes_filter(r, cfg.max_span, cfg.min_support,
                             cfg.filter_max_edits)]
    write_bed(out_path, rows)
    return 0


def index_cmd(argv) -> int:
    p = argparse.ArgumentParser(prog="find_circ2 index",
                                description="build and save the genome "
                                "seed index (bowtie2-build analog)")
    p.add_argument("genome", help="genome FASTA(.gz)")
    p.add_argument("-o", "--output", required=True,
                   help="output path: NAME.npz writes one compressed "
                   "file; any other path a directory of raw .npy arrays "
                   "that also holds the multi-hit extras and the "
                   "exact-first neighbor table, so runs skip every "
                   "host-side table build")
    args = p.parse_args(argv)
    from find_circ2_tpu.config import Config
    from find_circ2_tpu.index.build import (build_index, save_index,
                                            save_index_dir)
    from find_circ2_tpu.io.genome import Genome
    cfg = Config()
    genome = Genome.from_fasta(args.genome, cfg)
    index = build_index(genome, cfg)
    # Precompute the device query table so runs loading this artifact
    # skip the cuckoo construction.
    from find_circ2_tpu.index.hashtable import (build_neighbor_table,
                                                build_query_table)
    index.qtable = build_query_table(index, cfg)
    if args.output.endswith(".npz"):
        save_index(args.output, genome, index)
    else:
        index.qtable.ntable = build_neighbor_table(index, cfg)
        save_index_dir(args.output, genome, index)
    print(f"find_circ2 index: {len(genome)} bases, "
          f"{index.positions.size} windows -> {args.output}",
          file=sys.stderr)
    return 0


COMMANDS = {
    "run": run_cmd,
    "index": index_cmd,
    "unmapped2anchors": unmapped2anchors.main,
    "find_circ": find_circ.main,
    "merge_bed": merge_bed.main,
    "cmp_bed": cmp_bed.main,
    "maxlength": maxlength.main,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: find_circ2 <command> [...]\ncommands: "
              + ", ".join(COMMANDS), file=sys.stderr)
        return 0 if argv else 2
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; commands: {', '.join(COMMANDS)}",
              file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
