"""Recall-ceiling study on the configs[2] filter-stack library.

Runs the production pipeline on the exact bench.py --filter-stack
library (seed=7, fs_scale=4), then classifies EVERY missed truth
junction mechanistically — no sampling — by what a 20 bp-anchor,
MAX_BUCKET-guarded seed design could ever do about it:

  uncallable_guarded      a true-locus anchor 20-mer occurs more than
                          MAX_BUCKET times genome-wide: the guard
                          destroys the evidence (bowtie2+MAPQ drops the
                          same reads as repeat-multimappers)
  uncallable_ambiguous    the true pair IS explorable, but another
                          placement scores equal-or-better edits: the
                          evidence is genuinely ambiguous at this
                          anchor length under ANY tie-break
  beyond_candidate_cap    the true locus exists at <=1 mm but fell off
                          the MAX_PAIR_HITS candidate cap: callable
                          with a larger K (the K=16 -> K=32 lever)
  error_limited           >=2 errors in an anchor beyond the 2-mm
                          rescue's reach: callable with a wider ball
  support_eroded          junction aggregated but < MIN_SUPPORT reads
                          survived: callable with more depth
  filtered_*              junction aggregated, another frozen filter
                          rejected it
  other_*                 residual statuses (diff_strand etc.)

The measured callable ceiling = 1 - (uncallable_guarded +
uncallable_ambiguous) / n_truth. Writes RECALL_CEILING_r05.json at the
repo root and prints a summary for docs/DESIGN.md.

Usage: python scripts/recall_ceiling.py [--fs-scale 4] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def pair_best_edits(G, codes, pA, pB, a):
    """Best split edit count of the (pA, pB) circular/linear pair —
    the §4 prefix-sum score, minimal reimplementation for the study."""
    l = codes.size
    endB = pB + a
    GA = np.asarray(G[pA:pA + l]).astype(np.int64)
    GB = np.asarray(G[endB - l:endB]).astype(np.int64)
    q = codes.astype(np.int64)
    neqA = (q != GA) | (q >= 4) | (GA >= 4)
    neqB = (q != GB) | (q >= 4) | (GB >= 4)
    prefA = np.concatenate([[0], np.cumsum(neqA)])
    prefB = np.concatenate([[0], np.cumsum(neqB)])
    k = np.arange(l + 1)
    score = prefA + (prefB[l] - prefB)
    valid = (k >= a) & (k <= l - a)
    return int(score[valid].min())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fs-scale", type=int, default=4)
    ap.add_argument("--out", default="RECALL_CEILING_r05.json")
    args = ap.parse_args()

    from bench import ntable_cached
    from find_circ2_tpu.config import (Config, ST_JUNCTION, ST_PREFILTERED,
                                       ST_UNALIGNED_A, ST_UNALIGNED_B,
                                       STATUS_NAMES)
    from find_circ2_tpu.index.build import build_index, kmer_values
    from find_circ2_tpu.index.hashtable import build_query_table
    from find_circ2_tpu.io.bed import passes_filter
    from find_circ2_tpu.models.aggregate import Aggregator
    from find_circ2_tpu.models.oracle import anchor_candidates, call_read
    from find_circ2_tpu.models.pipeline import DeviceIndex, run_reads
    from find_circ2_tpu.io.twobit import seq_to_codes
    from find_circ2_tpu.utils.simulate import rnase_r_library

    cfg = Config()
    t0 = time.time()
    sim = rnase_r_library(seed=7, chrom_lengths={"chrR": 16_000_000},
                          n_circ=1500 * args.fs_scale,
                          n_linear=200 * args.fs_scale, depth_mean=12.0,
                          cfg=cfg)
    index = build_index(sim.genome, cfg)
    index.qtable = build_query_table(index, cfg)
    index.qtable.ntable = ntable_cached(index, cfg,
                                        f"fs|{args.fs_scale}")
    dindex = DeviceIndex.build(sim.genome, index, cfg)
    print(f"setup {time.time() - t0:.1f}s: {len(sim.reads)} reads, "
          f"{len(sim.truths)} truths", file=sys.stderr)

    t0 = time.time()
    agg = Aggregator(sim.genome, cfg)
    for call in run_reads(dindex, sim.reads, cfg, prefilter=True,
                          slowpath=(sim.genome, index)):
        agg.add(call)
    rows = agg.rows(sample_name="rnaser")
    filt = [r for r in rows if passes_filter(r, cfg.max_span,
                                             cfg.min_support,
                                             cfg.filter_max_edits)]
    print(f"pipeline {time.time() - t0:.1f}s", file=sys.stderr)

    truth = {(t.chrom, t.start, t.end) for t in sim.truths
             if t.kind == "circular" and len(t.reads) >= cfg.min_support}
    called = {(r.chrom, r.start, r.end) for r in filt}
    truth_by_key = {(t.chrom, t.start, t.end): t for t in sim.truths
                    if t.kind == "circular"}
    rows_by_key = {(r.chrom, r.start, r.end): r for r in rows}
    missed = sorted(truth - called)
    recall = len(truth & called) / len(truth)
    print(f"recall {recall:.4f} ({len(missed)} missed of {len(truth)})",
          file=sys.stderr)

    seq_by_name = dict(sim.reads)
    a = cfg.anchor_len
    G = sim.genome.codes
    pk = cfg.prefix_len

    def window_count(gpos: int) -> int:
        codes = np.asarray(G[gpos:gpos + a])
        if (codes >= 4).any():
            return 0
        kk, ok = kmer_values(codes, pk)
        ss, ok2 = kmer_values(codes[pk:], a - pk)
        if not (ok[0] and ok2[0]):
            return 0
        return index.lookup(int(kk[0]), int(ss[0])).size

    t0 = time.time()
    classes = Counter()
    per_truth = []
    for key in missed:
        row = rows_by_key.get(key)
        if row is not None:
            flags = set(row.category.split(","))
            if row.n_reads < cfg.min_support:
                cls = "support_eroded"
            elif "ANCHOR_UNIQUE" not in flags \
                    and "CANONICAL" not in flags:
                cls = "filtered_no_unique_anchor"
            elif "UNAMBIGUOUS_BP" not in flags:
                cls = "filtered_ambiguous_bp"
            elif row.edits > cfg.filter_max_edits:
                cls = "filtered_edits"
            else:
                cls = "filtered_other"
            classes[cls] += 1
            per_truth.append({"key": list(key), "class": cls,
                              "n_reads": row.n_reads})
            continue
        tj = truth_by_key[key]
        off = int(sim.genome.chrom_offsets[
            sim.genome.chrom_names.index(key[0])])
        ts, te = key[1] + off, key[2] + off
        read_cls = Counter()
        for rn in tj.reads:
            seq = seq_by_name[rn]
            L = len(seq)
            call = call_read(sim.genome, index, rn, seq, cfg)
            if call.status == ST_JUNCTION \
                    and (call.start, call.end) == (ts, te):
                read_cls["found_read"] += 1
                continue
            # True-locus anchor windows for SOME split at <=1mm — the
            # library emits reads on BOTH strands, so scan the read in
            # both orientations and keep the matching one.
            from find_circ2_tpu.io.twobit import REVCOMP_LUT
            fwd = seq_to_codes(seq)
            true_pa = true_pb = None
            codes = fwd
            for cand in (fwd, REVCOMP_LUT[fwd[::-1]]):
                for bp in range(a, L - a + 1):
                    pA = te - bp
                    pB = ts + (L - bp) - a
                    mmA = int(np.sum((cand[:a] != G[pA:pA + a])
                                     | (np.asarray(G[pA:pA + a]) >= 4)))
                    mmB = int(np.sum((cand[-a:] != G[pB:pB + a])
                                     | (np.asarray(G[pB:pB + a]) >= 4)))
                    if mmA <= 1 and mmB <= 1:
                        true_pa, true_pb = pA, pB
                        codes = cand
                        break
                if true_pa is not None:
                    break
            if true_pa is None:
                # No split in EITHER orientation puts both anchors
                # within 1 mm of the planted locus: >= 2 errors in an
                # anchor window (the library plants at most one error
                # per read, so this is rare and mostly error-in-anchor
                # + planted-locus divergence combinations).
                read_cls["error_limited"] += 1
                continue
            ca = window_count(true_pa)
            cb = window_count(true_pb)
            if ca > cfg.max_bucket or cb > cfg.max_bucket:
                read_cls["uncallable_guarded"] += 1
                continue
            hitA, candsA = anchor_candidates(sim.genome, index,
                                             codes[:a], cfg)
            hitB, candsB = anchor_candidates(sim.genome, index,
                                             codes[-a:], cfg)
            inA = any(p == true_pa for _, p in candsA)
            inB = any(p == true_pb for _, p in candsB)
            if not (inA and inB):
                read_cls["beyond_candidate_cap"] += 1
                continue
            # Planted circular geometry: pA = te - bp (left piece
            # start), pB = ts + (L - bp) - a; §4 scores (pA, pB).
            true_ed = pair_best_edits(G, codes, true_pa, true_pb, a)
            if call.status == ST_JUNCTION:
                if call.edits <= true_ed:
                    read_cls["uncallable_ambiguous"] += 1
                else:
                    read_cls["relocated_worse_alt"] += 1
            elif call.status == ST_PREFILTERED:
                read_cls["prefiltered"] += 1
            elif call.status in (ST_UNALIGNED_A, ST_UNALIGNED_B):
                read_cls["error_limited"] += 1
            else:
                read_cls[f"other_{STATUS_NAMES[call.status]}"] += 1
        why, _ = read_cls.most_common(1)[0]
        classes[f"{why}"] += 1
        per_truth.append({"key": list(key), "class": why,
                          "reads": dict(read_cls)})
    print(f"attribution {time.time() - t0:.1f}s", file=sys.stderr)

    n_truth = len(truth)
    uncallable = classes.get("uncallable_guarded", 0) \
        + classes.get("uncallable_ambiguous", 0)
    ceiling = 1 - uncallable / n_truth
    out = {
        "library": {"seed": 7, "fs_scale": args.fs_scale,
                    "n_reads": len(sim.reads), "n_truth": n_truth},
        "recall": round(recall, 4),
        "n_missed": len(missed),
        "classes": dict(classes),
        "uncallable": uncallable,
        "measured_callable_ceiling": round(ceiling, 4),
        "levers": {
            "beyond_candidate_cap (larger MAX_PAIR_HITS)":
                classes.get("beyond_candidate_cap", 0),
            "error_limited (wider rescue ball)":
                classes.get("error_limited", 0),
            "support_eroded (library depth)":
                classes.get("support_eroded", 0),
        },
        "config": {"max_bucket": cfg.max_bucket,
                   "max_pair_hits": cfg.max_pair_hits,
                   "anchor_len": cfg.anchor_len,
                   "min_support": cfg.min_support},
    }
    print(json.dumps(out))
    if args.out != "-":
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), args.out)
        with open(path, "w") as f:
            json.dump({**out, "per_truth": per_truth}, f, indent=1)
        print(f"wrote {path}", file=sys.stderr)


if __name__ == "__main__":
    main()
