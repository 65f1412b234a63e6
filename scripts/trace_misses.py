"""Trace missed truth junctions of the configs[2] filter-stack bench to
their mechanistic cause.

Runs the same RNase-R library as bench.py --filter-stack, attributes
EVERY miss (no sampling), then for a handful of 'relocated' junctions
prints a per-read trace: oracle call vs truth, both anchors' candidate
lists, whether the true-locus positions are present in the capped §2b
candidate lists, and the exact-20-mer multiplicity of the true anchor
windows. Usage: python scripts/trace_misses.py [--fs-scale N] [--trace K]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fs-scale", type=int, default=4)
    ap.add_argument("--trace", type=int, default=5)
    ap.add_argument("--classes", default="reads_relocated_junction")
    args = ap.parse_args()

    from bench import attribute_misses
    from find_circ2_tpu.config import Config
    from find_circ2_tpu.index.build import build_index
    from find_circ2_tpu.io.bed import passes_filter
    from find_circ2_tpu.models.aggregate import Aggregator
    from find_circ2_tpu.models.oracle import (anchor_candidates, call_read,
                                              ReadCall)
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
    from bench import ntable_cached
    from find_circ2_tpu.index.hashtable import build_query_table
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
    missed = truth - called
    print(f"recall {len(truth & called) / len(truth):.4f} "
          f"({len(missed)} missed)", file=sys.stderr)

    # Full-population attribution (sample_cap = everything).
    t0 = time.time()
    br = attribute_misses(missed, truth_by_key, rows_by_key, sim, index,
                          cfg, sample_cap=len(missed))
    print(f"attribution {time.time() - t0:.1f}s", file=sys.stderr)
    print(json.dumps({"full_miss_breakdown": br,
                      "n_truth": len(truth), "n_missed": len(missed)}))

    # Re-classify to locate junctions of the classes we want to trace.
    seq_by_name = dict(sim.reads)
    a = cfg.anchor_len
    G = sim.genome.codes
    want = set(args.classes.split(","))
    traced = 0
    for key in sorted(missed):
        if traced >= args.trace:
            break
        if key in rows_by_key:
            continue  # filtered class, not a per-read class
        tj = truth_by_key[key]
        calls = [(rn, call_read(sim.genome, index, rn, seq_by_name[rn],
                                cfg)) for rn in tj.reads]
        from collections import Counter
        cls = Counter("relocated_junction" if c.status == 0
                      else str(c.status) for _, c in calls)
        top = cls.most_common(1)[0][0]
        if f"reads_{top}" not in want:
            continue
        traced += 1
        print(f"\n=== missed truth {key} (span "
              f"{key[2] - key[1]}) dominant={top} ===")
        for rn, c in calls[:5]:
            seq = seq_by_name[rn]
            codes = seq_to_codes(seq)
            hitA, candsA = anchor_candidates(sim.genome, index,
                                             codes[:a], cfg)
            hitB, candsB = anchor_candidates(sim.genome, index,
                                             codes[-a:], cfg)
            # The true anchor positions: read = G[end-bp:end]+G[start:..]
            # -> anchor A true pos in {end-bp}, B ends at start+(L-bp).
            # Recover bp by scanning all splits for exact coords match.
            off = int(sim.genome.chrom_offsets[
                sim.genome.chrom_names.index(key[0])])
            ts, te = key[1] + off, key[2] + off
            L = len(seq)
            true_pa = true_pb = None
            for bp in range(a, L - a + 1):
                pA = te - bp           # anchor A start if split is bp
                pB = ts + (L - bp) - a  # anchor B start
                mmA = int(np.sum((codes[:a] != G[pA:pA + a])
                                 | (G[pA:pA + a] >= 4)))
                mmB = int(np.sum((codes[-a:] != G[pB:pB + a])
                                 | (G[pB:pB + a] >= 4)))
                if mmA <= 1 and mmB <= 1:
                    true_pa, true_pb = pA, pB
                    break
            inA = any(p == true_pa for _, p in candsA)
            inB = any(p == true_pb for _, p in candsB)
            print(f"  read {rn}: status={c.status} "
                  f"called=({c.start},{c.end}) edits={c.edits} "
                  f"truth=({ts},{te})")
            print(f"    anchorA: mm={hitA.mm} n_best={hitA.n_best} "
                  f"qual={hitA.qual} cands={candsA[:8]} "
                  f"true_pa={true_pa} in_cands={inA}")
            print(f"    anchorB: mm={hitB.mm} n_best={hitB.n_best} "
                  f"qual={hitB.qual} cands={candsB[:8]} "
                  f"true_pb={true_pb} in_cands={inB}")


if __name__ == "__main__":
    main()
