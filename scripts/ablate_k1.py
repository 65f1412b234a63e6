"""Ablation of the detect step: where does the per-read time go?

Times progressively smaller slices of the program on the card, to set
the detect step's time beside the gather rate measured by
scripts/bench_gather_rate.py:

  full        detect_batch_phased (headline program pair)
  align       K1 phase only (enumerate + hash + gather + finalize)
  cand        candidate_stats only (no finalize reductions)
  gather      hash + the two bucket-row gathers, summed raw (no
              key-compare/unpack arithmetic)
  enum        enumerate_variants + hashes only (no table access)
  core        detect_core given precomputed hits (prefilter + K2 + ...)

Usage: python scripts/ablate_k1.py [--genome-mb 64] [--reads 65536]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=64.0)
    ap.add_argument("--reads", type=int, default=65536)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--repeat-frac", type=float, default=0.45)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import make_bench_data
    from find_circ2_tpu.config import Config
    from find_circ2_tpu.index.build import build_index
    from find_circ2_tpu.index.hashtable import SLOTS, LANES, mix_hash
    from find_circ2_tpu.models.pipeline import (DeviceIndex, _align_phase,
                                                _core_phase,
                                                detect_batch_phased)
    from find_circ2_tpu.ops.anchor_align import (candidate_stats,
                                                 enumerate_variants,
                                                 read_anchors)

    cfg = Config(batch_size=args.batch)
    t0 = time.time()
    genome, reads, lens, _ = make_bench_data(
        args.reads, args.genome_mb, args.read_len, cfg,
        repeat_frac=args.repeat_frac)
    index = build_index(genome, cfg)
    dindex = DeviceIndex.build(genome, index, cfg)
    print(f"setup {time.time() - t0:.1f}s "
          f"(device={jax.devices()[0].device_kind})", file=sys.stderr)

    B = args.batch
    n_batches = args.reads // B
    reads_d = [jax.device_put(reads[i * B:(i + 1) * B])
               for i in range(n_batches)]
    lens_d = [jax.device_put(lens[i * B:(i + 1) * B])
              for i in range(n_batches)]

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def f_cand(table, meta, reads, lens, cfg):
        aa, ab = read_anchors(reads, lens, cfg)
        both = jnp.concatenate([aa, ab], axis=0)
        cnt, pos, _, _ = candidate_stats(table, meta, both, cfg)
        return cnt.sum(axis=1) + (pos & 1).sum(axis=1).astype(jnp.int32)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def f_gather(table, meta, reads, lens, cfg):
        # Hash + the two 32 B bucket-row gathers only; consume rows with
        # a cheap elementwise sum (no key compare / unpack / min chains).
        aa, ab = read_anchors(reads, lens, cfg)
        both = jnp.concatenate([aa, ab], axis=0)
        p12, s8, p12r, s8r, _ = enumerate_variants(both, cfg)
        swap = (p12r < p12) | ((p12r == p12) & (s8r < s8))
        cp = jnp.where(swap, p12r, p12).astype(jnp.uint32)
        cs = jnp.where(swap, s8r, s8).astype(jnp.uint32)
        nb = meta[2].astype(jnp.uint32)
        acc = None
        for saltix in (0, 1):
            salt = meta[saltix].astype(jnp.uint32)
            h = (mix_hash(cp, cs, salt) % nb).astype(jnp.int32)
            g = jnp.take(table, h, axis=0)          # [2B, V, SLOTS*LANES]
            s = g[..., 0] + g[..., 3]               # touch two lanes
            acc = s if acc is None else acc + s
        return acc.sum(axis=-1)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def f_enum(meta, reads, lens, cfg):
        # Enumeration + canonicalization + hashing, no table gather.
        aa, ab = read_anchors(reads, lens, cfg)
        both = jnp.concatenate([aa, ab], axis=0)
        p12, s8, p12r, s8r, _ = enumerate_variants(both, cfg)
        swap = (p12r < p12) | ((p12r == p12) & (s8r < s8))
        cp = jnp.where(swap, p12r, p12).astype(jnp.uint32)
        cs = jnp.where(swap, s8r, s8).astype(jnp.uint32)
        nb = meta[2].astype(jnp.uint32)
        h0 = mix_hash(cp, cs, meta[0].astype(jnp.uint32)) % nb
        h1 = mix_hash(cp, cs, meta[1].astype(jnp.uint32)) % nb
        return (h0 ^ h1).sum(axis=-1)

    def bar(x):
        np.asarray(jax.tree_util.tree_leaves(x)[0][:1])

    variants = {
        "full": lambda rb, lb: detect_batch_phased(dindex, rb, lb, cfg,
                                                   True),
        "align": lambda rb, lb: _align_phase(dindex.table, dindex.meta,
                                             rb, lb, cfg),
        "cand": lambda rb, lb: f_cand(dindex.table, dindex.meta, rb, lb,
                                      cfg),
        "gather": lambda rb, lb: f_gather(dindex.table, dindex.meta, rb,
                                          lb, cfg),
        "enum": lambda rb, lb: f_enum(dindex.meta, rb, lb, cfg),
    }
    # core: detect_core given precomputed hits.
    hits0 = [_align_phase(dindex.table, dindex.meta, rb, lb, cfg)
             for rb, lb in zip(reads_d, lens_d)]
    bar(hits0[-1][0].pos)

    out = {}
    for name, step in variants.items():
        bar(step(reads_d[0], lens_d[0]))            # compile+warm
        best = float("inf")
        for _ in range(args.epochs):
            t0 = time.time()
            o = None
            for rb, lb in zip(reads_d, lens_d):
                o = step(rb, lb)
            bar(o)
            best = min(best, time.time() - t0)
        rps = n_batches * B / best
        out[name] = round(rps)
        print(f"{name:8s} {best:.3f}s  {rps:,.0f} reads/s "
              f"({1e6 / rps:.2f} us/read)", file=sys.stderr)

    # core phase with hits precomputed.
    step = lambda i: _core_phase(dindex.gpacked, dindex.nbases,
                                 dindex.chrom_offsets, reads_d[i],
                                 lens_d[i], hits0[i][0], hits0[i][1],
                                 cfg, True)
    bar(step(0))
    best = float("inf")
    for _ in range(args.epochs):
        t0 = time.time()
        for i in range(n_batches):
            o = step(i)
        bar(o)
        best = min(best, time.time() - t0)
    rps = n_batches * B / best
    out["core"] = round(rps)
    print(f"{'core':8s} {best:.3f}s  {rps:,.0f} reads/s "
          f"({1e6 / rps:.2f} us/read)", file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
