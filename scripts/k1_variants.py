"""K1 experiment bench: candidate gather-shape and exact-first variants.

Measures on the card, against the current production formulation
(f_base = hash + two [2B, V]-shaped 32 B row gathers):

  base      production shape: per-probe jnp.take with [2B, V] indices
  flat      identical work, indices flattened to 1-D before the take
  onetake   both probes' indices concatenated -> ONE take of [2B, 2V]
  exact2    ONLY the exact variant's rows (2 probes x 1 variant) — the
            gather floor of the r5 'exact-first' K1 idea: anchors whose
            exact 20-mer resolves (typical case) would pay 2 rows
            instead of 122, with enumeration fallback routed like the
            §2b explore path.

Usage: python scripts/k1_variants.py [--genome-mb 64] [--reads 65536]
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
    from find_circ2_tpu.index.hashtable import mix_hash
    from find_circ2_tpu.models.pipeline import DeviceIndex
    from find_circ2_tpu.ops.anchor_align import (enumerate_variants,
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

    def keys(reads, lens, cfg):
        aa, ab = read_anchors(reads, lens, cfg)
        both = jnp.concatenate([aa, ab], axis=0)
        p12, s8, p12r, s8r, _ = enumerate_variants(both, cfg)
        swap = (p12r < p12) | ((p12r == p12) & (s8r < s8))
        cp = jnp.where(swap, p12r, p12).astype(jnp.uint32)
        cs = jnp.where(swap, s8r, s8).astype(jnp.uint32)
        return cp, cs

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def f_base(table, meta, reads, lens, cfg):
        cp, cs = keys(reads, lens, cfg)
        nb = meta[2].astype(jnp.uint32)
        acc = None
        for saltix in (0, 1):
            salt = meta[saltix].astype(jnp.uint32)
            h = (mix_hash(cp, cs, salt) % nb).astype(jnp.int32)
            g = jnp.take(table, h, axis=0)
            s = g[..., 0] + g[..., 3]
            acc = s if acc is None else acc + s
        return acc.sum(axis=-1)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def f_flat(table, meta, reads, lens, cfg):
        cp, cs = keys(reads, lens, cfg)
        nb = meta[2].astype(jnp.uint32)
        acc = None
        for saltix in (0, 1):
            salt = meta[saltix].astype(jnp.uint32)
            h = (mix_hash(cp, cs, salt) % nb).astype(jnp.int32)
            g = jnp.take(table, h.reshape(-1), axis=0)
            g = g.reshape(*h.shape, -1)
            s = g[..., 0] + g[..., 3]
            acc = s if acc is None else acc + s
        return acc.sum(axis=-1)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def f_onetake(table, meta, reads, lens, cfg):
        cp, cs = keys(reads, lens, cfg)
        nb = meta[2].astype(jnp.uint32)
        h0 = (mix_hash(cp, cs, meta[0].astype(jnp.uint32))
              % nb).astype(jnp.int32)
        h1 = (mix_hash(cp, cs, meta[1].astype(jnp.uint32))
              % nb).astype(jnp.int32)
        h = jnp.concatenate([h0, h1], axis=-1)
        g = jnp.take(table, h, axis=0)
        return (g[..., 0] + g[..., 3]).sum(axis=-1)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def f_exact2(table, meta, reads, lens, cfg):
        cp, cs = keys(reads, lens, cfg)
        cp = cp[:, :1]
        cs = cs[:, :1]
        nb = meta[2].astype(jnp.uint32)
        h0 = (mix_hash(cp, cs, meta[0].astype(jnp.uint32))
              % nb).astype(jnp.int32)
        h1 = (mix_hash(cp, cs, meta[1].astype(jnp.uint32))
              % nb).astype(jnp.int32)
        h = jnp.concatenate([h0, h1], axis=-1)
        g = jnp.take(table, h, axis=0)
        return (g[..., 0] + g[..., 3]).sum(axis=-1)

    def bar(x):
        np.asarray(jax.tree_util.tree_leaves(x)[0][:1])

    variants = {
        "base": f_base,
        "flat": f_flat,
        "onetake": f_onetake,
        "exact2": f_exact2,
    }
    out = {}
    for name, fn in variants.items():
        step = lambda rb, lb: fn(dindex.table, dindex.meta, rb, lb, cfg)
        bar(step(reads_d[0], lens_d[0]))
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
    print(json.dumps(out))


if __name__ == "__main__":
    main()
