"""Measure the card's random row-gather rate vs row width — the
number behind the roofline of K1's bucket-row gathers.

Times `jnp.take(table[T, L], idx[N], axis=0)` for L in --lanes over a
table far larger than the card's 50 MB L2 cache, as CHAIN dependent
applications chained inside one jitted program (each round's indices
derive from the previous round's rows, so rounds cannot overlap),
ended by block_until_ready.

Usage: python scripts/bench_gather_rate.py [--rows N] [--buckets T]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CHAIN = 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--buckets", type=int, default=31_000_000)
    ap.add_argument("--lanes", default="1,2,4,8,16,32")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from functools import partial

    if jax.default_backend() != "gpu":
        raise SystemExit("bench_gather_rate: needs a GPU")
    dev = jax.devices()[0]
    print(f"device={dev.device_kind}, rows={args.rows}, "
          f"buckets={args.buckets}, chain={CHAIN}", file=sys.stderr)

    rng = np.random.default_rng(0)
    idx = jnp.asarray(rng.integers(0, args.buckets, args.rows,
                                   dtype=np.int32))

    @partial(jax.jit, static_argnames=("reps",))
    def chained(table, idx, reps):
        # Each round derives the next indices from the gathered data, so
        # the rounds cannot overlap or be elided.
        acc = jnp.int32(0)
        T = table.shape[0]
        for _ in range(reps):
            g = jnp.take(table, idx, axis=0)
            acc = acc + g[0, 0]
            idx = (idx + (g[:, 0] & 1)) % T
        return acc, idx[:1]

    out = {}
    for L in (int(x) for x in args.lanes.split(",")):
        table = jnp.asarray(
            rng.integers(0, 2 ** 31, (args.buckets, L), dtype=np.int32))
        jax.block_until_ready(chained(table, idx, CHAIN))  # compile+warm
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(chained(table, idx, CHAIN))
            best = min(best, time.perf_counter() - t0)
        ns_row = best / (CHAIN * args.rows) * 1e9
        rate = 1e9 / ns_row
        print(f"lanes={L:3d} ({4 * L:4d} B/row): {ns_row:6.2f} ns/row "
              f"({rate / 1e6:6.1f} M rows/s, "
              f"{rate * 4 * L / 1e9:6.2f} GB/s payload)", file=sys.stderr)
        out[L] = round(ns_row, 2)
        del table
    print(json.dumps({"metric": "gather_ns_per_row_by_lanes",
                      "value": out, "unit": "ns/row",
                      "device_kind": dev.device_kind}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
