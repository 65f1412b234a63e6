"""Time K2's prefix-sum formulations on the card: the triangular-ones
bf16 product that ops/breakpoint.prefix_sum_rows uses, against
jnp.cumsum, at the K2 shape [2 * batch, Lp] and the explore shape
[bucket * max_pair_hits, Lp]. Both are checked against np.cumsum first.
Prints one JSON line with the device and the best time of each.

Usage: python scripts/bench_prefix_sum.py [--reps N]
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from find_circ2_tpu.config import Config
    from find_circ2_tpu.models.pipeline import DeviceExplorer
    from find_circ2_tpu.ops.breakpoint import prefix_sum_rows
    from find_circ2_tpu.utils import device

    if jax.default_backend() != "gpu":
        raise SystemExit("bench_prefix_sum: needs a GPU")
    device.enable_compile_cache()
    cfg = Config()
    Lp = cfg.max_read_len
    shapes = {"k2": (2 * cfg.batch_size, Lp),
              "explore": (DeviceExplorer.BUCKETS[-1] * cfg.max_pair_hits,
                          Lp)}
    variants = {
        "tri_dot_bf16": jax.jit(prefix_sum_rows),
        "cumsum": jax.jit(lambda x: jnp.cumsum(x.astype(jnp.int32),
                                               axis=1)),
    }
    rng = np.random.default_rng(0)
    out = {"device_kind": jax.devices()[0].device_kind}
    for sname, shape in shapes.items():
        ind = jax.device_put(rng.random(shape) < 0.3)
        want = np.cumsum(np.asarray(ind), axis=1)
        for vname, fn in variants.items():
            np.testing.assert_array_equal(np.asarray(fn(ind)), want)
            best = float("inf")
            for _ in range(5):
                t = time.perf_counter()
                outs = [fn(ind) for _ in range(args.reps)]
                jax.block_until_ready(outs)
                best = min(best, (time.perf_counter() - t) / args.reps)
            out[f"{sname}_{vname}_us"] = round(best * 1e6, 2)
            print(f"{sname} {shape}: {vname} {best * 1e6:.2f} us",
                  file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
