"""Scaling-efficiency table over the (data, index) mesh (BASELINE
configs[3]/[4]).

Runs the sharded engine across every (data x index) shape of a mesh
and reports reads/s per shape and efficiency vs the single-device
baseline x n_devices. By default the mesh is 8 virtual CPU devices,
which checks the collective path only; with --cpu-devices 0 it runs on
the host's cards (e.g. four H100s: (4,1), (2,2), (1,4)) — mesh
construction is the only difference (SURVEY §2.4).

Usage: python scripts/bench_scaling.py [--genome-mb 16] [--reads 16384]
Prints one JSON line; --out FILE also writes it there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=16.0)
    ap.add_argument("--reads", type=int, default=16384)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--repeat-frac", type=float, default=0.45)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--cpu-devices", type=int, default=8,
                    help="0 = run on the host's cards instead of "
                    "virtual CPU devices")
    ap.add_argument("--out", default="-")
    args = ap.parse_args()

    if args.cpu_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_devices}"
        ).strip()
    import jax
    if args.cpu_devices:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from bench import make_bench_data
    from find_circ2_tpu.config import Config
    from find_circ2_tpu.index.build import build_index
    from find_circ2_tpu.models.pipeline import (DeviceIndex,
                                                detect_batch_phased)
    from find_circ2_tpu.parallel.mesh import make_mesh
    from find_circ2_tpu.parallel.sharded import ShardedEngine

    cfg = Config(batch_size=args.batch)
    t0 = time.time()
    genome, reads, lens, _ = make_bench_data(
        args.reads, args.genome_mb, 100, cfg,
        repeat_frac=args.repeat_frac)
    index = build_index(genome, cfg)
    dindex = DeviceIndex.build(genome, index, cfg)
    n_dev = len(jax.devices())
    print(f"setup {time.time() - t0:.0f}s; {n_dev} devices "
          f"({jax.devices()[0].device_kind})", file=sys.stderr)

    B = args.batch
    nb = args.reads // B

    def bar(o):
        np.asarray((o["status"] if isinstance(o, dict) else o)[:1])

    # Single-device baseline.
    rd = [jax.device_put(reads[i * B:(i + 1) * B]) for i in range(nb)]
    ld = [jax.device_put(lens[i * B:(i + 1) * B]) for i in range(nb)]
    bar(detect_batch_phased(dindex, rd[0], ld[0], cfg, True))
    base = float("inf")
    for _ in range(args.epochs):
        t0 = time.time()
        for i in range(nb):
            o = detect_batch_phased(dindex, rd[i], ld[i], cfg, True)
        bar(o)
        base = min(base, time.time() - t0)
    base_rps = args.reads / base
    print(f"single-device baseline: {base_rps:,.0f} reads/s",
          file=sys.stderr)

    shapes = []
    for total in (2, 4, 8):
        if total > n_dev:
            continue
        d = 1
        while d <= total:
            shapes.append((d, total // d))
            d *= 2
    rows = []
    for (d, i) in shapes:
        mesh = make_mesh(d * i, (d, i))
        eng = ShardedEngine(genome, index, mesh, cfg, prefilter=True)
        bs = -(-B // eng.n_data) * eng.n_data
        batches = [(reads[k * bs:(k + 1) * bs], lens[k * bs:(k + 1) * bs])
                   for k in range(args.reads // bs)]
        eng.detect(*batches[0])     # compile
        best = float("inf")
        for _ in range(args.epochs):
            t0 = time.time()
            for rb, lb in batches:
                o = eng.detect(rb, lb)
            bar(o)
            best = min(best, time.time() - t0)
        rps = len(batches) * bs / best
        eff = rps / (base_rps * d * i)
        row = dict(data=d, index=i, reads_per_s=round(rps),
                   efficiency=round(eff, 3))
        if eff > 1.1:
            # Output sanity guard: super-linear scaling means broken
            # timing, not speedup.
            row["suspect"] = True
        rows.append(row)
        print(f"mesh (data={d}, index={i}): {rps:,.0f} reads/s, "
              f"efficiency {eff:.2f} vs {d * i}x single", file=sys.stderr)

    out = dict(device=jax.devices()[0].device_kind, n_devices=n_dev,
               physical_cores=os.cpu_count(),
               genome_mb=args.genome_mb, reads=args.reads,
               single_device_reads_per_s=round(base_rps), shapes=rows)
    if args.cpu_devices and os.cpu_count() < n_dev:
        out["caveat"] = (
            f"{n_dev} virtual devices share {os.cpu_count()} physical "
            "cores: efficiency-vs-Nx-single is compute-oversubscribed "
            "and NOT a hardware scaling measurement — it validates the "
            "collective path and relative mesh-shape behavior only. "
            "Data-parallel shapes track the physical-core ceiling "
            "(total work constant); index-sharded shapes replicate "
            "variant enumeration per shard, which oversubscribed CPUs "
            "serialize but separate cards run in parallel.")
    js = json.dumps(out)
    print(js)
    if args.out != "-":
        with open(args.out, "w") as fh:
            fh.write(js + "\n")


if __name__ == "__main__":
    main()
