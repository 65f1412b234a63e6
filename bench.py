"""Benchmark: reads/s/card on the anchor+breakpoint pipeline — the
north-star metric (BASELINE.json:2). Prints ONE JSON line.

The reference publishes no numbers (BASELINE.json:13 "published": {});
`vs_baseline` is therefore the speedup over the in-repo CPU oracle, which
implements the reference algorithm the way the reference does (per-read
Python/numpy, single core) — the honest stand-in for find_circ2's own
per-read Python hot loop (SURVEY.md §6).

The bench genome is ~45% repetitive by default (tandem satellite +
dispersed SINE/LINE-like families, utils/simulate.plant_repeats) at
chr20 scale (64 MB, BASELINE configs[1]) — IID-random genomes make the
MAX_BUCKET guard, cuckoo load, and gather locality unrealistically
friendly. Alongside throughput the bench prints a memory-bound roofline:
K1 is random 32 B bucket-row gathers (8 per read on the exact-first
path, 244 on the classic enumeration) plus 4 ~88 B window reads
(prefilter + K2), so the floor is device-memory-bound, not FLOP-bound;
achieved reads/s is reported as a % of the bytes bound at the card's
published bandwidth (PEAKS).

Runs on a GPU only: with no GPU it exits non-zero. The JSON line names
the platform, device kind, device count and the card's power limit.

Usage: python bench.py [--genome-mb M | --sizes 32,64,256]
                       [--repeat-frac F] [--reads N] [--batch B]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.path.join(REPO_ROOT, ".bench_cache")   # in .gitignore

# Published peaks by JAX device_kind, for roofline shares. Source: NVIDIA
# H100 Tensor Core GPU data sheet, SXM5 part (80 GB HBM3 at 3.35 TB/s;
# 989 TFLOP/s dense bf16), at the full 700 W power limit. A device kind
# missing here is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12,
                                  bf16_flops_per_s=989e12),
}


def device_peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise ValueError(f"no published peaks for device kind {kind!r}; "
                         f"add them to bench.PEAKS with their source")
    return PEAKS[kind]


def card_power_limit() -> str:
    """The first card's power limit as nvidia-smi reports it, read in a
    child process (never through JAX)."""
    import subprocess
    r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0].strip()


def make_bench_data(n_reads: int, genome_mb: float, read_len: int, cfg,
                    seed: int = 0, repeat_frac: float = 0.45):
    """Vectorized read generation over a repetitive genome: half the reads
    cross planted junctions, half map contiguously; both classes sample
    the whole genome, so anchors land in repeats at the genomic rate."""
    from find_circ2_tpu.config import RPAD_CODE
    from find_circ2_tpu.io.genome import Genome
    from find_circ2_tpu.utils.simulate import plant_repeats

    rng = np.random.default_rng(seed)
    glen = int(genome_mb * 1e6)
    seq = rng.integers(0, 4, size=glen, dtype=np.uint8)
    planted = {}
    if repeat_frac > 0:
        planted = plant_repeats(rng, seq, repeat_frac)
    genome = Genome.from_records([("chrB", seq)], cfg)
    a = cfg.anchor_len
    L = read_len

    n_circ = n_reads // 2
    n_cont = n_reads - n_circ
    # Circular junction reads: [end-bp : end] + [start : start+L-bp].
    span = rng.integers(L, 2000, size=n_circ)
    start = rng.integers(500, glen - 3000, size=n_circ)
    end = start + span
    bp = rng.integers(a, L - a + 1, size=n_circ)
    cols = np.arange(L)[None, :]
    take_left = cols < bp[:, None]
    left_idx = end[:, None] - bp[:, None] + cols     # read[i]=seq[end-bp+i]
    right_idx = start[:, None] + cols - bp[:, None]  # read[i]=seq[start+i-bp]
    circ = np.where(take_left, seq[left_idx % glen],
                    seq[right_idx % glen])
    # Contiguous reads.
    p = rng.integers(0, glen - L, size=n_cont)
    cont = seq[p[:, None] + np.arange(L)[None, :]]

    reads = np.concatenate([circ, cont]).astype(np.uint8)
    rng.shuffle(reads, axis=0)
    lens = np.full(n_reads, L, np.int32)
    Lp = cfg.max_read_len
    padded = np.full((n_reads, Lp), RPAD_CODE, np.uint8)
    padded[:, :L] = reads
    return genome, padded, lens, planted


def index_repeat_stats(index, cfg):
    """(pct of indexed positions inside >MAX_BUCKET 20-mers, n_distinct)."""
    from find_circ2_tpu.index.hashtable import distinct_kmers
    _, _, cnt, _ = distinct_kmers(index)
    total = int(index.positions.size)
    guarded = int(cnt[cnt > cfg.max_bucket].astype(np.int64).sum())
    return (100.0 * guarded / max(1, total), int(cnt.size))


def roofline_reads_per_s(cfg, read_len: int, bw: float,
                         exact_first: bool = False) -> float:
    """Memory-bound roofline for the per-read device-memory traffic, in
    reads/s: the bytes actually needed — K1 rows (32 B each, one DRAM
    sector) + 4 packed windows (~(Lp/8+2)*4 B each) + the read itself +
    the packed result row — at bandwidth `bw`.
    K1 rows/read: classic enumeration = 2 anchors x (1+3a) canonical
    variants x 2 probes = 244; exact-first (K1 v4) = 2 anchors x 2
    probes x (main + neighbor row) = 8, plus the amortized static
    fallback slice (exact_fallback_slots anchors re-enumerated per
    2*batch anchors)."""
    V = 1 + 3 * cfg.anchor_len
    if exact_first:
        frac = min(1.0, cfg.exact_fallback_slots / (2 * cfg.batch_size))
        rows = 2 * 2 * 2 + frac * (2 * V * 2)
    else:
        rows = 2 * V * 2
    row_bytes = rows * 32
    win_bytes = 4 * (cfg.max_read_len // 8 + 2) * 4
    io_bytes = cfg.max_read_len + 4 + 14 * 4
    return bw / (row_bytes + win_bytes + io_bytes)


def ntable_cached(index, cfg, tag: str):
    """Disk-cached K1 v4 neighbor table (the one-time aggregation costs
    minutes at 50M keys; the table is a pure function of the query
    table + cfg.max_bucket, and the cache key pins the salts, bucket
    count and format generation, so staleness is structurally
    impossible)."""
    import hashlib
    from find_circ2_tpu.index.hashtable import (TABLE_FORMAT,
                                                build_neighbor_table)
    qt = index.qtable
    key = hashlib.sha1(
        f"{TABLE_FORMAT}|{cfg.max_bucket}|{tag}|{qt.n_buckets}|"
        f"{int(qt.meta[0])}|{int(qt.meta[1])}".encode()).hexdigest()[:16]
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"ntable_{key}.npy")
    if os.path.exists(path):
        nt = np.load(path)
        if nt.shape[0] == qt.table.shape[0]:
            return nt
    nt = build_neighbor_table(index, cfg)
    np.save(path, nt)
    return nt


def bench_size(genome_mb: float, args, cfg, jax, headline: bool):
    """Build genome+index at one size, measure throughput; returns dict."""
    from find_circ2_tpu.index.build import build_index
    from find_circ2_tpu.index.hashtable import build_query_table
    from find_circ2_tpu.models.pipeline import (DeviceIndex, _align_phase,
                                                _core_phase,
                                                detect_batch_phased)

    t0 = time.time()
    genome, reads, lens, planted = make_bench_data(
        args.reads, genome_mb, args.read_len, cfg, repeat_frac=args.repeat_frac)
    index = build_index(genome, cfg)
    guard_pct, n_distinct = index_repeat_stats(index, cfg)
    index.qtable = build_query_table(index, cfg)
    index.qtable.ntable = ntable_cached(
        index, cfg, f"bench|{genome_mb}|{args.repeat_frac}")
    dindex = DeviceIndex.build(genome, index, cfg)
    rep_mb = sum(planted.values()) / 1e6
    print(f"bench[{genome_mb:g}MB]: setup {time.time() - t0:.1f}s — "
          f"{index.positions.size} positions, {n_distinct} distinct "
          f"20-mers, repeats {rep_mb:.1f}MB planted "
          f"({100 * rep_mb / genome_mb:.0f}%), {guard_pct:.2f}% of "
          f"positions behind the MAX_BUCKET guard", file=sys.stderr)

    B = args.batch
    n_batches = args.reads // B
    from find_circ2_tpu.models.pipeline import revcomp_batch
    reads_d = [jax.device_put(reads[i * B:(i + 1) * B])
               for i in range(n_batches)]
    lens_d = [jax.device_put(lens[i * B:(i + 1) * B])
              for i in range(n_batches)]
    # Host-computed rc ships with the batch (pipeline.revcomp_batch):
    # in production it overlaps device compute like the encode stage,
    # so it is prepared with the batches here, outside the timed loop.
    rc_d = [jax.device_put(revcomp_batch(reads[i * B:(i + 1) * B],
                                         lens[i * B:(i + 1) * B]))
            for i in range(n_batches)]

    # Every timed region ends in block_until_ready: on a directly
    # attached GPU it returns once the device has finished the work.
    barrier = jax.block_until_ready

    def step(rb, lb, rcb):
        if args.fused:
            # Single fused program (pipeline.detect_batch) for the
            # phased-vs-fused comparison
            from find_circ2_tpu.models.pipeline import detect_batch
            return detect_batch(dindex.gpacked, dindex.nbases,
                                dindex.table, dindex.meta,
                                dindex.chrom_offsets, rb, lb, cfg, True,
                                rc=rcb)
        return detect_batch_phased(dindex, rb, lb, cfg, True, rc=rcb)

    t0 = time.time()
    out = step(reads_d[0], lens_d[0], rc_d[0])
    barrier(out)
    print(f"bench[{genome_mb:g}MB]: compile+warmup {time.time() - t0:.1f}s",
          file=sys.stderr)

    n_done = n_batches * B
    best_dt = float("inf")
    outs = []
    for epoch in range(args.epochs):
        t0 = time.time()
        outs = []
        for rb, lb, rcb in zip(reads_d, lens_d, rc_d):
            outs.append(step(rb, lb, rcb))
        barrier(outs)
        dt = time.time() - t0
        print(f"bench[{genome_mb:g}MB]: epoch {epoch}: {n_done} reads in "
              f"{dt:.3f}s -> {n_done / dt:,.0f} reads/s/card",
              file=sys.stderr)
        best_dt = min(best_dt, dt)
    rps = n_done / best_dt
    statuses = np.concatenate([np.asarray(o["status"]) for o in outs])
    n_junc = int((statuses == 0).sum())

    # Phase breakdown (sync per phase adds dispatch overhead; report the
    # split, keep the un-instrumented epochs as the headline). Times the
    # SAME align variant the headline ran (exact-first when the index
    # carries a neighbor table), warmed so compile stays out.
    if dindex.ntable is not None:
        from find_circ2_tpu.models.pipeline import _align_phase_fast

        def align_step(rb, lb):
            ha, hb, _ = _align_phase_fast(dindex.table, dindex.ntable,
                                          dindex.meta, rb, lb, cfg)
            return ha, hb
    else:
        def align_step(rb, lb):
            return _align_phase(dindex.table, dindex.meta, rb, lb, cfg)

    barrier(align_step(reads_d[0], lens_d[0]))  # warm
    t0 = time.time()
    hits = [align_step(rb, lb) for rb, lb in zip(reads_d, lens_d)]
    barrier(hits)
    t_align = time.time() - t0
    t0 = time.time()
    cores = [_core_phase(dindex.gpacked, dindex.nbases,
                         dindex.chrom_offsets, rb, lb, ha, hb, cfg,
                         True, rcb)
             for (rb, lb, rcb), (ha, hb)
             in zip(zip(reads_d, lens_d, rc_d), hits)]
    barrier(cores)
    t_core = time.time() - t0

    dev = jax.devices()[0]
    bw = device_peaks(dev.device_kind)["hbm_bytes_per_s"]
    rl_bytes = roofline_reads_per_s(cfg, args.read_len, bw,
                                    exact_first=dindex.ntable is not None)
    print(f"bench[{genome_mb:g}MB]: best {rps:,.0f} reads/s/card "
          f"({n_junc} junction reads) | K1 {t_align:.2f}s / core "
          f"{t_core:.2f}s per {n_done} reads | roofline: "
          f"{100 * rps / rl_bytes:.2f}% of the bytes bound "
          f"{rl_bytes / 1e6:.1f}M reads/s at {bw / 1e12:.2f} TB/s",
          file=sys.stderr)

    result = dict(genome_mb=genome_mb, rps=rps, n_junc=n_junc,
                  guard_pct=guard_pct, t_align=t_align, t_core=t_core,
                  roofline_bytes=rl_bytes)

    if headline and args.sharded and len(jax.devices()) >= 1:
        from find_circ2_tpu.parallel.distributed import make_engine
        eng = make_engine(genome, index, cfg)
        n_dev = len(jax.devices())
        bs = B * max(1, eng.n_data)
        sh_batches = [(reads[i * bs:(i + 1) * bs], lens[i * bs:(i + 1) * bs])
                      for i in range(args.reads // bs)]
        eng.detect(*sh_batches[0])  # compile
        best = float("inf")
        for _ in range(args.epochs):
            t0 = time.time()
            for rb, lb in sh_batches:
                out = eng.detect(rb, lb)
            barrier(out)
            best = min(best, time.time() - t0)
        sh_rps = len(sh_batches) * bs / best
        eff = sh_rps / (rps * n_dev)
        print(f"bench: sharded {n_dev} devices "
              f"(mesh {dict(eng.mesh.shape)}): {sh_rps:,.0f} reads/s, "
              f"scaling efficiency {eff:.2f}", file=sys.stderr)

    if headline:
        # CPU-oracle baseline on a fixed-size sample of the same reads.
        from find_circ2_tpu.io.twobit import codes_to_seq
        from find_circ2_tpu.models.oracle import call_read
        sample = min(args.oracle_sample, n_done)
        t0 = time.time()
        for i in range(sample):
            call_read(genome, index, f"r{i}",
                      codes_to_seq(reads[i, :args.read_len]), cfg)
        result["oracle_rps"] = sample / (time.time() - t0)
        print(f"bench: oracle {result['oracle_rps']:,.1f} reads/s "
              f"(sample {sample})", file=sys.stderr)
    return result


def attribute_misses(missed_keys, truth_by_key, rows_by_key, sim, index,
                     cfg, sample_cap: int = 150):
    """Why did each missed truth junction fail?

    Junctions that aggregated but failed the frozen filter stack are
    classified by the first failing criterion; junctions absent from the
    table entirely are re-called through the CPU oracle read by read and
    classified by the dominant status — with unaligned anchors further
    split into 'MAX_BUCKET-guarded' (the exact anchor 20-mer is more
    frequent than the repetitive guard) vs 'no <=1-mm hit' (diverged
    repeat copy / anchor N). Returns a {reason: count} dict over at most
    `sample_cap` missed junctions (scaled-up counts are NOT extrapolated;
    the sample size rides along under 'sampled')."""
    from collections import Counter
    from find_circ2_tpu.config import (ST_JUNCTION, ST_PREFILTERED,
                                       ST_UNALIGNED_A, ST_UNALIGNED_B,
                                       STATUS_NAMES)
    from find_circ2_tpu.index.build import kmer_values
    from find_circ2_tpu.io.twobit import revcomp_seq, seq_to_codes
    from find_circ2_tpu.models.oracle import call_read

    seq_by_name = dict(sim.reads)
    br = Counter()
    keys = sorted(missed_keys)[:sample_cap]
    br["sampled"] = len(keys)

    def exact_count(anchor_seq: str) -> int:
        best = 0
        for s in (anchor_seq, revcomp_seq(anchor_seq)):
            codes = seq_to_codes(s)
            if (codes >= 4).any():
                continue
            kk, ok = kmer_values(codes, cfg.prefix_len)
            ss, ok2 = kmer_values(codes[cfg.prefix_len:],
                                  cfg.anchor_len - cfg.prefix_len)
            if ok[0] and ok2[0]:
                best = max(best,
                           index.lookup(int(kk[0]), int(ss[0])).size)
        return best

    for key in keys:
        row = rows_by_key.get(key)
        if row is not None:
            flags = set(row.category.split(","))
            if "ANCHOR_UNIQUE" not in flags:
                br["filtered_no_unique_anchor"] += 1
            elif "UNAMBIGUOUS_BP" not in flags:
                br["filtered_ambiguous_bp"] += 1
            elif "CIRCULAR" not in flags:
                br["filtered_not_circular"] += 1
            elif row.n_reads < cfg.min_support:
                br["filtered_support"] += 1
            elif row.edits > cfg.filter_max_edits:
                br["filtered_edits"] += 1
            else:
                br["filtered_span"] += 1
            continue
        tj = truth_by_key[key]
        statuses = Counter()
        for rname in tj.reads:
            call = call_read(sim.genome, index, rname, seq_by_name[rname],
                             cfg)
            st = call.status
            if st == ST_JUNCTION:
                statuses["relocated_junction"] += 1
            elif st in (ST_UNALIGNED_A, ST_UNALIGNED_B):
                a = cfg.anchor_len
                anchor = (seq_by_name[rname][:a]
                          if st == ST_UNALIGNED_A
                          else seq_by_name[rname][-a:])
                if exact_count(anchor) > cfg.max_bucket:
                    statuses["anchor_maxbucket_guarded"] += 1
                else:
                    statuses["anchor_no_1mm_hit"] += 1
            elif st == ST_PREFILTERED:
                statuses["prefiltered"] += 1
            else:
                statuses[STATUS_NAMES[st]] += 1
        why, _ = statuses.most_common(1)[0]
        br[f"reads_{why}"] += 1
    return dict(br)


def bench_filter_stack(args, cfg, jax):
    """BASELINE configs[2]: the FULL pipeline (streaming loop + multi-hit
    slow path + aggregation + frozen filter stack) on a simulated
    RNase-R-treated circRNA-enrichment library; reports end-to-end
    throughput and precision/recall of `--filter` calls vs planted truth."""
    from find_circ2_tpu.index.build import build_index
    from find_circ2_tpu.io.bed import passes_filter
    from find_circ2_tpu.models.aggregate import Aggregator
    from find_circ2_tpu.models.pipeline import DeviceIndex, run_reads
    from find_circ2_tpu.utils.simulate import rnase_r_library

    t0 = time.time()
    sim = rnase_r_library(seed=7, chrom_lengths={"chrR": 16_000_000},
                          n_circ=1500 * args.fs_scale,
                          n_linear=200 * args.fs_scale, depth_mean=12.0,
                          cfg=cfg)
    index = build_index(sim.genome, cfg)
    from find_circ2_tpu.index.hashtable import build_query_table
    index.qtable = build_query_table(index, cfg)
    index.qtable.ntable = ntable_cached(index, cfg,
                                        f"fs|{args.fs_scale}")
    dindex = DeviceIndex.build(sim.genome, index, cfg)
    n_reads = len(sim.reads)
    print(f"bench[filter-stack]: setup {time.time() - t0:.1f}s — "
          f"{n_reads} library reads, {len(sim.truths)} true junctions",
          file=sys.stderr)

    # Warm the jit cache so compile time stays out of the timed loop:
    # the detect program and every explore bucket size (SPEC §2b device
    # multi-hit, ops/explore.py).
    import jax.numpy as jnp
    from find_circ2_tpu.config import RPAD_CODE
    from find_circ2_tpu.models.pipeline import (DeviceExplorer,
                                                dispatch_packed)
    from find_circ2_tpu.ops.explore import explore_batch_packed
    t0 = time.time()
    dummy = jnp.asarray(np.full((cfg.batch_size, cfg.max_read_len),
                                RPAD_CODE, np.uint8))
    jax.block_until_ready(dispatch_packed(
        dindex, dummy, jnp.zeros(cfg.batch_size, jnp.int32), cfg, True))
    for b in DeviceExplorer.BUCKETS:
        jax.block_until_ready(explore_batch_packed(
            dindex.gpacked, dindex.nbases, dindex.table, dindex.meta,
            dindex.ext, dindex.ext_id, dindex.chrom_offsets,
            dummy[:b], jnp.zeros(b, jnp.int32), cfg, True))
    # Warm the HOST paths too (first-call numpy/enum-cache costs in the
    # batched rescue, explore fetch, vectorized aggregation): one small
    # slice of the same library through the full loop into a throwaway
    # aggregator — the host analog of the jit warmup above.
    warm = Aggregator(sim.genome, cfg)
    for call in run_reads(dindex, sim.reads[:2048], cfg, prefilter=True,
                          slowpath=(sim.genome, index)):
        warm.add(call)
    warm.rows(sample_name="warm")
    print(f"bench[filter-stack]: compile+warmup {time.time() - t0:.1f}s",
          file=sys.stderr)

    from find_circ2_tpu.utils.profiling import StageTimes
    from find_circ2_tpu import native

    times = StageTimes()
    use_native = native.available()
    if use_native:
        # Production path: native FASTQ scan/encode + vectorized
        # aggregation (models/stream.run_fastq) — what `find_circ
        # --reads-format fastq` runs.
        from find_circ2_tpu.models.stream import run_fastq
        os.makedirs(CACHE_DIR, exist_ok=True)
        fq = os.path.join(CACHE_DIR, f"filter_stack_{os.getpid()}.fastq")
        with open(fq, "wt") as fh:
            for name, seq in sim.reads:
                fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
        t0 = time.time()
        agg = Aggregator(sim.genome, cfg)
        run_fastq(dindex, fq, agg, cfg, prefilter=True,
                  slowpath=(sim.genome, index), times=times)
        os.unlink(fq)
    else:
        t0 = time.time()
        agg = Aggregator(sim.genome, cfg)
        for call in run_reads(dindex, sim.reads, cfg, prefilter=True,
                              slowpath=(sim.genome, index), times=times):
            agg.add(call)
    with times.stage("rows_filters"):
        rows = agg.rows(sample_name="rnaser")
        filt = [r for r in rows if passes_filter(r, cfg.max_span,
                                                 cfg.min_support,
                                                 cfg.filter_max_edits)]
    dt = time.time() - t0
    truth = {(t.chrom, t.start, t.end) for t in sim.truths
             if t.kind == "circular" and len(t.reads) >= cfg.min_support}
    called = {(r.chrom, r.start, r.end) for r in filt}
    tp = len(truth & called)
    prec = tp / max(1, len(called))
    rec = tp / max(1, len(truth))
    truth_by_key = {(t.chrom, t.start, t.end): t for t in sim.truths
                    if t.kind == "circular"}
    rows_by_key = {(r.chrom, r.start, r.end): r for r in rows}
    # Detection recall (pre-filter table) vs filtered recall: the r2
    # miss attribution showed the gap is NOT anchor sensitivity — it is
    # junctions inside repeats whose every read has a multi-mapping
    # anchor (qual 0), which the frozen ANCHOR_UNIQUE filter excludes
    # exactly as the reference's MAPQ filter would (SPEC §2 MAPQ
    # surrogate), plus reads relocated to equivalent repeat copies.
    rec_detect = len({k for k in truth if k in rows_by_key}) \
        / max(1, len(truth))
    breakdown = attribute_misses(truth - called, truth_by_key,
                                 rows_by_key, sim, index, cfg)
    print(f"bench[filter-stack]: detection recall {rec_detect:.3f} "
          f"(junction in the pre-filter table) | miss breakdown "
          f"({len(truth - called)} missed truths) — {breakdown}",
          file=sys.stderr)
    n_slow = times.counts.get("slowpath_multihit", 0)
    t_slow = times.totals.get("slowpath_multihit", 0.0)
    t_exp = (times.totals.get("explore_dispatch", 0.0)
             + times.totals.get("explore_multihit", 0.0))
    print(f"bench[filter-stack]: {n_reads} reads end-to-end in {dt:.1f}s "
          f"-> {n_reads / dt:,.0f} reads/s (incl. aggregation+filters; "
          f"host slow path {n_slow} reads/{t_slow:.1f}s, device explore "
          f"{t_exp:.1f}s) | {len(filt)} junctions pass the frozen stack "
          f"| precision {prec:.3f}, recall {rec:.3f} vs {len(truth)} "
          f"well-supported planted circles", file=sys.stderr)
    print("bench[filter-stack]: stages — " + times.report(wall=dt),
          file=sys.stderr)
    return dict(rps=n_reads / dt, precision=prec, recall=rec,
                recall_detect=rec_detect, breakdown=breakdown)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=131_072)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--genome-mb", type=float, default=64.0,
                    help="headline genome size (chr20-scale default)")
    ap.add_argument("--sizes", default=None,
                    help="CSV of genome sizes (MB) to sweep; first is the "
                    "headline (overrides --genome-mb)")
    ap.add_argument("--repeat-frac", type=float, default=0.45,
                    help="fraction of the genome overwritten with repeat "
                    "families (0 = IID random, the r01 behavior)")
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--oracle-sample", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--fs-scale", type=int, default=4,
                    help="filter-stack library size multiplier (x1500 "
                    "circles, ~24k reads each; default 4 => ~96k reads "
                    "so fixed overheads amortize)")
    ap.add_argument("--filter-stack", action="store_true",
                    help="run ONLY the BASELINE configs[2] "
                    "full-filter-stack bench (RNase-R-like library); "
                    "JSON metric becomes end-to-end reads/s with "
                    "vs_baseline = filtered-call F1")
    ap.add_argument("--fused", action="store_true",
                    help="time the single fused detect program instead "
                    "of the phased two-program split")
    ap.add_argument("--kernel-only", action="store_true",
                    help="skip the end-to-end pipeline figure (the "
                    "default run reports BOTH the detect-kernel headline "
                    "and the configs[2] full-pipeline throughput)")
    ap.add_argument("--sharded", action="store_true",
                    help="also run the (data, index)-sharded engine over "
                    "all attached devices and report scaling efficiency "
                    "(BASELINE configs[3]/[4])")
    ap.add_argument("--max-pair-hits", type=int, default=None,
                    help="override cfg.max_pair_hits (K): §2b candidate "
                    "list length / explore grid size")
    ap.add_argument("--max-bucket", type=int, default=None,
                    help="override cfg.max_bucket (repetitive-20-mer "
                    "guard)")
    args = ap.parse_args(argv)

    import jax

    from find_circ2_tpu.config import Config
    from find_circ2_tpu.utils import device

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found "
                         f"'{jax.default_backend()}'")
    device.enable_compile_cache()
    dev = jax.devices()[0]
    dev_info = {"platform": dev.platform, "device_kind": dev.device_kind,
                "count": len(jax.devices()),
                "power_limit": card_power_limit()}

    over = {}
    if args.max_pair_hits is not None:
        over["max_pair_hits"] = args.max_pair_hits
    if args.max_bucket is not None:
        over["max_bucket"] = args.max_bucket
    cfg = Config(batch_size=args.batch, **over)
    if args.filter_stack:
        r = bench_filter_stack(args, cfg, jax)
        f1 = (2 * r["precision"] * r["recall"]
              / max(1e-9, r["precision"] + r["recall"]))
        print(json.dumps({
            "metric": "filter_stack_reads_per_s",
            "value": round(r["rps"], 1),
            "unit": "reads/s",
            "vs_baseline": round(f1, 4),
            "precision": round(r["precision"], 4),
            "recall": round(r["recall"], 4),
            "detection_recall": round(r["recall_detect"], 4),
            "miss_breakdown": r["breakdown"],
            "device": dev_info,
        }))
        return 0
    sizes = ([float(s) for s in args.sizes.split(",")] if args.sizes
             else [args.genome_mb])
    print(f"bench: device={dev.device_kind} ({dev_info['power_limit']}), "
          f"sizes={sizes}MB, "
          f"repeat_frac={args.repeat_frac}, reads={args.reads}, "
          f"batch={args.batch}", file=sys.stderr)

    results = []
    for i, mb in enumerate(sizes):
        results.append(bench_size(mb, args, cfg, jax, headline=(i == 0)))
        gc.collect()

    head = results[0]
    out = {
        "metric": "reads_per_s_per_card",
        "value": round(head["rps"], 1),
        "unit": "reads/s",
        "vs_baseline": round(head["rps"] / head["oracle_rps"], 2),
        "roofline_bytes_pct": round(100 * head["rps"]
                                    / head["roofline_bytes"], 2),
        "device": dev_info,
    }
    if not args.kernel_only:
        # The honest second figure: the FULL
        # pipeline — streaming + §2b multi-hit + aggregation + frozen
        # filters — on the repeat-realistic configs[2] library.
        gc.collect()
        fs = bench_filter_stack(args, cfg, jax)
        out["pipeline_reads_per_s"] = round(fs["rps"], 1)
        out["pipeline_precision"] = round(fs["precision"], 4)
        out["pipeline_recall"] = round(fs["recall"], 4)
        out["pipeline_detection_recall"] = round(fs["recall_detect"], 4)
        out["pipeline_miss_breakdown"] = fs["breakdown"]
    if len(results) > 1:
        out["sizes_mb"] = [r["genome_mb"] for r in results]
        out["sizes_reads_per_s"] = [round(r["rps"], 1) for r in results]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
