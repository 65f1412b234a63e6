"""Whole-human-genome-scale demonstration (BASELINE configs[4]/[5]
feasibility): build a >=3 Gbp synthetic repetitive genome index, verify
>2^31 uint32 global positions end-to-end, run the sharded multi-device
step on a virtual CPU mesh, and bench a batch on the GPU.

The genome is deliberately repetitive (a random core tiled with point
mutations) — real genomes are not IID; tiling stresses max_bucket
guards, cuckoo load, and gather locality while keeping the
distinct-k-mer count within one card's memory.

Modes (artifacts cached under --workdir, default <repo>/.bigg):
  build   genome + chunked index + query table, saved as raw .npy
  verify  oracle vs device equality on planted junction reads (>2^31)
  dryrun  sharded detect+merge on an 8-virtual-device CPU mesh
  bench   reads/s on one card over the whole-genome index
Run dryrun in a separate process from bench (JAX platform is fixed at
import).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(msg):
    print(f"[big_genome +{time.time() - T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


T0 = time.time()


def make_genome_codes(total_bp: int, core_bp: int, mut_rate: float,
                      seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 4, core_bp, dtype=np.uint8)
    parts = []
    done = 0
    while done < total_bp:
        c = core.copy()
        nm = int(core_bp * mut_rate)
        if parts and nm:  # first copy stays pristine
            p = rng.integers(0, core_bp, nm)
            c[p] = (c[p] + rng.integers(1, 4, nm, dtype=np.uint8)) % 4
        parts.append(c)
        done += core_bp
    return np.concatenate(parts)[:total_bp]


def build(args):
    """Stage-resumable build: each stage saves its artifacts the moment it completes and is
    skipped on rerun when they already exist on disk."""
    import numpy as np
    from find_circ2_tpu.config import Config
    from find_circ2_tpu.index.build import SeedIndex, build_index
    from find_circ2_tpu.index.hashtable import build_query_table
    from find_circ2_tpu.io.genome import Genome

    cfg = Config()
    w = args.workdir
    os.makedirs(w, exist_ok=True)
    total = int(args.total_gbp * 1e9)
    n_chroms = args.n_chroms

    def have(*names):
        return all(os.path.exists(f"{w}/{n}.npy") for n in names)

    # --- stage 1: genome ------------------------------------------------
    if have("codes", "chrom_offsets", "chrom_lengths"):
        log("stage genome: cached, loading")
        genome = Genome(
            codes=np.load(f"{w}/codes.npy", mmap_mode="r"),
            chrom_names=[f"chr{i + 1}" for i in range(n_chroms)],
            chrom_offsets=np.load(f"{w}/chrom_offsets.npy"),
            chrom_lengths=np.load(f"{w}/chrom_lengths.npy"),
        )
    else:
        log(f"generating {total / 1e9:.2f} Gbp genome "
            f"(core {args.core_mbp} Mbp, mut {args.mut_rate})")
        codes = make_genome_codes(total, int(args.core_mbp * 1e6),
                                  args.mut_rate, seed=1)
        per = total // n_chroms
        records = [(f"chr{i + 1}", codes[i * per:(i + 1) * per])
                   for i in range(n_chroms)]
        genome = Genome.from_records(records, cfg)
        del codes, records
        np.save(f"{w}/codes.npy", genome.codes)
        np.save(f"{w}/chrom_offsets.npy", genome.chrom_offsets)
        np.save(f"{w}/chrom_lengths.npy", genome.chrom_lengths)
        log(f"genome stage saved: {len(genome):,} codes "
            f"({len(genome) / 2 ** 30:.2f} GiB), {n_chroms} chroms; "
            f"max offset {int(genome.chrom_offsets[-1]):,} "
            f"(2^31={2 ** 31:,})")
    if args.total_gbp >= 2.2:
        assert len(genome) > 2 ** 31, "demo must cross the int32 barrier"

    # --- stage 2: two-level index ---------------------------------------
    if have("positions", "suffix_vals", "offsets") \
            and os.path.exists(f"{w}/index_meta.json"):
        log("stage index: cached, loading")
        im = json.load(open(f"{w}/index_meta.json"))
        index = SeedIndex(
            anchor_len=cfg.anchor_len, prefix_len=cfg.prefix_len,
            positions=np.load(f"{w}/positions.npy", mmap_mode="r"),
            suffix_vals=np.load(f"{w}/suffix_vals.npy", mmap_mode="r"),
            offsets=np.load(f"{w}/offsets.npy"),
            bsearch_iters=im["bsearch_iters"])
    else:
        log("building chunked index...")
        t = time.time()
        index = build_index(genome, cfg)
        np.save(f"{w}/positions.npy", index.positions)
        np.save(f"{w}/suffix_vals.npy", index.suffix_vals)
        np.save(f"{w}/offsets.npy", index.offsets)
        with open(f"{w}/index_meta.json", "w") as fh:
            json.dump({"bsearch_iters": index.bsearch_iters}, fh)
        log(f"index stage built+saved in {time.time() - t:.0f}s: "
            f"{index.positions.size:,} positions")

    # --- stage 3: query table -------------------------------------------
    from find_circ2_tpu.index.hashtable import TABLE_FORMAT
    cached = (have("qtable", "qmeta")
              and os.path.exists(f"{w}/meta.json"))
    if cached:
        qm = np.load(f"{w}/qmeta.npy")
        qv = int(qm[3]) if qm.size >= 4 else 1
        if qv != TABLE_FORMAT:
            log(f"cached query table has format {qv} != "
                f"{TABLE_FORMAT} (hash mixer changed): REBUILDING")
            cached = False
    if not cached:
        log("building query table (canonical k-mers + cuckoo)...")
        t = time.time()
        # extras=False: §2b extras rows at this scale would be ~29 GiB
        # (mostly count-2..64 core k-mers); multi-hit reads take the
        # host slow path instead. The cuckoo build logs its attempts —
        # the r3 run died silently for 4 h in exactly this stage.
        qt = build_query_table(index, cfg, extras=False, log=log)
        np.save(f"{w}/qtable.npy", qt.table)
        np.save(f"{w}/qmeta.npy", np.concatenate(
            [np.asarray(qt.meta, np.int32),
             np.asarray([TABLE_FORMAT], np.int32)]))
        with open(f"{w}/meta.json", "w") as fh:
            json.dump({"total_bp": total, "n_chroms": n_chroms,
                       "bsearch_iters": index.bsearch_iters}, fh)
        log(f"table stage built+saved in {time.time() - t:.0f}s: "
            f"{qt.n_buckets:,} buckets "
            f"({qt.table.nbytes / 2 ** 30:.2f} GiB)")
    log(f"build complete -> {w}")


def load(args):
    """Load the workdir artifacts via the package's shared directory
    loader (find_circ -x DIR uses the same path; version-checked)."""
    from find_circ2_tpu.index.build import load_index_dir
    try:
        return load_index_dir(args.workdir)
    except ValueError as e:          # stale table format
        raise SystemExit(str(e))


def plant_reads(genome, cfg, n_reads: int, read_len: int, seed: int,
                chrom_idx: int, index=None, unique: bool = False):
    """Junction-crossing circular reads planted INSIDE a late chromosome
    so every global coordinate involved exceeds 2^31.

    With `unique=True` (requires `index`), only junctions whose BOTH
    anchor 20-mer windows occur exactly once genome-wide are accepted
    (rejection sampling over exact index lookups). The r4 dryrun's
    `start > 2^31` assert failed precisely because it skipped this: the
    genome's 300 Mbp core repeats ~11x at mut 0.003, so a read whose
    anchors contain no copy-specific mutation legitimately multi-maps
    and K1's frozen min-position tie-break relocates it below 2^31 —
    expected behavior, not coordinate corruption. Unique anchors make
    relocation impossible, so any sub-2^31 coordinate IS a bug."""
    import numpy as np
    rng = np.random.default_rng(seed)
    a = cfg.anchor_len
    off = int(genome.chrom_offsets[chrom_idx])
    clen = int(genome.chrom_lengths[chrom_idx])
    L = read_len
    G = genome.codes

    def window_count(gpos: int) -> int:
        codes = np.asarray(G[gpos:gpos + a]).astype(np.int64)
        if (codes >= 4).any():
            return 0
        pk = cfg.prefix_len
        p12 = 0
        for c in codes[:pk]:
            p12 = p12 * 4 + int(c)
        s8 = 0
        for c in codes[pk:]:
            s8 = s8 * 4 + int(c)
        return index.lookup(p12, s8).size

    truths = []
    reads = np.empty((n_reads, L), np.uint8)
    i = 0
    tries = 0
    while i < n_reads:
        tries += 1
        if unique and tries > 2000 * n_reads:
            raise RuntimeError(
                f"could not find {n_reads} unique-anchor junctions in "
                f"{tries} tries (placed {i})")
        span = int(rng.integers(L, 5000))
        start = off + int(rng.integers(1000, clen - 8000))
        end = start + span
        bp = int(rng.integers(a, L - a + 1))
        if unique:
            # Unique SPLIT: a neighboring split k=bp±1 ties at 0 edits
            # iff the base crossing the seam matches its contiguation
            # (R[bp]=G[start] vs G[end]; R[bp-1]=G[end-1] vs
            # G[start-1]), and longer shifts require the ±1 tie first
            # (prefix-sum contiguity) — so these two inequalities pin
            # the breakpoint to exactly bp (n_bp == 1).
            if int(G[start]) == int(G[end]) \
                    or int(G[start - 1]) == int(G[end - 1]):
                continue
            # Anchor A = first 20 of the left piece G[end-bp : end];
            # anchor B = last 20 of the right piece G[start : start+L-bp].
            if window_count(end - bp) != 1:
                continue
            if window_count(start + (L - bp) - a) != 1:
                continue
        left = np.asarray(G[end - bp:end])
        right = np.asarray(G[start:start + (L - bp)])
        reads[i, :bp] = left
        reads[i, bp:] = right
        truths.append((start, end))
        i += 1
    if unique:
        log(f"planted {n_reads} unique-anchor junction reads in {tries} "
            f"tries ({tries / n_reads:.0f}/read)")
    return reads, truths


def verify(args):
    """Oracle-vs-XLA equality on planted >2^31 junction reads.

    Runs the FULL 8.82 GiB table through the single fused detect
    program on the CPU XLA backend. A card's whole-genome
    configuration is exercised by `bench` (whole table, or a
    prefix-range shard with --shard-of N); full-table semantics across
    shards by `dryrun` (psum/pmin over the 8-device mesh,
    oracle-checked)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from find_circ2_tpu.config import Config
    from find_circ2_tpu.io.twobit import codes_to_seq
    from find_circ2_tpu.models.oracle import call_read
    from find_circ2_tpu.models.pipeline import DeviceIndex, run_reads

    cfg = Config()
    genome, index = load(args)
    chrom_idx = genome.n_chroms - 1
    reads, truths = plant_reads(genome, cfg, 32, 100, 7, chrom_idx)
    big = len(genome) > 2 ** 31
    if big:
        assert truths[0][0] > 2 ** 31
    log(f"planted 32 circular reads on chr{chrom_idx + 1} "
        f"(global coords > 2^31: min start {min(t[0] for t in truths):,})")

    log("oracle calls...")
    items = [(f"r{i}", codes_to_seq(reads[i])) for i in range(len(reads))]
    oracle_calls = [call_read(genome, index, nm, sq, cfg)
                    for nm, sq in items]
    log(f"production streaming path on {jax.devices()[0].platform} "
        "(full table, XLA detect + host multi-hit/rescue routing)...")
    dindex = DeviceIndex.build(genome, index, cfg)
    calls = run_reads(dindex, items, cfg, slowpath=(genome, index),
                      explore=False)
    n_ok = 0
    for i, (oc, dc) in enumerate(zip(oracle_calls, calls)):
        assert dc == oc, (i, oc, dc)
        if oc.status == 0 and (oc.start, oc.end) == truths[i]:
            n_ok += 1
    B = len(reads)
    n_junc = sum(1 for oc in oracle_calls if oc.status == 0)
    log(f"oracle == device+routing on all {B} reads (field-level "
        f"ReadCall equality); {n_junc} junction calls, {n_ok} at exact "
        f"planted coordinates (repetitive-genome multi-mapping may "
        f"relocate the rest — dryrun pins exactness with unique-anchor "
        f"reads)")
    print(json.dumps({"mode": "verify", "reads": B, "junctions": n_junc,
                      "exact": n_ok, "min_start": min(t[0] for t in truths)}))


def dryrun(args):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from find_circ2_tpu.config import RPAD_CODE, Config
    from find_circ2_tpu.parallel.mesh import make_mesh
    from find_circ2_tpu.parallel.sharded import ShardedEngine

    cfg = Config()
    genome, index = load(args)
    chrom_idx = genome.n_chroms - 1
    # Unique-anchor reads: relocation below 2^31 is IMPOSSIBLE for
    # them, so the >2^31 coordinate check below distinguishes real
    # corruption from the expected multi-mapping of this repetitive
    # genome (the r4 failure mode — see plant_reads docstring).
    reads, truths = plant_reads(genome, cfg, 16, 100, 8, chrom_idx,
                                index=index, unique=True)
    log("oracle calls on the planted reads (ground truth)...")
    from find_circ2_tpu.io.twobit import codes_to_seq
    from find_circ2_tpu.models.oracle import call_read
    oracle_calls = [call_read(genome, index, f"r{i}",
                              codes_to_seq(reads[i]), cfg)
                    for i in range(len(reads))]
    mesh = make_mesh(8)
    tbytes = np.asarray(index.qtable.table).nbytes if index.qtable \
        else 0
    # Memory-budget check (r4 weak #7): sharding the whole-genome table
    # across 8 virtual devices in ONE process transiently needs ~2-3x
    # the table (mmap source + carved shards + stacked padded copy).
    avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    need = 3 * tbytes + len(genome)
    if need > avail:
        log(f"WARNING: estimated peak {need / 2 ** 30:.0f} GiB exceeds "
            f"available RAM {avail / 2 ** 30:.0f} GiB — the dryrun may "
            f"thrash or OOM; free memory or run on a larger host")
    log(f"building ShardedEngine over mesh {dict(mesh.shape)} "
        f"(shards the {tbytes / 2 ** 30:.1f} GiB whole-genome table "
        f"across 8 virtual CPU devices in one process)...")
    eng = ShardedEngine(genome, index, mesh, cfg)
    B = len(reads)
    padded = np.full((B, cfg.max_read_len), RPAD_CODE, np.uint8)
    padded[:, :reads.shape[1]] = reads
    lens = np.full(B, reads.shape[1], np.int32)
    out = eng.detect(padded, lens)
    n_junc = int((out["status"] == 0).sum())
    bad = []
    n_exact = 0
    for i, oc in enumerate(oracle_calls):
        dev = (int(out["status"][i]), int(out["start"][i]),
               int(out["end"][i]))
        want = (oc.status, oc.start if oc.status == 0 else 0,
                oc.end if oc.status == 0 else 0)
        got = (dev[0], dev[1] if dev[0] == 0 else 0,
               dev[2] if dev[0] == 0 else 0)
        if got != want:
            # Unique anchors pin the pair: any oracle/device divergence
            # here IS a bug, not multi-mapping.
            bad.append({"read": i, "truth": truths[i],
                        "oracle": want, "sharded": got})
        elif oc.status == 0 and (oc.start, oc.end) == truths[i]:
            n_exact += 1
        elif oc.status == 0:
            # Same-edit split tie can shift the breakpoint a few bases
            # (frozen tie-break); coordinates stay on the planted
            # locus. Logged, not fatal.
            log(f"read {i}: split tie-shift — planted {truths[i]}, "
                f"called ({oc.start}, {oc.end}) [device==oracle]")
    if bad:
        for b in bad:
            log(f"MISMATCH read {b['read']}: planted {b['truth']}, "
                f"oracle {b['oracle']}, sharded {b['sharded']}")
        raise AssertionError(
            f"{len(bad)}/{B} reads disagree between the sharded device "
            f"step and the oracle (unique anchors: relocation is "
            f"impossible, so this IS a coordinate bug)")
    assert n_junc == B, f"only {n_junc}/{B} unique-anchor junction calls"
    # Unique anchors pin the pair AND the planted split is unique
    # (plant_reads seam inequalities), so exactness is deterministic.
    assert n_exact == B, \
        f"only {n_exact}/{B} at exact planted coordinates"
    min_start = int(out["start"][out["status"] == 0].min())
    if len(genome) > 2 ** 31:
        assert min_start > 2 ** 31, \
            f"junction start {min_start:,} below 2^31 on unique-anchor " \
            f"reads: uint32 coordinate corruption"
    merged = eng.detect_merged(padded, lens)
    n_distinct = int(merged["valid"].sum())
    log(f"sharded detect: {n_junc}/{B} junction reads oracle-identical, "
        f"{n_exact}/{B} at exact planted >2^31 coordinates; "
        f"{n_distinct} distinct junctions after collective merge")
    print(json.dumps({"mode": "dryrun", "mesh": dict(mesh.shape),
                      "junction_reads": n_junc,
                      "distinct_junctions": n_distinct,
                      "all_exact": bool(n_exact == B),
                      "n_exact": n_exact, "min_start": min_start}))


def bench(args):
    """Single-card throughput over the whole-genome index.

    The whole-genome canonical cuckoo table (~8.8 GiB), its neighbor
    table and the ~1.6 GB packed genome are sized against the card's
    own `memory_stats()["bytes_limit"]` before anything is placed
    (bowtie2's FM-index stays ~4 GB because a BWT is succinct; this
    table trades memory for O(1) gather lookups). With --shard-of N > 1
    the bench loads ONE prefix-range shard (1/N of the table) — the
    per-card configuration of an N-card deployment, where per-card
    throughput is this figure and the psum/pmin combine is exercised by
    the 8-device CPU dryrun. Per-card K1 work is identical under
    sharding — every card gathers both probe rows for ALL variants
    against its own shard (unowned keys compare-miss); junction counts
    come out low because off-shard hits would resolve via the other
    shards' psum in a real deployment."""
    import numpy as np
    import jax
    from find_circ2_tpu.config import RPAD_CODE, Config
    from find_circ2_tpu.models.pipeline import (DeviceIndex,
                                                detect_batch_phased)

    cfg = Config()
    genome, index = load(args)
    log(f"device={jax.devices()[0].device_kind}")
    if args.shard_of > 1:
        # Carve shard 0 straight out of the saved full table: every row
        # stores its canonical key (p12 lane 0, s8 in lane 1) and both
        # orientations' payloads, so a prefix-range shard is a filtered
        # re-place — no re-aggregation of the 3G-entry index.
        from find_circ2_tpu.index.hashtable import (CNT_BITS, CNT_MASK,
            LANES, S8_MASK, _build_from_keys)
        log(f"carving shard 0 of {args.shard_of} from the full table...")
        t = time.time()
        nb_range = index.n_buckets // args.shard_of
        tab = np.asarray(index.qtable.table).reshape(-1, LANES)
        keep = (tab[:, 0] >= 0) & (tab[:, 0] < nb_range)
        rows = tab[keep]
        del tab
        packed = rows[:, 1]
        qt_shard = _build_from_keys(
            rows[:, 0], packed & S8_MASK,
            (packed >> 16) & CNT_MASK,
            rows[:, 2].view(np.uint32),
            (packed >> (16 + CNT_BITS)) & CNT_MASK,
            rows[:, 3].view(np.uint32),
            load=0.8, seed=0, max_bucket=cfg.max_bucket)
        log(f"shard carved in {time.time() - t:.0f}s: "
            f"{rows.shape[0]:,} keys, "
            f"{qt_shard.table.nbytes / 2 ** 30:.2f} GiB on the card "
            f"(full table is {args.shard_of}x the keys)")
        del rows
        if os.path.exists(f"{args.workdir}/qnbr.npy"):
            # K1 v4 exact-first at whole-genome scale: the full-table
            # neighbor aggregates (nbuild mode) relocate onto the
            # carved shard (hashtable.shard_neighbor_tables).
            from find_circ2_tpu.index.hashtable import \
                shard_neighbor_tables
            t = time.time()
            index.qtable.ntable = np.load(f"{args.workdir}/qnbr.npy",
                                          mmap_mode="r")
            qt_shard.ntable = shard_neighbor_tables(
                index.qtable, qt_shard.table[None])[0]
            log(f"exact-first: neighbor rows relocated onto the shard "
                f"in {time.time() - t:.0f}s "
                f"({qt_shard.ntable.nbytes / 2 ** 30:.2f} GiB)")
        index.qtable = qt_shard
    # Size against the card itself: table (+ neighbor table, same shape)
    # + the nibble-packed genome must fit its memory.
    qt = index.qtable
    need = qt.table.nbytes * (1 if qt.ntable is None else 2) \
        + genome.codes.size // 2
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    if limit:
        log(f"device footprint {need / 2 ** 30:.2f} GiB of the card's "
            f"{limit / 2 ** 30:.2f} GiB")
        if need > limit:
            raise SystemExit("the index does not fit one card; rerun with "
                             "--shard-of N")
    dindex = DeviceIndex.build(genome, index, cfg,
                               exact_first=(index.qtable.ntable
                                            is not None))
    chrom_idx = genome.n_chroms - 1
    n = args.bench_reads
    Bsz = cfg.batch_size
    n_batches = max(1, n // Bsz)
    # FRESH device-resident batches: re-dispatching one batch would let
    # caches flatter the gather rate.
    reads, _ = plant_reads(genome, cfg, n_batches * Bsz, 100, 9,
                           chrom_idx)
    from find_circ2_tpu.models.pipeline import revcomp_batch
    rds, lds, rcs = [], [], []
    for b in range(n_batches):
        padded = np.full((Bsz, cfg.max_read_len), RPAD_CODE, np.uint8)
        padded[:, :reads.shape[1]] = reads[b * Bsz:(b + 1) * Bsz]
        lens_b = np.full(Bsz, reads.shape[1], np.int32)
        rds.append(jax.device_put(padded))
        lds.append(jax.device_put(lens_b))
        # Host-computed rc ships with the batch (r5: the on-device
        # construction is the slowest op in the core phase).
        rcs.append(jax.device_put(revcomp_batch(padded, lens_b)))
    log(f"compile+warmup ({n_batches} distinct device batches, "
        f"exact_first={dindex.ntable is not None})...")
    out = detect_batch_phased(dindex, rds[0], lds[0], cfg, True,
                              rc=rcs[0])
    jax.block_until_ready(out)
    best = float("inf")
    for ep in range(3):
        t = time.time()
        outs = [detect_batch_phased(dindex, rd, ld, cfg, True, rc=rc)
                for rd, ld, rc in zip(rds, lds, rcs)]
        jax.block_until_ready(outs)
        n_junc = int((np.asarray(outs[-1]["status"]) == 0).sum())
        dt = time.time() - t
        log(f"epoch {ep}: {n_batches * Bsz} reads in {dt:.3f}s -> "
            f"{n_batches * Bsz / dt:,.0f} reads/s")
        best = min(best, dt)
    rps = n_batches * Bsz / best
    log(f"whole-genome bench: {rps:,.0f} reads/s/card "
        f"({n_junc}/{Bsz} junction reads in the last batch)")
    dev = jax.devices()[0]
    print(json.dumps({"mode": "bench", "reads_per_s_per_card": round(rps),
                      "genome_bp": len(genome),
                      "table_gib": round(dindex.table.nbytes / 2 ** 30, 2),
                      "shard_of": args.shard_of, "n_batches": n_batches,
                      "exact_first": dindex.ntable is not None,
                      "device": {"platform": dev.platform,
                                 "device_kind": dev.device_kind,
                                 "count": len(jax.devices())}}))


def nbuild(args):
    """Build + save the K1 v4 neighbor table for the whole-genome index
    (opt-in at this scale: one pass over 474M canonical keys, ~1 h on
    this host; enables the exact-first bench/serving configuration)."""
    import numpy as np
    from find_circ2_tpu.config import Config
    from find_circ2_tpu.index.hashtable import build_neighbor_table

    cfg = Config()
    w = args.workdir
    if os.path.exists(f"{w}/qnbr.npy"):
        log("qnbr.npy already present; nothing to do")
        print(json.dumps({"mode": "nbuild", "cached": True}))
        return
    genome, index = load(args)
    t = time.time()
    nt = build_neighbor_table(index, cfg, log=log)
    np.save(f"{w}/qnbr.npy", nt)
    log(f"neighbor table built+saved in {time.time() - t:.0f}s "
        f"({nt.nbytes / 2 ** 30:.2f} GiB)")
    print(json.dumps({"mode": "nbuild", "seconds": round(time.time() - t),
                      "gib": round(nt.nbytes / 2 ** 30, 2)}))


def fastq(args):
    """Write planted junction reads as a FASTQ for the whole-genome CLI
    end-to-end step: 16 unique-anchor reads (exact
    >2^31 coordinates provable) + regular reads from the last
    chromosome."""
    import numpy as np
    from find_circ2_tpu.config import Config
    from find_circ2_tpu.io.twobit import codes_to_seq

    cfg = Config()
    genome, index = load(args)
    chrom_idx = genome.n_chroms - 1
    ru, _ = plant_reads(genome, cfg, 16, 100, 11, chrom_idx,
                        index=index, unique=True)
    rr, _ = plant_reads(genome, cfg, max(0, args.n_fastq - 16), 100, 12,
                        chrom_idx)
    reads = np.concatenate([ru, rr])
    if args.fastq_out is None:
        args.fastq_out = os.path.join(args.workdir, "reads.fastq")
    with open(args.fastq_out, "w") as f:
        for i in range(reads.shape[0]):
            s = codes_to_seq(reads[i])
            f.write(f"@br{i}\n{s}\n+\n{'I' * len(s)}\n")
    log(f"wrote {reads.shape[0]} reads -> {args.fastq_out}")
    print(json.dumps({"mode": "fastq", "n_reads": int(reads.shape[0]),
                      "path": args.fastq_out}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode",
                    choices=("build", "verify", "dryrun", "bench",
                             "fastq", "nbuild"))
    ap.add_argument("--workdir", default=os.path.join(REPO, ".bigg"))
    ap.add_argument("--total-gbp", type=float, default=3.3)
    ap.add_argument("--core-mbp", type=float, default=300.0)
    ap.add_argument("--mut-rate", type=float, default=0.003)
    ap.add_argument("--n-chroms", type=int, default=22)
    ap.add_argument("--bench-reads", type=int, default=65536)
    ap.add_argument("--shard-of", type=int, default=1,
                    help="bench mode: load 1/N of the table (prefix-"
                    "range shard 0) — the per-card slice of an N-card "
                    "deployment")
    ap.add_argument("--fastq-out", default=None,
                    help="fastq mode output (default WORKDIR/reads.fastq)")
    ap.add_argument("--n-fastq", type=int, default=4096)
    args = ap.parse_args()
    {"build": build, "verify": verify, "dryrun": dryrun,
     "bench": bench, "fastq": fastq, "nbuild": nbuild}[args.mode](args)


if __name__ == "__main__":
    main()
