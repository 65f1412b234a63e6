"""Single-chip device pipeline: the jitted anchor+breakpoint step.

This is the device counterpart of the oracle's `call_read` (SURVEY.md §3.3
call stack), batched and fully static-shaped: K1 (ops/anchor_align) feeds
pair canonicalization, the pass-1 contiguous prefilter (SPEC.md §6), and
K2 (ops/breakpoint). Host code (`run_reads`) buckets/pads reads, streams
batches through the jitted step, and feeds the shared Aggregator — so the
CPU oracle and this path produce byte-identical BED tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from find_circ2_tpu.config import (
    RPAD_CODE,
    Config,
    KIND_CIRCULAR,
    KIND_LINEAR,
    ST_ANCHOR_OVERLAP,
    ST_DIFF_CHROM,
    ST_DIFF_STRAND,
    ST_JUNCTION,
    ST_NO_JUNCTION,
    ST_PREFILTERED,
    ST_TOO_LONG,
    ST_TOO_SHORT,
    ST_UNALIGNED_A,
    ST_UNALIGNED_B,
)
from find_circ2_tpu.index.build import SeedIndex, build_index
from find_circ2_tpu.io.genome import Genome
from find_circ2_tpu.io.twobit import codes_to_seq, seq_to_codes
from find_circ2_tpu.models.oracle import ReadCall
from find_circ2_tpu.ops.anchor_align import (align_anchor_pair,
    align_anchors, read_anchors)
from find_circ2_tpu.ops.breakpoint import breakpoint_search
from find_circ2_tpu.ops.packed import gather_window, pack_nibbles


@dataclass(frozen=True)
class DeviceIndex:
    """Genome + k-mer query table as device arrays (genome nibble-packed,
    table per index/hashtable.py)."""
    gpacked: jax.Array        # uint32 [~G/8], ops/packed.py layout
    nbases: int               # total codes (static for jit)
    table: jax.Array          # int32 [T, SLOTS*LANES] cuckoo table
    meta: jax.Array           # int32 [3] = (salt0, salt1, n_buckets)
    chrom_offsets: jax.Array  # int32 [n_chroms]
    # SPEC §2b extras for device multi-hit (ops/explore.py); None on
    # tables built without extras (host slow path handles multi reads).
    ext: jax.Array | None = None      # uint32 [R, 2*(K-1)]
    ext_id: jax.Array | None = None   # int32 [T, SLOTS]
    # K1 v4 exact-first fast path: precomputed 1-mm-ball aggregates
    # (index/hashtable.build_neighbor_table). None => classic 122-row
    # enumeration K1; results are bit-identical either way.
    ntable: jax.Array | None = None   # int32 [T, SLOTS*NBR_LANES]

    @classmethod
    def build(cls, genome: Genome, index: SeedIndex | None = None,
              cfg: Config = Config(),
              qtable: "QueryTable | None" = None,
              exact_first: bool | None = None) -> "DeviceIndex":
        """`exact_first`: build the K1 v4 neighbor table (4 gathers per
        anchor instead of 122 — docs/DESIGN.md "exact-first K1").
        None (auto) builds it except for genome-scale tables, where the
        one-time aggregation pass costs tens of minutes and should be
        an explicit choice (precompute + cache via
        hashtable.build_neighbor_table and pass exact_first=True)."""
        from find_circ2_tpu.index.hashtable import (build_neighbor_table,
                                                    build_query_table)
        if index is None:
            index = build_index(genome, cfg)
        if len(genome) >= 2 ** 32 - 2 * cfg.chrom_gap:
            raise ValueError("genome must fit uint32 positions "
                             "(< ~4.29 Gbp incl. sentinel gaps)")
        if qtable is None:
            qtable = index.qtable
        if qtable is None:
            qtable = build_query_table(index, cfg)
            index.qtable = qtable
        ntable = getattr(qtable, "ntable", None)
        if ntable is None and (exact_first is True or
                               (exact_first is None
                                and qtable.n_buckets <= 64 << 20)):
            index.qtable = qtable
            ntable = build_neighbor_table(index, cfg)
            qtable.ntable = ntable
        return cls(
            gpacked=jnp.asarray(pack_nibbles(genome.codes)),
            nbases=len(genome),
            table=jnp.asarray(qtable.table),
            meta=jnp.asarray(qtable.meta),
            chrom_offsets=jnp.asarray(
                genome.chrom_offsets.astype(np.uint32)),
            ext=(None if qtable.ext is None else jnp.asarray(qtable.ext)),
            ext_id=(None if qtable.ext_id is None
                    else jnp.asarray(qtable.ext_id)),
            ntable=(None if ntable is None else jnp.asarray(ntable)),
        )


def revcomp_batch(arr: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Host-side left-aligned reverse complement of an encoded batch.

    detect_core needs each read's rc; computing it ON DEVICE is a
    [B, Lp] per-element gather with data-dependent indices. The host
    computes it vectorized instead and ships it with the reads; it
    overlaps device compute exactly like the encode stage. Whether the
    device gather is still the slower choice on the GPU is not
    measured."""
    Lp = arr.shape[1]
    pos = np.arange(Lp, dtype=np.int64)[None, :]
    idx = np.clip(lens[:, None] - 1 - pos, 0, Lp - 1)
    r = np.take_along_axis(arr, idx, axis=1)
    r = np.where(r < 4, 3 - r, r)
    return np.where(pos < lens[:, None], r, RPAD_CODE).astype(np.uint8)


def _full_read_mm(gpacked: jnp.ndarray, nbases: int, query: jnp.ndarray,
                  start: jnp.ndarray, lens: jnp.ndarray) -> jnp.ndarray:
    """Hamming(query[:l], genome[start:start+l]) per row (SPEC.md §6)."""
    B, Lp = query.shape
    pos = jnp.arange(Lp, dtype=jnp.int32)[None, :]
    # uint32 bound: a bare python int above 2^31 (whole-genome nbases)
    # overflows JAX's weak-typed argument parsing.
    win = gather_window(gpacked,
                        jnp.clip(start, jnp.uint32(0),
                                 jnp.uint32(nbases - Lp)), Lp)
    q = query.astype(jnp.int32)
    neq = ((q != win) | (q >= 4) | (win >= 4)) & (pos < lens[:, None])
    return jnp.sum(neq, axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("cfg", "prefilter", "nbases"))
def detect_batch(
    gpacked: jnp.ndarray,
    nbases: int,
    table: jnp.ndarray,        # int32 [T, SLOTS*LANES] k-mer hash table
    meta: jnp.ndarray,         # int32 [3] = (salt0, salt1, n_buckets)
    chrom_offsets: jnp.ndarray,
    reads: jnp.ndarray,        # uint8 [B, Lp], RPAD-padded
    lens: jnp.ndarray,         # int32 [B]; rows with lens==0 are padding
    cfg: Config,
    prefilter: bool = True,
    rc: jnp.ndarray | None = None,
):
    """Full per-batch detection step in ONE jitted program: K1 anchor
    alignment (hash-table lookups), best-hit finalize, pairing +
    prefilter + K2 breakpoint search."""
    anchors_a, anchors_b = read_anchors(reads, lens, cfg)
    hits_a, hits_b = align_anchor_pair(table, meta, anchors_a, anchors_b,
                                       cfg)
    return detect_core(gpacked, nbases, chrom_offsets, reads, lens,
                       hits_a, hits_b, cfg, prefilter, rc=rc)


@partial(jax.jit, static_argnames=("cfg",))
def _align_phase(table, meta, reads, lens, cfg):
    anchors_a, anchors_b = read_anchors(reads, lens, cfg)
    return align_anchor_pair(table, meta, anchors_a, anchors_b, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _align_phase_fast(table, ntable, meta, reads, lens, cfg):
    from find_circ2_tpu.ops.anchor_align import align_anchor_pair_fast
    anchors_a, anchors_b = read_anchors(reads, lens, cfg)
    return align_anchor_pair_fast(table, ntable, meta, anchors_a,
                                  anchors_b, cfg)


@partial(jax.jit, static_argnames=("cfg", "prefilter", "nbases"))
def _core_phase(gpacked, nbases, chrom_offsets, reads, lens, hits_a,
                hits_b, cfg, prefilter, rc=None):
    return detect_core(gpacked, nbases, chrom_offsets, reads, lens,
                       hits_a, hits_b, cfg, prefilter, rc=rc)


def detect_batch_phased(dindex: "DeviceIndex", reads, lens, cfg: Config,
                        prefilter: bool = True, rc=None):
    """Two-program detection step (K1+finalize, then core). Identical
    results to `detect_batch`; kept split so each program stays on XLA's
    fast emitters (docs/DESIGN.md "XLA pitfalls"). Rides the K1 v4
    exact-first align phase when the index carries a neighbor table
    (bench-oriented entry: the rare fallback-overflow batch is NOT
    redone here — the streaming paths handle that; overflow cannot
    occur on error-free bench reads whose anchors all exist)."""
    if dindex.ntable is not None:
        hits_a, hits_b, _ = _align_phase_fast(
            dindex.table, dindex.ntable, dindex.meta, reads, lens, cfg)
    else:
        hits_a, hits_b = _align_phase(dindex.table, dindex.meta, reads,
                                      lens, cfg)
    return _core_phase(dindex.gpacked, dindex.nbases,
                       dindex.chrom_offsets, reads, lens, hits_a, hits_b,
                       cfg, prefilter, rc)


# Column order of the packed per-read result row (host readback format).
PACK_FIELDS = ("status", "kind", "chrom", "start", "end", "sense",
               "align_strand", "edits", "n_bp", "overlap", "qual_left",
               "qual_right", "multi", "signal")


@partial(jax.jit, static_argnames=("cfg", "prefilter", "nbases"))
def detect_batch_packed(gpacked, nbases, table, meta, chrom_offsets,
                        reads, lens, cfg: Config, prefilter: bool = True,
                        rc=None):
    """Full detection step returning ONE int32 [B, 13] array.

    Every host<->device round trip costs a transfer and a wait, so the
    streaming paths fetch one packed array per batch instead of 13
    columns. The 4 signal codes (each < 8) pack into one column as
    s0 | s1<<3 | s2<<6 | s3<<9; unpack with `unpack_results`."""
    anchors_a, anchors_b = read_anchors(reads, lens, cfg)
    hits_a, hits_b = align_anchor_pair(table, meta, anchors_a, anchors_b,
                                       cfg)
    res = detect_core(gpacked, nbases, chrom_offsets, reads, lens,
                      hits_a, hits_b, cfg, prefilter, rc=rc)
    sig = res["signal"].astype(jnp.int32)
    sig_packed = (sig[:, 0] | (sig[:, 1] << 3) | (sig[:, 2] << 6)
                  | (sig[:, 3] << 9))
    cols = [res[k].astype(jnp.int32) for k in PACK_FIELDS[:-1]]
    cols.append(sig_packed)
    return jnp.stack(cols, axis=1)


@partial(jax.jit, static_argnames=("cfg", "prefilter", "nbases"))
def detect_batch_packed_fast(gpacked, nbases, table, ntable, meta,
                             chrom_offsets, reads, lens, cfg: Config,
                             prefilter: bool = True, rc=None):
    """detect_batch_packed on the K1 v4 exact-first align path.

    Bit-identical rows, except the packed `multi` column additionally
    carries a batch-wide overflow flag in bit 3: set when the batch had
    more absent-key anchors than the static enumeration-fallback slice
    (cfg.exact_fallback_slots) — those anchors' fast-path statistics
    are then NOT trustworthy and the caller must redo the batch through
    the classic program (`dispatch_packed` + `redo_if_overflow`)."""
    from find_circ2_tpu.ops.anchor_align import align_anchor_pair_fast
    anchors_a, anchors_b = read_anchors(reads, lens, cfg)
    hits_a, hits_b, overflow = align_anchor_pair_fast(
        table, ntable, meta, anchors_a, anchors_b, cfg)
    res = detect_core(gpacked, nbases, chrom_offsets, reads, lens,
                      hits_a, hits_b, cfg, prefilter, rc=rc)
    res["multi"] = res["multi"] | (overflow.astype(jnp.int32) << 3)
    sig = res["signal"].astype(jnp.int32)
    sig_packed = (sig[:, 0] | (sig[:, 1] << 3) | (sig[:, 2] << 6)
                  | (sig[:, 3] << 9))
    cols = [res[k].astype(jnp.int32) for k in PACK_FIELDS[:-1]]
    cols.append(sig_packed)
    return jnp.stack(cols, axis=1)


def dispatch_packed(dindex: "DeviceIndex", arr, lens, cfg: Config,
                    prefilter: bool = True):
    """Default single-chip packed dispatch for the streaming loops:
    exact-first when the index carries a neighbor table, classic
    otherwise. Pair with `redo_if_overflow` at consume time."""
    rc = jnp.asarray(revcomp_batch(np.asarray(arr), np.asarray(lens)))
    if dindex.ntable is not None:
        return detect_batch_packed_fast(
            dindex.gpacked, dindex.nbases, dindex.table, dindex.ntable,
            dindex.meta, dindex.chrom_offsets, jnp.asarray(arr),
            jnp.asarray(lens), cfg, prefilter, rc=rc)
    return detect_batch_packed(
        dindex.gpacked, dindex.nbases, dindex.table, dindex.meta,
        dindex.chrom_offsets, jnp.asarray(arr), jnp.asarray(lens), cfg,
        prefilter, rc=rc)


def redo_if_overflow(dindex: "DeviceIndex", res: dict, arr, lens,
                     cfg: Config, prefilter: bool = True) -> dict:
    """If the unpacked batch carries the fallback-overflow flag
    (multi bit 3 — see detect_batch_packed_fast), redo it through the
    classic enumeration program and return the replacement results;
    otherwise return `res` unchanged. Synchronous (rare path)."""
    if dindex is None or dindex.ntable is None or arr is None \
            or not (res["multi"] & 8).any():
        return res
    rc = jnp.asarray(revcomp_batch(np.asarray(arr), np.asarray(lens)))
    packed = detect_batch_packed(
        dindex.gpacked, dindex.nbases, dindex.table, dindex.meta,
        dindex.chrom_offsets, jnp.asarray(arr), jnp.asarray(lens), cfg,
        prefilter, rc=rc)
    return unpack_results(np.asarray(packed))


def unpack_results(packed: np.ndarray) -> dict:
    """Host-side inverse of detect_batch_packed's packing."""
    out = {k: packed[:, i] for i, k in enumerate(PACK_FIELDS[:-1])}
    # start/end are uint32 global positions bitcast into the int32 packed
    # array (same itemsize, so .view works on the strided columns).
    out["start"] = out["start"].view(np.uint32)
    out["end"] = out["end"].view(np.uint32)
    sig = packed[:, len(PACK_FIELDS) - 1]
    out["signal"] = np.stack([sig & 7, (sig >> 3) & 7, (sig >> 6) & 7,
                              (sig >> 9) & 7], axis=1).astype(np.uint8)
    return out


def call_from_row(res: dict, i: int, name: str, seq: str) -> ReadCall:
    """One unpacked result row -> ReadCall (oracle-shaped: non-junction
    statuses carry no junction fields)."""
    status = int(res["status"][i])
    if status != ST_JUNCTION:
        return ReadCall(name, seq, status)
    return ReadCall(
        name=name, seq=seq, status=status,
        kind=int(res["kind"][i]),
        chrom_idx=int(res["chrom"][i]),
        start=int(res["start"][i]),
        end=int(res["end"][i]),
        sense=int(res["sense"][i]),
        align_strand=int(res["align_strand"][i]),
        edits=int(res["edits"][i]),
        n_bp=int(res["n_bp"][i]),
        overlap=int(res["overlap"][i]),
        qual_left=int(res["qual_left"][i]),
        qual_right=int(res["qual_right"][i]),
        signal=codes_to_seq(res["signal"][i]),
    )


class DeviceExplorer:
    """Async dispatcher for the device §2b multi-hit path (ops/explore).

    Routed reads of one detect batch are encoded and dispatched through
    `explore_batch_packed` in fixed bucket sizes (static shapes: at most
    len(buckets) compiled programs), so the streaming loops can overlap
    the explore program of batch i with detect of batch i+1 and fetch
    results one stage later. Bit-identical to the host slow path
    (models/multihit) and the oracle — tests/test_explore.py."""

    BUCKETS = (32, 256, 1024)

    def __init__(self, dindex: "DeviceIndex", cfg: Config,
                 prefilter: bool = True):
        if dindex.ext is None or dindex.ext_id is None:
            raise ValueError("DeviceIndex was built without §2b extras "
                             "(extras=False); use the host slow path")
        self.dindex = dindex
        self.cfg = cfg
        self.prefilter = prefilter

    def dispatch(self, items: list[tuple[str, str]]):
        """Async-dispatch routed (name, seq) reads; returns an opaque
        handle for `fetch`. Reads must already be length-valid."""
        cfg = self.cfg
        d = self.dindex
        Lp = cfg.max_read_len
        chunks = []
        for lo in range(0, len(items), self.BUCKETS[-1]):
            part = items[lo:lo + self.BUCKETS[-1]]
            bs = next(b for b in self.BUCKETS if b >= len(part))
            arr = np.full((bs, Lp), RPAD_CODE, np.uint8)
            lens = np.zeros(bs, np.int32)
            for i, (_, seq) in enumerate(part):
                codes = seq_to_codes(seq)
                arr[i, :codes.size] = codes
                lens[i] = codes.size
            from find_circ2_tpu.ops.explore import explore_batch_packed
            packed = explore_batch_packed(
                d.gpacked, d.nbases, d.table, d.meta, d.ext, d.ext_id,
                d.chrom_offsets, jnp.asarray(arr), jnp.asarray(lens),
                cfg, self.prefilter)
            try:
                packed.copy_to_host_async()
            except AttributeError:
                pass
            chunks.append((part, packed))
        return chunks

    def fetch(self, chunks) -> list[ReadCall]:
        """Block on a dispatch handle and return its ReadCalls in order."""
        out = []
        for part, packed in chunks:
            res = unpack_results(np.asarray(packed))
            out.extend(call_from_row(res, i, name, seq)
                       for i, (name, seq) in enumerate(part))
        return out

    def dispatch_arrays(self, arr: np.ndarray, lens: np.ndarray):
        """Array-mode dispatch: routed reads as already-encoded rows
        (uint8 [n, Lp] + int32 [n]) — the streaming loop's batch encode
        is reused instead of re-encoding from strings, and `fetch_arrays`
        returns unpacked result arrays for the vectorized aggregation
        path (Aggregator.add_batch) instead of per-read ReadCalls."""
        cfg = self.cfg
        d = self.dindex
        from find_circ2_tpu.ops.explore import explore_batch_packed
        chunks = []
        for lo in range(0, arr.shape[0], self.BUCKETS[-1]):
            part = arr[lo:lo + self.BUCKETS[-1]]
            n = part.shape[0]
            bs = next(b for b in self.BUCKETS if b >= n)
            rows = np.full((bs, arr.shape[1]), RPAD_CODE, np.uint8)
            rows[:n] = part
            blens = np.zeros(bs, np.int32)
            blens[:n] = lens[lo:lo + n]
            packed = explore_batch_packed(
                d.gpacked, d.nbases, d.table, d.meta, d.ext, d.ext_id,
                d.chrom_offsets, jnp.asarray(rows), jnp.asarray(blens),
                cfg, self.prefilter)
            try:
                packed.copy_to_host_async()
            except AttributeError:
                pass
            chunks.append((n, packed))
        return chunks

    def fetch_arrays(self, chunks) -> dict:
        """Block on a dispatch_arrays handle; returns the unpacked
        result arrays concatenated over chunks (row i = routed read i)."""
        outs = [(n, unpack_results(np.asarray(packed)))
                for n, packed in chunks]
        return {k: np.concatenate([o[k][:n] for n, o in outs])
                for k in outs[0][1]}


def detect_core(gpacked, nbases, chrom_offsets, reads, lens, hits_a,
                hits_b, cfg: Config, prefilter: bool, rc=None):
    """Pairing, prefilter, K2 and status resolution given anchor hits.

    Row status follows the oracle's priority order exactly [FROZEN]:
    prefiltered > unaligned_A > unaligned_B > diff_strand > diff_chrom >
    anchors_overlap > no_junction > junction.

    `rc`: each read's left-aligned reverse complement. Pass the
    host-computed batch (revcomp_batch) on the hot paths — the on-device
    construction below is a data-dependent [B, Lp] gather; it is kept as
    the rc=None fallback so callers without a host-side batch
    (explore-sized paths, legacy entry points) stay correct.
    """
    B, Lp = reads.shape
    a = cfg.anchor_len
    pos_ax = jnp.arange(Lp, dtype=jnp.int32)[None, :]

    if rc is None:
        # Left-aligned reverse complement of each read (a data-dependent
        # gather — see docstring).
        rc_idx = jnp.clip(lens[:, None] - 1 - pos_ax, 0, Lp - 1)
        rc = jnp.take_along_axis(reads, rc_idx, axis=1).astype(jnp.int32)
        rc = jnp.where(rc < 4, 3 - rc, rc)
        rc = jnp.where(pos_ax < lens[:, None], rc,
                       RPAD_CODE).astype(jnp.uint8)

    # --- pass-1 contiguous prefilter (SPEC.md §6) -----------------------
    # All global-position arithmetic stays in uint32 (positions reach
    # ~4.29e9 on whole-genome indexes); mixing in int32 operands would
    # silently promote to int64.
    lens_u = lens.astype(jnp.uint32)
    if prefilter:
        qa = jnp.where((hits_a.strand == 0)[:, None], reads, rc)
        sa = jnp.where(hits_a.strand == 0, hits_a.pos,
                       hits_a.pos + a - lens_u)
        mma = _full_read_mm(gpacked, nbases, qa, sa, lens)
        qb = jnp.where((hits_b.strand == 0)[:, None], reads, rc)
        sb = jnp.where(hits_b.strand == 0, hits_b.pos + a - lens_u,
                       hits_b.pos)
        mmb = _full_read_mm(gpacked, nbases, qb, sb, lens)
        contig = ((hits_a.aligned & (mma <= cfg.prefilter_mm))
                  | (hits_b.aligned & (mmb <= cfg.prefilter_mm)))
    else:
        contig = jnp.zeros(B, bool)

    # --- pairing + canonicalization (SPEC.md §3) ------------------------
    chrom_a = jnp.searchsorted(chrom_offsets, hits_a.pos, side="right") - 1
    chrom_b = jnp.searchsorted(chrom_offsets, hits_b.pos, side="right") - 1
    same_strand = hits_a.strand == hits_b.strand
    same_chrom = chrom_a == chrom_b

    s = hits_a.strand
    minus = (s == 1)
    R = jnp.where(minus[:, None], rc, reads)
    pA = jnp.where(minus, hits_b.pos, hits_a.pos)
    pB = jnp.where(minus, hits_a.pos, hits_b.pos)
    qual_left = jnp.where(minus, hits_b.qual, hits_a.qual)
    qual_right = jnp.where(minus, hits_a.qual, hits_b.qual)
    endB = pB + a

    linear = pA + a <= pB
    circular = endB <= pA
    kind = jnp.where(circular, KIND_CIRCULAR, KIND_LINEAR).astype(jnp.int32)

    # K2: plain XLA is the production (and only) kernel; see
    # ops/breakpoint.py for the prefix-sum formulation.
    bp = breakpoint_search(gpacked, nbases, R, lens, pA, endB,
                           kind, s, cfg)

    # --- status resolution [FROZEN priority] ----------------------------
    status = jnp.full(B, ST_JUNCTION, jnp.int32)
    status = jnp.where(bp["no_junction"], ST_NO_JUNCTION, status)
    status = jnp.where(~(linear | circular), ST_ANCHOR_OVERLAP, status)
    status = jnp.where(~same_chrom, ST_DIFF_CHROM, status)
    status = jnp.where(~same_strand, ST_DIFF_STRAND, status)
    status = jnp.where(~hits_b.aligned, ST_UNALIGNED_B, status)
    status = jnp.where(~hits_a.aligned, ST_UNALIGNED_A, status)
    status = jnp.where(contig, ST_PREFILTERED, status)

    return dict(
        status=status,
        kind=kind,
        chrom=chrom_a.astype(jnp.int32),
        start=bp["start"], end=bp["end"], sense=bp["sense"],
        align_strand=s.astype(jnp.int32),
        edits=bp["edits"], n_bp=bp["n_bp"], overlap=bp["overlap"],
        qual_left=qual_left, qual_right=qual_right,
        # Bit 0 (SPEC §2b): anchor best-hit tie -> host multi-hit re-call
        # (n_best > 1 implies the anchor aligned). Bit 1: rescuable —
        # EXACTLY one anchor unaligned, the §2 2-mm rescue's mate gate;
        # both-anchors-failed reads (junk) keep their device status
        # without a host round trip (the host mate gate would reject
        # them after a full ball-2 re-enumeration anyway).
        multi=(((hits_a.n_best > 1) | (hits_b.n_best > 1)).astype(jnp.int32)
               | ((hits_a.aligned ^ hits_b.aligned).astype(jnp.int32) << 1)),
        signal=bp["signal"],
    )


def run_reads(dindex: DeviceIndex | None, reads, cfg: Config = Config(),
              prefilter: bool = True, batch_size: int | None = None,
              journal=None, times=None, pipeline_depth: int = 2,
              slowpath=None, dispatch=None, explore: bool | None = None,
              redo=None):
    """Host streaming loop: batch reads, run the device step, yield
    ReadCalls. `reads` is an iterable of (name, seq).

    Dispatch is pipelined `pipeline_depth` batches deep: the packed
    result of batch i is fetched (one round trip, detect_batch_packed)
    while batch i+1 computes, so readback latency overlaps device work —
    results are still consumed strictly in order.

    `slowpath` = (genome, index) enables SPEC §2b multi-hit pairing:
    reads the device flags as multi are re-called through pair
    exploration. Without it, multi reads keep their single-best device
    result (v2 semantics; tests that pin v2 behavior rely on this). HOW
    §2b is computed is chosen by `explore`: None (auto) uses the device
    program (ops/explore.py) when the index carries §2b extras, else the
    vectorized host path (models/multihit.py); True forces the device
    (error without extras); False forces the host. All three are
    bit-identical (tests/test_explore.py, tests/test_multihit.py).

    `dispatch(arr[bs, Lp] uint8, lens[bs] int32) -> packed device array`
    overrides the single-chip device step — the sharded engine plugs its
    collective step in here (parallel.sharded.ShardedEngine
    .dispatch_packed), so single-chip and sharded runs share one
    streaming loop byte for byte.

    With a `journal` (utils.journal.RunJournal), completed batches replay
    from disk and only unprocessed batches hit the device — the resume
    path of SURVEY.md §5. `times` (utils.profiling.StageTimes) collects
    per-stage wall time.
    """
    import contextlib
    from collections import deque

    bs = batch_size or cfg.batch_size
    Lp = cfg.max_read_len
    buf: list[tuple[str, str]] = []
    out: list[ReadCall] = []
    done = journal.completed_batches() if journal is not None else {}
    batch_id = 0
    inflight: deque = deque()   # (batch_id, records, packed device array)
    explorer = None
    if explore is None:
        explore = (slowpath is not None and dindex is not None
                   and dindex.ext is not None)
    if explore:
        explorer = DeviceExplorer(dindex, cfg, prefilter)
    # Stage 2: batches whose routed reads await explore results.
    # (batch_id, batch_calls-with-None-slots, route_slots, handle)
    finishing: deque = deque()

    def timed(name):
        return times.stage(name) if times is not None \
            else contextlib.nullcontext()

    def finalize():
        this_id, batch_calls, route_slots, handle = finishing.popleft()
        if handle is not None:
            with timed("explore_multihit"):
                calls = explorer.fetch(handle)
            for slot, call in zip(route_slots, calls):
                batch_calls[slot] = call
        if journal is not None and this_id is not None:
            journal.record(this_id, batch_calls)
        if times is not None and this_id is not None:
            times.add_reads(len(batch_calls))
        out.extend(batch_calls)

    def consume():
        this_id, records, packed, arr, blens = inflight.popleft()
        if packed is None:          # journal replay / loose ReadCalls
            finishing.append((None, records, (), None))
        else:
            with timed("device_detect"):
                res = unpack_results(np.asarray(packed))
                # K1 v4 fallback overflow (multi bit 3): redo the batch
                # through the classic program — the sharded engine's
                # via `redo`, the single-chip one via the index.
                if redo is not None and (res["multi"] & 8).any():
                    res = unpack_results(np.asarray(redo(arr, blens)))
                else:
                    res = redo_if_overflow(dindex, res, arr, blens,
                                           cfg, prefilter)
            batch_calls: list[ReadCall] = []
            route_slots: list[int] = []
            routed: list[tuple[str, str]] = []
            rescue_slots: list[int] = []
            rescued: list[tuple[str, str]] = []
            for i, (name, seq) in enumerate(records):
                status = int(res["status"][i])
                if (slowpath is not None and cfg.rescue_anchor_mm >= 2
                        and status in (ST_UNALIGNED_A, ST_UNALIGNED_B)
                        and res["multi"][i] & 2):
                    # §2 2-mm anchor rescue [FROZEN v4]: host re-call
                    # with the widened ball (precedence over explore —
                    # the device program knows only the <=1-mm ball).
                    # Gated on the device rescuable bit: only reads
                    # whose MATE anchor aligned can pass the host's
                    # mate gate, so both-failed reads skip the trip.
                    # Batched: one vectorized host program per batch.
                    rescue_slots.append(len(batch_calls))
                    rescued.append((name, seq))
                    batch_calls.append(None)
                    continue
                if (slowpath is not None or explore) \
                        and res["multi"][i] & 1 \
                        and status != ST_PREFILTERED:
                    # SPEC §2b: anchor best-hit tie -> pair exploration.
                    if explorer is not None:
                        route_slots.append(len(batch_calls))
                        routed.append((name, seq))
                        batch_calls.append(None)
                        continue
                    from find_circ2_tpu.models.multihit import \
                        call_read_multi
                    with timed("slowpath_multihit"):
                        batch_calls.append(call_read_multi(
                            slowpath[0], slowpath[1], name, seq, cfg,
                            prefilter))
                    continue
                batch_calls.append(call_from_row(res, i, name, seq))
            if rescued:
                from find_circ2_tpu.models.multihit import \
                    call_reads_multi_batch
                with timed("slowpath_rescue"):
                    calls = call_reads_multi_batch(
                        slowpath[0], slowpath[1], rescued, cfg,
                        prefilter)
                for slot, call in zip(rescue_slots, calls):
                    batch_calls[slot] = call
            handle = None
            if routed:
                with timed("explore_dispatch"):
                    handle = explorer.dispatch(routed)
            finishing.append((this_id, batch_calls, route_slots, handle))
        # Keep one explore-pending batch in flight so its program
        # overlaps the next detect batch.
        while len(finishing) > 1:
            finalize()

    def flush():
        nonlocal batch_id
        if not buf:
            return
        this_id = batch_id
        batch_id += 1
        if this_id in done:
            replay = done[this_id]
            if len(replay) != len(buf):
                raise ValueError(
                    f"journal batch {this_id} has {len(replay)} calls, "
                    f"input has {len(buf)}: input changed since journal")
            inflight.append((this_id, replay, None, None, None))
            buf.clear()
            if len(inflight) > pipeline_depth:
                consume()
            return
        arr = np.full((bs, Lp), RPAD_CODE, dtype=np.uint8)
        lens = np.zeros(bs, np.int32)
        with timed("encode"):
            for i, (_, seq) in enumerate(buf):
                codes = seq_to_codes(seq)
                arr[i, :codes.size] = codes
                lens[i] = codes.size
        with timed("device_dispatch"):
            if dispatch is not None:
                packed = dispatch(arr, lens)
            else:
                packed = dispatch_packed(dindex, arr, lens, cfg,
                                         prefilter)
            try:
                packed.copy_to_host_async()
            except AttributeError:
                pass
        inflight.append((this_id, list(buf), packed, arr, lens))
        buf.clear()
        if len(inflight) > pipeline_depth:
            consume()

    def loose(call: ReadCall):
        # Skipped reads keep their arrival position relative to batch
        # results by riding the same FIFO (coalesced when consecutive).
        if inflight and inflight[-1][0] is None:
            inflight[-1][1].append(call)
        else:
            inflight.append((None, [call], None, None, None))

    for name, seq in reads:
        if len(seq) < 2 * cfg.anchor_len:
            loose(ReadCall(name, seq, ST_TOO_SHORT))
            continue
        if len(seq) > cfg.max_read_len:
            loose(ReadCall(name, seq, ST_TOO_LONG))
            continue
        buf.append((name, seq))
        if len(buf) == bs:
            flush()
    flush()
    while inflight:
        consume()
    while finishing:
        finalize()
    return out
