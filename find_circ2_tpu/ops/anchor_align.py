"""K1 v3: batched anchor alignment by neighborhood-enumerated exact
20-mer search — the device replacement for the reference's bowtie2
anchor pass (SURVEY.md §3.4; SPEC.md §2 freezes the exact contract).

Per anchor and strand, every 20-mer within Hamming distance A_MM (=1) of
the query is enumerated (1 + 3a = 61 variants) and resolved *exactly* in
the k-mer hash table (index/hashtable.py), whose slots carry the
pre-aggregated (count, first_pos) of each distinct 20-mer. Each indexed
position matches exactly one variant, so candidates are disjoint by
construction, every candidate's mismatch count equals its variant's
enumeration distance, and K1 touches no genome sequence at all: per-anchor
statistics are pure range arithmetic over TWO bucket-row gathers per
variant (v2 did ~11 dependent gather passes of binary search, and each
random gather pass over a device-memory table costs about the same
whatever the row width). Shapes stay flat ([B, 2*V]).

Positions are uint32 global coordinates (genomes < 2^32 — whole human
genome scale; the table's int32 lanes carry the uint32 bit pattern).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from find_circ2_tpu.config import Config

# numpy scalars, not jnp: module-level jnp constants initialize the
# XLA backend at import time, which breaks jax.distributed.initialize
# in multi-process CLI runs (it must run before any backend touch).
LARGE_MM = np.int32(255)
LARGE_POS = np.uint32(2 ** 32 - 1)


def read_anchors(reads: jnp.ndarray, lens: jnp.ndarray, cfg: Config):
    """Anchor A = first a bases; anchor B = last a bases (per true len)."""
    a = cfg.anchor_len
    Lp = reads.shape[1]
    anchors_a = reads[:, :a]
    idxb = jnp.clip(lens[:, None] - a, 0, Lp - a) + jnp.arange(a)[None, :]
    anchors_b = jnp.take_along_axis(reads, idxb, axis=1)
    return anchors_a, anchors_b


class AnchorHits(NamedTuple):
    aligned: jnp.ndarray    # bool [B]
    pos: jnp.ndarray        # uint32 [B] global anchor start of best hit
    strand: jnp.ndarray     # int32 [B] 0/1
    mm: jnp.ndarray         # int32 [B]
    n_best: jnp.ndarray     # int32 [B]
    second_mm: jnp.ndarray  # int32 [B]
    qual: jnp.ndarray       # int32 [B]


def enumerate_variants(anchors: jnp.ndarray, cfg: Config):
    """All <=A_MM-mismatch 20-mer variants of each anchor, as paired
    forward/reverse-complement keys.

    anchors: uint8 [B, a]. Returns (p12, s8, p12r, s8r, valid), each
    int32 [B, V] with V = 1 + 3a: the exact forward query then 3
    substitutions at each of the a positions; (p12r, s8r) is the reverse
    complement of the same variant. The '-' strand variant set of SPEC.md
    §2 is exactly {rc(v)} of these (reverse complement commutes with
    single substitutions), so one canonical lookup per forward variant
    serves both strands. Anchors containing any code >= 4 are wholly
    invalid [FROZEN v2].

    The rc keys cost no extra enumeration: rc(kmer) = sum_j (3 - q_j) *
    4^j, so they are the same weighted digit sums with mirrored weights,
    and a substitution delta at position j moves the rc key by -delta *
    wr[j].
    """
    B, a = anchors.shape
    pk = cfg.prefix_len
    sk = a - pk

    anc = anchors.astype(jnp.int32)
    clean = jnp.all(anc < 4, axis=-1, keepdims=True)    # [B, 1]
    qc = jnp.where(anc < 4, anc, 0)

    j = jnp.arange(a)
    # Forward weights: digit j has place value 4^(a-1-j).
    wp = jnp.where(j < pk, 4 ** (pk - 1 - j), 0).astype(jnp.int32)
    ws = jnp.where(j >= pk, 4 ** jnp.clip(a - 1 - j, 0, sk - 1),
                   0).astype(jnp.int32)
    # Reverse-complement weights: digit j lands at rc place value 4^j,
    # which belongs to the rc prefix iff j >= a - pk.
    wpr = jnp.where(j >= a - pk, 4 ** jnp.clip(j - (a - pk), 0, pk - 1),
                    0).astype(jnp.int32)
    wsr = jnp.where(j < a - pk, 4 ** jnp.clip(j, 0, sk - 1),
                    0).astype(jnp.int32)

    base_p12 = jnp.sum(qc * wp, axis=-1, keepdims=True)     # [B, 1]
    base_s8 = jnp.sum(qc * ws, axis=-1, keepdims=True)
    base_p12r = jnp.sum((3 - qc) * wpr, axis=-1, keepdims=True)
    base_s8r = jnp.sum((3 - qc) * wsr, axis=-1, keepdims=True)

    # Substitutions: position j, r in {1,2,3}: b = (q_j + r) % 4.
    r = jnp.arange(1, 4, dtype=jnp.int32)
    delta = ((qc[..., None] + r) % 4) - qc[..., None]       # [B, a, 3]
    d = delta.reshape(B, 3 * a)
    wp_r3 = jnp.repeat(wp, 3)
    ws_r3 = jnp.repeat(ws, 3)
    wpr_r3 = jnp.repeat(wpr, 3)
    wsr_r3 = jnp.repeat(wsr, 3)

    def keys(base, w, sign):
        return jnp.concatenate([base, base + sign * d * w[None, :]],
                               axis=-1)                     # [B, V]

    p12 = keys(base_p12, wp_r3, 1)
    s8 = keys(base_s8, ws_r3, 1)
    p12r = keys(base_p12r, wpr_r3, -1)
    s8r = keys(base_s8r, wsr_r3, -1)
    valid = jnp.broadcast_to(clean, p12.shape)
    return p12, s8, p12r, s8r, valid


def variant_metadata(cfg: Config):
    """Static per-variant (mm, strand) patterns, shape [2V].

    Kept 1-D and reconstructed wherever needed (broadcast later):
    materializing them at [B, 2V] — or even routing them between jitted
    programs as outputs/inputs — makes XLA constant-fold large literals
    into executables, which is catastrophic for compile time and runtime.
    """
    a = cfg.anchor_len
    V = 1 + 3 * a
    mm_one = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.ones((3 * a,), jnp.int32)])
    mm_v = jnp.tile(mm_one, 2)
    strand_v = jnp.repeat(jnp.arange(2, dtype=jnp.int32), V)
    return mm_v, strand_v


def candidate_stats(
    table: jnp.ndarray,        # int32 [T_pad, SLOTS*LANES] cuckoo table
    meta: jnp.ndarray,         # int32 [3] = (salt0, salt1, n_buckets)
    anchors: jnp.ndarray,      # uint8 [B, a]
    cfg: Config,
    ext: jnp.ndarray | None = None,      # uint32 [R, 2*(K-1)] §2b extras
    ext_id: jnp.ndarray | None = None,   # int32 [T_pad, SLOTS]
):
    """Per-variant (count, first_pos) plus static (mm, strand) metadata.

    Returns (count, first_pos) of shape [B, 2V] (first V slots: '+'
    strand variants in enumeration order; last V: their reverse
    complements — a permutation of the '-' strand variant set with
    identical per-variant statistics, so finalize_hits' order-invariant
    reductions are bit-identical to direct enumeration) and (mm_v,
    strand_v) of shape [2V]. Each distinct canonical k-mer lives in
    exactly one shard's table (range partition, index/hashtable
    .shard_query_table), so with sharded tables unowned/absent variants
    naturally return count 0 and cross-shard combination is psum(count) /
    pmin(first_pos) (SPEC.md §2).

    Two 32-byte bucket-row gathers per canonical variant — each serving
    BOTH strand slots; key comparison is exact, so the hash is never
    probabilistic.

    With `ext`/`ext_id` (SPEC §2b device multi-hit, ops/explore.py), a
    fifth return value `extras` (uint32 [B, 2V, K-1]) carries each
    strand-slot's positions 2..K of its variant's hit list (LARGE_POS
    padded) — two extra small gathers per variant (the slot's ext row id,
    then its fixed-width positions row), paid only by the explore path.
    """
    from find_circ2_tpu.index.hashtable import (CNT_BITS, CNT_MASK, LANES,
        S8_MASK, SLOTS, mix_hash)
    LPOS = LARGE_POS

    p12, s8, p12r, s8r, valid = enumerate_variants(anchors, cfg)
    B, V = p12.shape
    # Canonical key = lexicographic min of (fw, rc); swap marks rc-canon.
    swap = (p12r < p12) | ((p12r == p12) & (s8r < s8))
    cp = jnp.where(swap, p12r, p12)
    cs = jnp.where(swap, s8r, s8)

    n_buckets = meta[2].astype(jnp.uint32)
    salt0 = meta[0].astype(jnp.uint32)
    salt1 = meta[1].astype(jnp.uint32)
    up = cp.astype(jnp.uint32)
    us = cs.astype(jnp.uint32)

    want_ext = ext is not None

    def probe(salt):
        # Per-probe partial stats, reduced immediately so XLA fuses the
        # unpack into the gather consumer. Slot layout: hashtable.LANES.
        h = (mix_hash(up, us, salt) % n_buckets).astype(jnp.int32)
        g = jnp.take(table, h, axis=0).reshape(B, V, SLOTS, LANES)
        packed = g[..., 1]
        m = (g[..., 0] == cp[..., None]) & ((packed & S8_MASK)
                                            == cs[..., None])
        cf = (packed >> 16) & CNT_MASK
        cr = (packed >> (16 + CNT_BITS)) & CNT_MASK
        # Position lanes are uint32 bit patterns in the int32 table;
        # signed->unsigned convert wraps mod 2^32 (a bitcast), restoring
        # the true global position and its unsigned order for the mins.
        pf_lane = g[..., 2].astype(jnp.uint32)
        pr_lane = g[..., 3].astype(jnp.uint32)
        if want_ext:
            # ext row id of the matching slot (0 = none): a key lives in
            # at most one slot, so the masked sum is exact.
            eg = jnp.take(ext_id, h, axis=0)              # [B, V, SLOTS]
            rid = jnp.sum(jnp.where(m, eg, 0), axis=-1)
        else:
            rid = None
        return (jnp.sum(jnp.where(m, cf, 0), axis=-1),
                jnp.min(jnp.where(m, pf_lane, LPOS), axis=-1),
                jnp.sum(jnp.where(m, cr, 0), axis=-1),
                jnp.min(jnp.where(m, pr_lane, LPOS), axis=-1),
                rid)

    # A key lives in at most one of its two buckets: sums add a zero,
    # mins a LARGE_POS, so combining partials is exact.
    cf1, pf1, cr1, pr1, rid1 = probe(salt0)
    cf2, pf2, cr2, pr2, rid2 = probe(salt1)
    cnt_f = cf1 + cf2
    pos_f = jnp.minimum(pf1, pf2)
    cnt_r = cr1 + cr2
    pos_r = jnp.minimum(pr1, pr2)

    # '+' slots take the variant's own orientation, '-' slots its rc.
    count = jnp.concatenate([jnp.where(swap, cnt_r, cnt_f),
                             jnp.where(swap, cnt_f, cnt_r)], axis=1)
    first_pos = jnp.concatenate([jnp.where(swap, pos_r, pos_f),
                                 jnp.where(swap, pos_f, pos_r)], axis=1)
    valid2 = jnp.concatenate([valid, valid], axis=1)
    count = jnp.where(valid2, count, 0)
    # Repetitive-20-mer guard [FROZEN].
    count = jnp.where(count > cfg.max_bucket, 0, count)
    # NOTE: first_pos is LARGE_POS where count == 0 — safe for both the
    # single-shard argmin and the sharded pmin.
    mm_v, strand_v = variant_metadata(cfg)
    if not want_ext:
        return count, first_pos, mm_v, strand_v
    K1 = cfg.max_pair_hits - 1
    rows = jnp.take(ext, rid1 + rid2, axis=0)       # [B, V, 2*(K-1)]
    extras_f, extras_r = rows[..., :K1], rows[..., K1:]
    # '+' slots take the variant's own orientation, '-' slots its rc —
    # the same swap as count/first_pos above.
    sw = swap[..., None]
    extras = jnp.concatenate([jnp.where(sw, extras_r, extras_f),
                              jnp.where(sw, extras_f, extras_r)], axis=1)
    return count, first_pos, mm_v, strand_v, extras


def _fold_min(x: jnp.ndarray) -> jnp.ndarray:
    """Log-depth min over the last axis via elementwise minimum chains.

    Avoids a reduce op: an XLA backend this was first tuned on demoted
    gathers whose outputs feed axis reductions to a scalar loop emitter
    (docs/DESIGN.md "XLA pitfalls"); pairwise elementwise minimum keeps
    the vector emitter. Whether the GPU backend needs this is not
    measured; results are identical either way.
    """
    n = x.shape[-1]
    while n > 1:
        half = n // 2
        lo = x[..., :half]
        hi = x[..., half:2 * half]
        tail = x[..., 2 * half:n]
        x = jnp.concatenate([jnp.minimum(lo, hi), tail], axis=-1)
        n = half + (n - 2 * half)
    return x[..., 0]


def finalize_hits(count, first_pos, mm_v, strand_v, cfg: Config,
                  axis_name: str | None = None) -> AnchorHits:
    """Frozen lexicographic best-hit selection + MAPQ surrogate (SPEC §2).

    With `axis_name`, per-shard partial (count, first_pos) are combined
    with psum/pmin collectives first — integer statistics, bit-identical
    to the single-shard result.

    Exploits the enumeration structure: mm values are only 0 (the two
    exact variants, slots 0 and V) or 1 (everything else), so every
    reduction except the final position-min becomes a slice or an
    f32 ones-dot (exact for counts << 2^24) — keeping axis reductions
    away from gather outputs (docs/DESIGN.md).
    """
    a = cfg.anchor_len
    if axis_name is not None:
        # Mask empty slots before the cross-shard min: another shard may
        # own the variant and hold the true (larger-pos) range.
        first_pos = jnp.where(count > 0, first_pos, LARGE_POS)
        count = jax.lax.psum(count, axis_name)
        first_pos = jax.lax.pmin(first_pos, axis_name)

    V2 = count.shape[1]
    V = V2 // 2
    ones = jnp.ones((V2,), jnp.float32)
    cf = count.astype(jnp.float32)

    exact_p = count[:, 0]
    exact_m = count[:, V]
    n_exact = exact_p + exact_m
    total = jnp.dot(cf, ones).astype(jnp.int32)

    any_exact = n_exact > 0
    any_at_all = total > 0
    m0 = jnp.where(any_exact, 0,
                   jnp.where(any_at_all, 1, LARGE_MM)).astype(jnp.int32)

    # n_best: total count at m0.
    n_best = jnp.where(any_exact, n_exact, total).astype(jnp.int32)

    # strand_best: first strand having a hit at m0.
    half_p = jnp.dot(cf[:, :V], ones[:V]).astype(jnp.int32)
    has_p_at_m0 = jnp.where(any_exact, exact_p > 0, half_p > 0)
    strand_best = jnp.where(has_p_at_m0, 0,
                            jnp.where(any_at_all, 1, 2)).astype(jnp.int32)

    # pos_best: min first_pos among (nonempty, mm == m0, strand == best).
    mm_row = mm_v[None, :]
    strand_row = strand_v[None, :]
    sel = ((count > 0) & (mm_row == m0[:, None])
           & (strand_row == strand_best[:, None]))
    pos_best = _fold_min(jnp.where(sel, first_pos, LARGE_POS))

    # second_mm: with mm in {0,1}: if n_best > 1 it's m0; else the only
    # other observable value in the ball is 1 (a non-best non-empty
    # 1-mm variant exists iff total > n_exact when m0 == 0), else a+1.
    second_mm = jnp.where(
        n_best > 1, m0,
        jnp.where((m0 == 0) & (total > n_exact), 1, a + 1)
    ).astype(jnp.int32)

    qual = jnp.where(n_best > 1, 0,
                     jnp.minimum(40, 10 * (second_mm - m0)))
    aligned = m0 <= cfg.max_anchor_mm
    return AnchorHits(aligned=aligned, pos=pos_best, strand=strand_best,
                      mm=m0, n_best=n_best, second_mm=second_mm,
                      qual=qual)


def exact_anchor_stats(table, ntable, meta, anchors, cfg: Config,
                       axis_name: str | None = None):
    """K1 v4 fast path: frozen SPEC §2 per-anchor statistics from the
    EXACT canonical key alone — 4 row gathers per anchor instead of the
    122-row variant enumeration (docs/DESIGN.md "exact-first K1").

    Works because the query table's slot carries both orientations'
    exact (count, first_pos) and `ntable` (index/hashtable
    .build_neighbor_table) carries the guard-filtered 1-mm-ball
    aggregates (S1, minpos1) per orientation — everything
    finalize_hits derives from the enumeration, precomputed at build
    time. Returns (AnchorHits [B], resolved bool [B]): resolved=False
    means the anchor's 20-mer is ABSENT from the table in both
    orientations (typically a sequencing error) and the caller must run
    the enumeration fallback for it; dirty anchors (code >= 4) resolve
    to the enumeration's empty statistics directly."""
    from find_circ2_tpu.index.hashtable import (CNT_BITS, CNT_MASK, LANES,
        NBR_LANES, S8_MASK, SLOTS, mix_hash)
    LPOS = LARGE_POS
    B, a = anchors.shape
    pk = cfg.prefix_len
    sk = a - pk

    anc = anchors.astype(jnp.int32)
    clean = jnp.all(anc < 4, axis=-1)
    qc = jnp.where(anc < 4, anc, 0)
    j = jnp.arange(a)
    wp = jnp.where(j < pk, 4 ** jnp.clip(pk - 1 - j, 0, pk - 1),
                   0).astype(jnp.int32)
    ws = jnp.where(j >= pk, 4 ** jnp.clip(a - 1 - j, 0, sk - 1),
                   0).astype(jnp.int32)
    wpr = jnp.where(j >= a - pk, 4 ** jnp.clip(j - (a - pk), 0, pk - 1),
                    0).astype(jnp.int32)
    wsr = jnp.where(j < a - pk, 4 ** jnp.clip(j, 0, sk - 1),
                    0).astype(jnp.int32)
    p12 = jnp.sum(qc * wp, axis=-1)
    s8 = jnp.sum(qc * ws, axis=-1)
    p12r = jnp.sum((3 - qc) * wpr, axis=-1)
    s8r = jnp.sum((3 - qc) * wsr, axis=-1)
    swap = (p12r < p12) | ((p12r == p12) & (s8r < s8))
    cp = jnp.where(swap, p12r, p12)
    cs = jnp.where(swap, s8r, s8)

    n_buckets = meta[2].astype(jnp.uint32)
    up = cp.astype(jnp.uint32)
    us = cs.astype(jnp.uint32)

    def probe(salt):
        h = (mix_hash(up, us, salt) % n_buckets).astype(jnp.int32)
        g = jnp.take(table, h, axis=0).reshape(B, SLOTS, LANES)
        n = jnp.take(ntable, h, axis=0).reshape(B, SLOTS, NBR_LANES)
        packed = g[..., 1]
        m = (g[..., 0] == cp[..., None]) & ((packed & S8_MASK)
                                            == cs[..., None])
        cf = (packed >> 16) & CNT_MASK
        cr = (packed >> (16 + CNT_BITS)) & CNT_MASK
        pf = g[..., 2].astype(jnp.uint32)
        pr = g[..., 3].astype(jnp.uint32)
        s1f = n[..., 0]
        m1f = n[..., 1].astype(jnp.uint32)
        s1r = n[..., 2]
        m1r = n[..., 3].astype(jnp.uint32)

        def msum(x):
            return jnp.sum(jnp.where(m, x, 0), axis=-1)

        def mmin(x):
            return jnp.min(jnp.where(m, x, LPOS), axis=-1)

        return (m.any(axis=-1), msum(cf), mmin(pf), msum(cr), mmin(pr),
                msum(s1f), mmin(m1f), msum(s1r), mmin(m1r))

    f1 = probe(meta[0].astype(jnp.uint32))
    f2 = probe(meta[1].astype(jnp.uint32))
    found = f1[0] | f2[0]
    cf_t = f1[1] + f2[1]
    pf_t = jnp.minimum(f1[2], f2[2])
    cr_t = f1[3] + f2[3]
    pr_t = jnp.minimum(f1[4], f2[4])
    s1f_t = f1[5] + f2[5]
    m1f_t = jnp.minimum(f1[6], f2[6])
    s1r_t = f1[7] + f2[7]
    m1r_t = jnp.minimum(f1[8], f2[8])

    if axis_name is not None:
        # Cross-index-shard combine: a canonical key lives on exactly
        # one prefix-range shard (its neighbor aggregates were built
        # from the FULL table before sharding, so they are global);
        # non-owners contribute 0 counts / LARGE positions. Integer
        # psum/pmin — bit-identical to the single-shard result.
        found = jax.lax.psum(found.astype(jnp.int32), axis_name) > 0
        cf_t = jax.lax.psum(cf_t, axis_name)
        cr_t = jax.lax.psum(cr_t, axis_name)
        s1f_t = jax.lax.psum(s1f_t, axis_name)
        s1r_t = jax.lax.psum(s1r_t, axis_name)
        pf_t = jax.lax.pmin(pf_t, axis_name)
        pr_t = jax.lax.pmin(pr_t, axis_name)
        m1f_t = jax.lax.pmin(m1f_t, axis_name)
        m1r_t = jax.lax.pmin(m1r_t, axis_name)

    # Repetitive-20-mer guard [FROZEN] on the exact counts (neighbor
    # aggregates are guard-filtered at build).
    cf_t = jnp.where(cf_t > cfg.max_bucket, 0, cf_t)
    cr_t = jnp.where(cr_t > cfg.max_bucket, 0, cr_t)
    usable = found & clean
    zero = jnp.int32(0)
    cf_t = jnp.where(usable, cf_t, zero)
    cr_t = jnp.where(usable, cr_t, zero)
    s1f_t = jnp.where(usable, s1f_t, zero)
    s1r_t = jnp.where(usable, s1r_t, zero)

    # Orientation swap: the '+' query takes the canonical key's own
    # lanes when swap is False, its rc lanes when True (exactly as
    # candidate_stats).
    exact_p = jnp.where(swap, cr_t, cf_t)
    exact_m = jnp.where(swap, cf_t, cr_t)
    posx_p = jnp.where(swap, pr_t, pf_t)
    posx_m = jnp.where(swap, pf_t, pr_t)
    s1_p = jnp.where(swap, s1r_t, s1f_t)
    s1_m = jnp.where(swap, s1f_t, s1r_t)
    mp1_p = jnp.where(swap, m1r_t, m1f_t)
    mp1_m = jnp.where(swap, m1f_t, m1r_t)

    # finalize_hits' frozen formulas, specialized to the two-level
    # (exact, 1-mm-aggregate) decomposition.
    n_exact = exact_p + exact_m
    total = n_exact + s1_p + s1_m
    any_exact = n_exact > 0
    any_at_all = total > 0
    m0 = jnp.where(any_exact, 0,
                   jnp.where(any_at_all, 1, LARGE_MM)).astype(jnp.int32)
    n_best = jnp.where(any_exact, n_exact, total).astype(jnp.int32)
    has_p_at_m0 = jnp.where(any_exact, exact_p > 0, s1_p > 0)
    strand_best = jnp.where(has_p_at_m0, 0,
                            jnp.where(any_at_all, 1, 2)).astype(jnp.int32)
    pos_exact = jnp.where((strand_best == 0) & (exact_p > 0), posx_p,
                          jnp.where((strand_best == 1) & (exact_m > 0),
                                    posx_m, LPOS))
    pos_1mm = jnp.where(strand_best == 0, mp1_p,
                        jnp.where(strand_best == 1, mp1_m, LPOS))
    pos_best = jnp.where(m0 == 0, pos_exact,
                         jnp.where(m0 == 1, pos_1mm, LPOS))
    second_mm = jnp.where(
        n_best > 1, m0,
        jnp.where((m0 == 0) & (total > n_exact), 1, a + 1)
    ).astype(jnp.int32)
    qual = jnp.where(n_best > 1, 0,
                     jnp.minimum(40, 10 * (second_mm - m0)))
    aligned = m0 <= cfg.max_anchor_mm
    hits = AnchorHits(aligned=aligned, pos=pos_best, strand=strand_best,
                      mm=m0, n_best=n_best, second_mm=second_mm,
                      qual=qual)
    resolved = found | ~clean
    return hits, resolved


def align_anchor_pair_fast(table, ntable, meta, anchors_a, anchors_b,
                           cfg: Config, axis_name: str | None = None):
    """K1 v4: exact-first anchor alignment with an in-program
    enumeration fallback for absent-key anchors.

    The fallback compacts unresolved anchors to the front
    (stable argsort of the resolved mask) and runs the classic
    enumeration on a STATIC `cfg.exact_fallback_slots`-anchor slice —
    results scatter back over the fast-path rows (re-enumerated
    resolved anchors produce bit-identical statistics, so the
    unconditional scatter is safe). Returns (hits_a, hits_b, overflow):
    `overflow` (scalar bool) is True when more anchors were unresolved
    than the fallback slice holds — the caller must redo the batch on
    the classic path (pipeline routes this; rare outside junk-dominated
    libraries)."""
    B = anchors_a.shape[0]
    both = jnp.concatenate([anchors_a, anchors_b], axis=0)
    hits, resolved = exact_anchor_stats(table, ntable, meta, both, cfg,
                                        axis_name=axis_name)
    k = min(cfg.exact_fallback_slots, 2 * B)
    # Under sharding, `resolved` is globally combined (psum), so every
    # shard compacts the SAME indices and the per-shard enumeration
    # below combines through the same collectives as classic K1.
    order = jnp.argsort(resolved.astype(jnp.int8), stable=True)
    idx = order[:k]
    sub = jnp.take(both, idx, axis=0)
    sub_hits = align_anchors(table, meta, sub, cfg, axis_name=axis_name)
    merged = AnchorHits(*(f.at[idx].set(s)
                          for f, s in zip(hits, sub_hits)))
    overflow = jnp.sum(~resolved) > k
    return (AnchorHits(*(x[:B] for x in merged)),
            AnchorHits(*(x[B:] for x in merged)), overflow)


def align_anchors(table, meta, anchors, cfg: Config,
                  axis_name: str | None = None) -> AnchorHits:
    """SPEC.md §2 anchor alignment for a batch of anchors.

    Single-shard when axis_name is None; with axis_name set, each caller
    holds one prefix-range table shard and results combine over that mesh
    axis (bit-identical by disjointness of exact-20-mer keys).
    """
    stats = candidate_stats(table, meta, anchors, cfg)
    return finalize_hits(*stats, cfg, axis_name=axis_name)


def align_anchor_pair(table, meta, anchors_a, anchors_b, cfg: Config,
                      axis_name: str | None = None
                      ) -> tuple[AnchorHits, AnchorHits]:
    """Both anchors of a batch in ONE stacked [2B] program.

    Row-wise identical to two `align_anchors` calls (every op is
    per-row); stacking halves the number of gather/reduce op instances
    XLA emits per detect step, which measurably cuts per-batch fixed
    overhead on the issue-rate-bound K1 phase."""
    B = anchors_a.shape[0]
    both = jnp.concatenate([anchors_a, anchors_b], axis=0)
    hits = align_anchors(table, meta, both, cfg, axis_name=axis_name)
    return (AnchorHits(*(x[:B] for x in hits)),
            AnchorHits(*(x[B:] for x in hits)))
