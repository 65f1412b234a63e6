"""K2: batched breakpoint search — the hot inner loop of SURVEY.md §3.3,
reformulated for a vectorizing accelerator.

The reference recomputes Hamming distance per candidate split (O(L²) per
read). Ungapped alignment makes `mmL` a prefix-sum and `mmR` a suffix-sum
of per-position mismatch indicators, so one pass of cumulative sums yields
every split's score: O(L) per read, fully vectorized over the batch, no
data-dependent shapes (SPEC.md §4 fixes identical semantics; the CPU
oracle cross-checks with the naive formulation).

All inputs are genome-forward canonicalized (SPEC.md §3): minus-strand
pairs arrive already reverse-complemented with anchor roles swapped.

Shapes: batch B, padded read length Lp = cfg.max_read_len.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from find_circ2_tpu.config import (
    Config,
    KIND_CIRCULAR,
    KIND_LINEAR,
    SENSE_MINUS,
    SENSE_PLUS,
)

# Genome base codes (SPEC.md §0) used for signal tests.
_A, _C, _G, _T = 0, 1, 2, 3

BIG = np.int32(1 << 20)  # np, not jnp: see ops/anchor_align.py


def prefix_sum_rows(ind: jnp.ndarray) -> jnp.ndarray:
    """Inclusive prefix sums along the last axis of 0/1 indicators
    ([N, Lp] bool) as int32 — K2's mmL/mmR and the explore program's
    per-candidate scores.

    One triangular-ones matrix product: the indicators are exact in
    bf16 and every partial sum (<= Lp < 2^24) is exact in the float32
    accumulator (`preferred_element_type`), so the result is exact on
    tensor cores and TF32 never enters. Any float32 product added on
    this path must state its precision the same way."""
    Lp = ind.shape[-1]
    tri = (jnp.arange(Lp)[:, None] <= jnp.arange(Lp)[None, :]
           ).astype(jnp.bfloat16)
    return jnp.dot(ind.astype(jnp.bfloat16), tri,
                   preferred_element_type=jnp.float32).astype(jnp.int32)


@partial(jax.jit, static_argnames=("cfg", "nbases"))
def breakpoint_search(
    gpacked: jnp.ndarray,    # uint32 [~G/8] nibble-packed genome codes
    nbases: int,             # static: total codes in the packed genome
    reads: jnp.ndarray,      # uint8 [B, Lp] canonicalized read codes (RPAD=6)
    lens: jnp.ndarray,       # int32 [B] true read lengths
    pA: jnp.ndarray,         # uint32 [B] left-piece start (global)
    endB: jnp.ndarray,       # uint32 [B] right-piece end (global)
    kind: jnp.ndarray,       # int32 [B] KIND_LINEAR / KIND_CIRCULAR
    align_strand: jnp.ndarray,  # int32 [B] 0/1, fallback sense
    cfg: Config,
):
    """Returns a dict of per-read junction fields (SPEC.md §4).

    Invalid rows (caller masks) still compute garbage safely: all gathers
    are clamped into the genome array.
    """
    from find_circ2_tpu.ops.packed import gather_window

    B, Lp = reads.shape
    a = cfg.anchor_len

    def clamp(x, lo, hi):
        # Bounds wrapped in uint32: a bare python int above 2^31 (the
        # upper clip bound on a whole-genome index) overflows JAX's
        # weak-typed argument parsing.
        return jnp.clip(x, jnp.uint32(lo), jnp.uint32(hi))

    # --- window gathers (word-packed, ops/packed.py) --------------------
    # Positions are uint32; keep all position arithmetic in uint32 (an
    # int32 operand would promote to int64). Wraps only occur on garbage
    # rows, which the caller masks.
    lens_u = lens.astype(jnp.uint32)
    # GA[i] = genome[pA + i], i in [0, Lp+2): left extension + donor dinuc.
    startA = clamp(pA, 0, nbases - (Lp + 2))
    GA = gather_window(gpacked, startA, Lp + 2)
    # GB window covers genome[endB - l - 2 : endB - l - 2 + Lp + 2]; the
    # right piece base aligned with read position i is GB[i + 2] for i < l.
    startB = clamp(endB - lens_u - 2, 0, nbases - (Lp + 2))
    GBw = gather_window(gpacked, startB, Lp + 2)

    R = reads.astype(jnp.int32)
    pos = jnp.arange(Lp, dtype=jnp.int32)[None, :]
    in_read = pos < lens[:, None]

    # --- mismatch prefix sums -------------------------------------------
    GA_r = GA[:, :Lp]
    GB_r = GBw[:, 2:]
    neqA = ((R != GA_r) | (R >= 4) | (GA_r >= 4)) & in_read
    neqB = ((R != GB_r) | (R >= 4) | (GB_r >= 4)) & in_read
    pref = prefix_sum_rows(jnp.concatenate([neqA, neqB], axis=0))
    prefA, prefB = pref[:B], pref[B:]                    # prefA[:,k-1]=mmL(k)
    totB = jnp.take_along_axis(
        prefB, clamp(lens[:, None] - 1, 0, Lp - 1), axis=1)

    # score at split k (k in [a, l-a]): mmL(k) + (totB - prefB[k]).
    # Evaluate for every k in [0, Lp] then mask. Use k index array [B, Lp+1].
    k_ax = jnp.arange(Lp + 1, dtype=jnp.int32)[None, :]
    prefA_x = jnp.pad(prefA, ((0, 0), (1, 0)))           # prefA_x[:,k]=mmL(k)
    prefB_x = jnp.pad(prefB, ((0, 0), (1, 0)))
    score = prefA_x + (totB - prefB_x)
    k_valid = (k_ax >= a) & (k_ax <= lens[:, None] - a)
    score = jnp.where(k_valid, score, BIG)

    edits = jnp.min(score, axis=1)
    is_min = score == edits[:, None]
    n_bp = jnp.sum(is_min & k_valid, axis=1).astype(jnp.int32)

    # --- junction coords + canonical signal per split -------------------
    k_u = k_ax.astype(jnp.uint32)
    donor = pA[:, None] + k_u                   # pA + k
    acceptor = endB[:, None] + k_u - lens_u[:, None]
    is_circ = (kind == KIND_CIRCULAR)[:, None]
    j_start = jnp.where(is_circ, acceptor, donor)
    j_end = jnp.where(is_circ, donor, acceptor)

    # Signal bases, via the already-gathered windows (no extra gathers):
    # donor-side dinuc  = genome[donor : donor+2]   = GA[k : k+2]
    # acceptor-side dinuc = genome[acceptor-2 : acceptor] = GBw[k : k+2]
    # k_ax is a broadcast arange, so indexing by it is a pure SLICE —
    # take_along_axis here would emit four [B, Lp+1] gather passes
    # (docs/DESIGN.md "XLA pitfalls").
    d0 = GA[:, :Lp + 1]
    d1 = GA[:, 1:Lp + 2]
    a0 = GBw[:, :Lp + 1]
    a1 = GBw[:, 1:Lp + 2]

    # SPEC §4 canonical patterns, genome-forward:
    #   sense + : donor dinuc GT, acceptor dinuc AG
    #   sense - : donor dinuc CT, acceptor dinuc AC   (same for both kinds:
    # "donor-side" = the GT/CT side next to pA+k; "acceptor-side" = the
    # AG/AC side before endB-(l-k); kind only swaps which is start/end.)
    canon_p = (d0 == _G) & (d1 == _T) & (a0 == _A) & (a1 == _G)
    canon_m = (d0 == _C) & (d1 == _T) & (a0 == _A) & (a1 == _C)

    # --- frozen tie-break: (score, !canon+, !canon-, k) lexicographic ---
    key = (score * 8
           + jnp.where(canon_p, 0, 4)
           + jnp.where(canon_m, 0, 2))
    key = key * (Lp + 2) + k_ax
    key = jnp.where(k_valid, key, jnp.int32(2 ** 30))
    best_key = jnp.argmin(key, axis=1).astype(jnp.int32)    # = chosen k
    take = lambda arr: jnp.take_along_axis(
        arr, best_key[:, None], axis=1)[:, 0]

    best_k = best_key
    b_start = take(j_start)
    b_end = take(j_end)
    b_canon_p = take(canon_p)
    b_canon_m = take(canon_m)
    b_d0, b_d1, b_a0, b_a1 = take(d0), take(d1), take(a0), take(a1)

    sense = jnp.where(b_canon_p, SENSE_PLUS,
                      jnp.where(b_canon_m, SENSE_MINUS, align_strand))
    sense = sense.astype(jnp.int32)

    # Signal dinucs in splice-sense orientation (SPEC §4): for '+', the
    # string is donor_fwd + acceptor_fwd; for '-', revcomp+swap.
    def comp(x):
        return jnp.where(x < 4, 3 - x, x)
    sig_p = jnp.stack([b_d0, b_d1, b_a0, b_a1], axis=1)
    sig_m = jnp.stack([comp(b_a1), comp(b_a0), comp(b_d1), comp(b_d0)],
                      axis=1)
    signal = jnp.where((sense == SENSE_MINUS)[:, None], sig_m, sig_p)

    # anchor_overlap at best split (SPEC §4). uint32 positions: compute
    # max(0, min_e - max_s) branchlessly without underflow.
    best_k_u = best_k.astype(jnp.uint32)
    seg1_s, seg1_e = pA, pA + best_k_u
    seg2_s, seg2_e = endB + best_k_u - lens_u, endB
    min_e = jnp.minimum(seg1_e, seg2_e)
    max_s = jnp.maximum(seg1_s, seg2_s)
    overlap = jnp.where(min_e > max_s, min_e - max_s,
                        jnp.uint32(0)).astype(jnp.int32)

    # Linear junctions need end > start (SPEC §4); caller turns this into
    # ST_NO_JUNCTION.
    no_junction = (kind == KIND_LINEAR) & (b_end <= b_start)

    return dict(
        start=b_start, end=b_end, sense=sense, edits=edits,
        n_bp=n_bp, overlap=overlap, signal=signal,
        no_junction=no_junction, best_k=best_k,
    )
