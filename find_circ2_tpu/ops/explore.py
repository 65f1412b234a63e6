"""Device-side multi-hit pair exploration (SPEC.md §2b) — the device form
of the reference's bowtie2-multi-mapper + find_circ.py pair loop
(SURVEY.md §3.3, §7 "Dynamic→static shape conversion").

Reads whose anchors tie at the best mismatch level (~20% of a
repeat-realistic library) used to be re-called on a host slow path that
dominated end-to-end wall time. This module replaces that path with a
fully static-shaped device program, exact by construction:

- The frozen §2b candidate list is the FIRST `max_pair_hits` (K=8)
  best-mm hits in (strand, position) order. Per variant the table +
  extras rows (index/hashtable.py) hold each hit list's K-prefix; the
  smallest K of a union of ascending lists live inside the union of the
  lists' K-prefixes, so the merged device list equals the oracle's.
- Every candidate has exactly ONE pairing role: a left-piece start
  (anchor A on '+', anchor B on '-') or a right-piece end — so one
  (L+2)-wide genome window per candidate serves its §4 prefix sums, its
  §2b/§6 full-read prefilter extension (same window, same query), and
  the GT/AG dinucleotide scans.
- The K x K pair grid evaluates all splits via the same prefix-sum
  reformulation as ops/breakpoint.py (prefix_sum_rows, one pass per
  anchor side), then resolves the frozen pair tie-break
  (edits, !canon+, !canon-, pA, pB; '+'-strand pairs first on full ties)
  with masked integer min passes — no data-dependent shapes anywhere.

Bit-identity with models/oracle.call_read (and models/multihit) is
asserted by tests/test_explore.py on repeat-heavy libraries.
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
    ST_ANCHOR_OVERLAP,
    ST_DIFF_CHROM,
    ST_DIFF_STRAND,
    ST_JUNCTION,
    ST_NO_JUNCTION,
    ST_PREFILTERED,
    ST_UNALIGNED_A,
    ST_UNALIGNED_B,
)
from find_circ2_tpu.ops.anchor_align import (LARGE_POS, candidate_stats,
                                             finalize_hits, read_anchors)
from find_circ2_tpu.ops.breakpoint import prefix_sum_rows
from find_circ2_tpu.ops.packed import gather_window

_A, _C, _G, _T = 0, 1, 2, 3
BIG = np.int32(1 << 20)  # np, not jnp: see ops/anchor_align.py


def merged_candidates(count, first_pos, extras, mm_v, best_mm,
                      cfg: Config):
    """First-K (strand, position) hits at best mm [FROZEN §2b order].

    count/first_pos: [B, 2V] per-strand-slot stats (guarded);
    extras: uint32 [B, 2V, K-1] positions 2..K of each slot's hit list;
    best_mm: [B] from finalize_hits. Returns (pos uint32 [B, K],
    strand int32 [B, K], valid bool [B, K]); invalid lanes hold
    LARGE_POS / strand 0.
    """
    B, V2 = count.shape
    V = V2 // 2
    K = cfg.max_pair_hits
    lane = jnp.arange(K, dtype=jnp.int32)
    cand = jnp.concatenate([first_pos[..., None], extras], axis=-1)
    at_best = (mm_v[None, :] == best_mm[:, None]) & (count > 0)
    lane_ok = lane[None, None, :] < jnp.minimum(count, K)[..., None]
    cand = jnp.where(at_best[..., None] & lane_ok, cand, LARGE_POS)
    # Smallest K per strand: per-variant lists are ascending, so the
    # global first K live inside the per-variant K-prefixes; positions
    # are distinct across variants of one strand (each genome position
    # holds exactly one 20-mer), so a plain sort needs no dedup.
    plus = jnp.sort(cand[:, :V, :].reshape(B, V * K), axis=-1)[:, :K]
    minus = jnp.sort(cand[:, V:, :].reshape(B, V * K), axis=-1)[:, :K]
    # Merge in frozen order ('+' entries before '-'), cap at K: compact
    # the valid entries of [plus, minus] by rank.
    both = jnp.concatenate([plus, minus], axis=1)           # [B, 2K]
    strand2k = jnp.repeat(jnp.arange(2, dtype=jnp.int32), K)
    ok2k = both != LARGE_POS
    rank = jnp.cumsum(ok2k.astype(jnp.int32), axis=1) - 1
    sel = ok2k[:, None, :] & (rank[:, None, :] == lane[None, :, None])
    pos = jnp.sum(jnp.where(sel, both[:, None, :], 0),
                  axis=-1).astype(jnp.uint32)
    strand = jnp.sum(jnp.where(sel, strand2k[None, None, :], 0),
                     axis=-1).astype(jnp.int32)
    valid = jnp.any(sel, axis=-1)
    pos = jnp.where(valid, pos, LARGE_POS)
    return pos, strand, valid


def _candidate_side(gpacked, nbases, pos, strand, lens, R32, rc32,
                    in_read, is_A: bool, cfg: Config):
    """Per-candidate role window + prefix sums + dinucleotide flags.

    A candidate is the LEFT piece iff (anchor A and strand '+') or
    (anchor B and strand '-') — SPEC §3 strand canonicalization — so its
    window is G[p : p+L+2]; a RIGHT piece reads G[p+a-l-2 : p+a] (the
    same layout as ops/breakpoint.py's GA/GBw, so all §4 slicing rules
    carry over verbatim). The full-read §6 prefilter geometry equals the
    same window/query pair, so `tot` doubles as the §2b extension
    mismatch count.
    """
    B, K = pos.shape
    Lp = R32.shape[1]
    a_u = jnp.uint32(cfg.anchor_len)
    lens_u = lens.astype(jnp.uint32)
    role_left = (strand == 0) if is_A else (strand == 1)
    start = jnp.where(role_left, pos,
                      pos + a_u - lens_u[:, None] - 2)
    start = jnp.clip(start, 0, jnp.uint32(nbases - (Lp + 2)))
    W = gather_window(gpacked, start, Lp + 2)               # [B,K,Lp+2]
    Q = jnp.where((strand == 0)[..., None], R32[:, None, :],
                  rc32[:, None, :])
    Wseg = jnp.where(role_left[..., None], W[..., :Lp], W[..., 2:])
    neq = ((Q != Wseg) | (Q >= 4) | (Wseg >= 4)) & in_read[:, None, :]
    pref = prefix_sum_rows(neq.reshape(B * K, Lp)).reshape(B, K, Lp)
    prefx = jnp.pad(pref, ((0, 0), (0, 0), (1, 0)))   # prefx[..,k]=mm(:k)
    tot = pref[..., Lp - 1]                           # full-read mm (§6)
    # Splice-signal dinucleotides at split k (same slices as
    # breakpoint.py: donor = W[k:k+2] left-role, acceptor = W[k:k+2]
    # right-role).
    w0 = W[..., :Lp + 1]
    w1 = W[..., 1:Lp + 2]
    return dict(
        W=W, prefx=prefx, tot=tot,
        cpL=(w0 == _G) & (w1 == _T), cmL=(w0 == _C) & (w1 == _T),
        cpR=(w0 == _A) & (w1 == _G), cmR=(w0 == _A) & (w1 == _C),
    )


def explore_core(gpacked, nbases, chrom_offsets, reads, lens,
                 hits_a, hits_b, posA, strA, valA, posB, strB, valB,
                 cfg: Config, prefilter: bool):
    """§2b per-read resolution given merged candidate lists: prefilter
    over all candidates, K x K pair exploration with the frozen
    tie-breaks, v2 single-best fallback chain. Output dict matches
    models/pipeline.detect_core (multi == 0: these rows are final)."""
    from find_circ2_tpu.config import RPAD_CODE

    B, Lp = reads.shape
    a = cfg.anchor_len
    K = cfg.max_pair_hits
    a_u = jnp.uint32(a)
    lens_u = lens.astype(jnp.uint32)
    pos_ax = jnp.arange(Lp, dtype=jnp.int32)[None, :]
    in_read = pos_ax < lens[:, None]

    R32 = reads.astype(jnp.int32)
    rc_idx = jnp.clip(lens[:, None] - 1 - pos_ax, 0, Lp - 1)
    rc32 = jnp.take_along_axis(R32, rc_idx, axis=1)
    rc32 = jnp.where(rc32 < 4, 3 - rc32, rc32)
    rc32 = jnp.where(in_read, rc32, jnp.int32(RPAD_CODE))

    SA = _candidate_side(gpacked, nbases, posA, strA, lens, R32, rc32,
                         in_read, True, cfg)
    SB = _candidate_side(gpacked, nbases, posB, strB, lens, R32, rc32,
                         in_read, False, cfg)

    # --- §2b prefilter: ANY candidate extending contiguously (§6) ------
    contig = (jnp.any(valA & (SA["tot"] <= cfg.prefilter_mm), axis=1)
              | jnp.any(valB & (SB["tot"] <= cfg.prefilter_mm), axis=1))

    # --- K x K pair grid ------------------------------------------------
    sAx = strA[:, :, None]
    sBx = strB[:, None, :]
    s = jnp.broadcast_to(sAx, (B, K, K))        # common strand where ok
    strand_ok = (sAx == sBx) & valA[:, :, None] & valB[:, None, :]
    is0 = s == 0
    posAe = jnp.broadcast_to(posA[:, :, None], (B, K, K))
    posBe = jnp.broadcast_to(posB[:, None, :], (B, K, K))
    # Strand canonicalization [FROZEN] SPEC §3: '-' pairs swap roles.
    pA = jnp.where(is0, posAe, posBe)
    pB = jnp.where(is0, posBe, posAe)
    endB = pB + a_u
    linear = pA + a_u <= pB
    circular = endB <= pA
    kind = jnp.where(circular, KIND_CIRCULAR,
                     KIND_LINEAR).astype(jnp.int32)
    chA = (jnp.searchsorted(chrom_offsets, pA, side="right") - 1
           ).astype(jnp.int32)
    chB = (jnp.searchsorted(chrom_offsets, pB, side="right") - 1
           ).astype(jnp.int32)
    pair_ok = strand_ok & (chA == chB) & (linear | circular)

    # --- §4 split scores for every pair --------------------------------
    k_ax = jnp.arange(Lp + 1, dtype=jnp.int32)
    pfxA = SA["prefx"][:, :, None, :]
    pfxB = SB["prefx"][:, None, :, :]
    totA = SA["tot"][:, :, None, None]
    totB = SB["tot"][:, None, :, None]
    is0k = is0[..., None]
    score = jnp.where(is0k, pfxA + (totB - pfxB), pfxB + (totA - pfxA))
    k_valid = ((k_ax[None, None, None, :] >= a)
               & (k_ax[None, None, None, :]
                  <= lens[:, None, None, None] - a))
    scm = jnp.where(k_valid, score, BIG)
    edits = jnp.min(scm, axis=-1)
    n_bp = jnp.sum((scm == edits[..., None]) & k_valid,
                   axis=-1).astype(jnp.int32)
    canon_p = jnp.where(is0k,
                        SA["cpL"][:, :, None, :] & SB["cpR"][:, None, :, :],
                        SB["cpL"][:, None, :, :] & SA["cpR"][:, :, None, :])
    canon_m = jnp.where(is0k,
                        SA["cmL"][:, :, None, :] & SB["cmR"][:, None, :, :],
                        SB["cmL"][:, None, :, :] & SA["cmR"][:, :, None, :])
    # Frozen split tie-break (score, !canon+, !canon-, k), as one packed
    # integer key: score <= 2*Lp, so key < (2*Lp*4 + 4) * (Lp+2) << 2^30.
    key = (score * 2 + jnp.where(canon_p, 0, 1)) * 2 \
        + jnp.where(canon_m, 0, 1)
    key = key * (Lp + 2) + k_ax
    key = jnp.where(k_valid, key, jnp.int32(2 ** 30))
    kmin = jnp.min(key, axis=-1)                            # [B, K, K]
    best_k = kmin % (Lp + 2)
    rest = kmin // (Lp + 2)
    cm_b = (rest & 1) == 0
    cp_b = ((rest >> 1) & 1) == 0

    # Junction coords + viability at each pair's chosen split.
    ku = best_k.astype(jnp.uint32)
    donor = pA + ku
    acceptor = endB + ku - lens_u[:, None, None]
    startj = jnp.where(circular, acceptor, donor)
    endj = jnp.where(circular, donor, acceptor)
    viable = ~((kind == KIND_LINEAR) & (endj <= startj))
    pair_ok = pair_ok & viable

    # --- frozen pair tie-break: (edits, !c+, !c-, pA, pB), '+' pairs
    # first on full ties (oracle iteration order) — masked min passes.
    def flat(x):
        return x.reshape(B, K * K)

    ok = flat(pair_ok)
    e1 = jnp.where(ok, flat(edits) * 4 + jnp.where(flat(cp_b), 0, 2)
                   + jnp.where(flat(cm_b), 0, 1), BIG)
    ok = ok & (e1 == jnp.min(e1, axis=1)[:, None])
    pAf = jnp.where(ok, flat(pA), LARGE_POS)
    ok = ok & (pAf == jnp.min(pAf, axis=1)[:, None])
    pBf = jnp.where(ok, flat(pB), LARGE_POS)
    ok = ok & (pBf == jnp.min(pBf, axis=1)[:, None])
    sf = jnp.where(ok, flat(s), 2)
    ok = ok & (sf == jnp.min(sf, axis=1)[:, None])
    first = ok & (jnp.cumsum(ok.astype(jnp.int32), axis=1) == 1)
    any_pair = jnp.any(ok, axis=1)

    def pick(x):
        return jnp.sum(jnp.where(first, flat(x), 0), axis=1)

    kind_s = pick(kind)
    start_s = pick(startj)
    end_s = pick(endj)
    edits_s = pick(edits)
    nbp_s = pick(n_bp)
    k_s = pick(best_k)
    pA_s = pick(pA)
    pB_s = pick(pB)
    s_s = pick(s)
    chrom_s = pick(chA)
    cp_s = jnp.any(first & flat(cp_b), axis=1)
    cm_s = jnp.any(first & flat(cm_b), axis=1)

    # --- signal dinucleotides of the winning pair -----------------------
    f3 = first.reshape(B, K, K)
    fi = jnp.any(f3, axis=2)
    fj = jnp.any(f3, axis=1)
    WselA = jnp.sum(jnp.where(fi[..., None], SA["W"], 0), axis=1)
    WselB = jnp.sum(jnp.where(fj[..., None], SB["W"], 0), axis=1)
    left0 = (s_s == 0)[:, None]
    Wleft = jnp.where(left0, WselA, WselB)
    Wright = jnp.where(left0, WselB, WselA)

    def tk(W, off):
        idx = jnp.clip(k_s + off, 0, Lp + 1)
        return jnp.take_along_axis(W, idx[:, None], axis=1)[:, 0]

    d0, d1 = tk(Wleft, 0), tk(Wleft, 1)
    a0, a1 = tk(Wright, 0), tk(Wright, 1)
    sense = jnp.where(cp_s, SENSE_PLUS,
                      jnp.where(cm_s, SENSE_MINUS, s_s)).astype(jnp.int32)

    def comp(x):
        return jnp.where(x < 4, 3 - x, x)

    sig_p = jnp.stack([d0, d1, a0, a1], axis=1)
    sig_m = jnp.stack([comp(a1), comp(a0), comp(d1), comp(d0)], axis=1)
    signal = jnp.where((sense == SENSE_MINUS)[:, None], sig_m, sig_p)

    # anchor_overlap at the winning split (SPEC §4), uint32-branchless.
    k_su = k_s.astype(jnp.uint32)
    endB_s = pB_s + a_u
    seg1_e = pA_s + k_su
    seg2_s = endB_s + k_su - lens_u
    min_e = jnp.minimum(seg1_e, endB_s)
    max_s = jnp.maximum(pA_s, seg2_s)
    overlap = jnp.where(min_e > max_s, min_e - max_s,
                        jnp.uint32(0)).astype(jnp.int32)

    # --- status [FROZEN §2b priority]: prefiltered > unaligned_A >
    # unaligned_B > junction > v2 single-best fallback chain.
    ch_a1 = jnp.searchsorted(chrom_offsets, hits_a.pos, side="right") - 1
    ch_b1 = jnp.searchsorted(chrom_offsets, hits_b.pos, side="right") - 1
    minus1 = hits_a.strand == 1
    pA1 = jnp.where(minus1, hits_b.pos, hits_a.pos)
    pB1 = jnp.where(minus1, hits_a.pos, hits_b.pos)
    geom1 = (pA1 + a_u <= pB1) | (pB1 + a_u <= pA1)
    fallback = jnp.where(
        hits_a.strand != hits_b.strand, ST_DIFF_STRAND,
        jnp.where(ch_a1 != ch_b1, ST_DIFF_CHROM,
                  jnp.where(geom1, ST_NO_JUNCTION, ST_ANCHOR_OVERLAP)))
    status = jnp.where(any_pair, ST_JUNCTION, fallback).astype(jnp.int32)
    status = jnp.where(~hits_b.aligned, ST_UNALIGNED_B, status)
    status = jnp.where(~hits_a.aligned, ST_UNALIGNED_A, status)
    if prefilter:
        status = jnp.where(contig, ST_PREFILTERED, status)

    qual_left = jnp.where(s_s == 0, hits_a.qual, hits_b.qual)
    qual_right = jnp.where(s_s == 0, hits_b.qual, hits_a.qual)
    if cfg.pair_rescue:
        # Pair-margin bridge rescue [FROZEN v4] (config.py pair_rescue),
        # identical to oracle.call_read: min edits over viable pairs at
        # a DIFFERENT (kind, start, end) than the winner; no competitor
        # -> margin a+1. Gate on the §2b multi condition so non-multi
        # rows (never routed here in production) match detect_core.
        diff = ((flat(kind) != kind_s[:, None])
                | (flat(startj) != start_s[:, None].astype(jnp.uint32))
                | (flat(endj) != end_s[:, None].astype(jnp.uint32)))
        alt = jnp.min(jnp.where(flat(pair_ok) & diff, flat(edits), BIG),
                      axis=1)
        margin = jnp.where(alt >= BIG, a + 1, alt - edits_s)
        is_multi = (hits_a.n_best > 1) | (hits_b.n_best > 1)
        rq = jnp.where(any_pair & is_multi & (margin > 0),
                       jnp.minimum(40, 10 * margin), 0)
        qual_left = jnp.maximum(qual_left, rq)
        qual_right = jnp.maximum(qual_right, rq)
    return dict(
        status=status,
        kind=kind_s,
        chrom=chrom_s,
        start=start_s, end=end_s, sense=sense,
        align_strand=s_s,
        edits=edits_s, n_bp=nbp_s, overlap=overlap,
        qual_left=qual_left, qual_right=qual_right,
        multi=jnp.zeros(B, jnp.int32),
        signal=signal,
    )


@partial(jax.jit, static_argnames=("cfg", "prefilter", "nbases"))
def explore_batch_packed(gpacked, nbases, table, meta, ext, ext_id,
                         chrom_offsets, reads, lens, cfg: Config,
                         prefilter: bool = True):
    """Full §2b multi-hit re-call for a batch of routed reads, packed as
    one int32 [B, 13] array (pipeline.PACK_FIELDS layout)."""
    from find_circ2_tpu.models.pipeline import PACK_FIELDS

    anchors_a, anchors_b = read_anchors(reads, lens, cfg)
    ca, fa, mm_v, strand_v, xa = candidate_stats(table, meta, anchors_a,
                                                 cfg, ext, ext_id)
    cb, fb, _, _, xb = candidate_stats(table, meta, anchors_b, cfg, ext,
                                       ext_id)
    hits_a = finalize_hits(ca, fa, mm_v, strand_v, cfg)
    hits_b = finalize_hits(cb, fb, mm_v, strand_v, cfg)
    posA, strA, valA = merged_candidates(ca, fa, xa, mm_v, hits_a.mm, cfg)
    posB, strB, valB = merged_candidates(cb, fb, xb, mm_v, hits_b.mm, cfg)
    res = explore_core(gpacked, nbases, chrom_offsets, reads, lens,
                       hits_a, hits_b, posA, strA, valA, posB, strB,
                       valB, cfg, prefilter)
    sig = res["signal"].astype(jnp.int32)
    sig_packed = (sig[:, 0] | (sig[:, 1] << 3) | (sig[:, 2] << 6)
                  | (sig[:, 3] << 9))
    cols = [res[k].astype(jnp.int32) for k in PACK_FIELDS[:-1]]
    cols.append(sig_packed)
    return jnp.stack(cols, axis=1)
