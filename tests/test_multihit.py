"""SPEC §2b multi-hit anchor pairing: a junction whose anchor has two
equal best hits, where the decoy hit has the smaller genomic position.

v2 single-best-hit semantics (device without slowpath) relocate the
junction to the decoy; the v3 pair exploration recovers the true
coordinates because the true pair has fewer breakpoint edits. Oracle and
device+slowpath must agree exactly."""

import numpy as np

from find_circ2_tpu.config import Config, KIND_CIRCULAR, ST_JUNCTION
from find_circ2_tpu.index.build import build_index
from find_circ2_tpu.io.genome import Genome
from find_circ2_tpu.io.twobit import codes_to_seq
from find_circ2_tpu.models.oracle import anchor_candidates, call_read
from find_circ2_tpu.models.pipeline import DeviceIndex, run_reads

CFG = Config()

TRUE_S, DECOY_S = 20000, 5000   # local junction/decoy right-piece starts
TRUE_E = 21000                  # local junction end (donor side)
BP, L = 50, 100


def _setup():
    rng = np.random.default_rng(33)
    seq = rng.integers(0, 4, size=30000, dtype=np.uint8)
    # Make the seam unambiguous: adjacent splits must mismatch so the
    # argmin is unique at bp=BP.
    seq[TRUE_S - 1], seq[TRUE_E - 1] = 2, 3
    seq[TRUE_S], seq[TRUE_E] = 0, 1
    # Decoy: copy of the right piece at a LOWER position, with one
    # mutation inside the piece but outside anchor B's 20-mer window
    # [30, 50) — anchor B keeps two exact hits, the decoy pair scores
    # one extra edit.
    seq[DECOY_S:DECOY_S + BP] = seq[TRUE_S:TRUE_S + BP]
    seq[DECOY_S + 5] = (seq[DECOY_S + 5] + 1) % 4
    genome = Genome.from_records([("chrM", seq)], CFG)
    index = build_index(genome, CFG)
    # Circular read: G[E-bp : E] + G[S : S+L-bp].
    read = np.concatenate([seq[TRUE_E - BP:TRUE_E],
                           seq[TRUE_S:TRUE_S + (L - BP)]])
    return genome, index, codes_to_seq(read)


def test_anchor_candidates_two_hits():
    genome, index, read_seq = _setup()
    from find_circ2_tpu.io.twobit import seq_to_codes
    codes = seq_to_codes(read_seq)
    hitB, candsB = anchor_candidates(genome, index, codes[-20:], CFG)
    gap = CFG.chrom_gap
    assert hitB.n_best == 2 and hitB.qual == 0
    assert [p - gap for _, p in candsB] == [DECOY_S + 30, TRUE_S + 30]
    # Single-best picks the decoy (frozen min-position order).
    assert hitB.pos - gap == DECOY_S + 30


def test_oracle_recovers_true_junction():
    genome, index, read_seq = _setup()
    call = call_read(genome, index, "r", read_seq, CFG)
    gap = CFG.chrom_gap
    assert call.status == ST_JUNCTION and call.kind == KIND_CIRCULAR
    assert (call.start - gap, call.end - gap) == (TRUE_S, TRUE_E)
    assert call.edits == 0
    # SPEC §2b pair-margin rescue [FROZEN v4]: the winning pair beats
    # the decoy pair by exactly 1 edit, so the ambiguous right anchor's
    # qual upgrades to min(40, 10*1) = 10.
    assert call.qual_right == 10 and call.qual_left == 40
    # pair_rescue=False restores v3 anchor-only quals.
    import dataclasses
    v3 = call_read(genome, index, "r", read_seq,
                   dataclasses.replace(CFG, pair_rescue=False))
    assert v3.qual_right == 0 and v3.qual_left == 40


def test_device_slowpath_matches_oracle_v2_misses():
    genome, index, read_seq = _setup()
    dindex = DeviceIndex.build(genome, index, CFG)
    gap = CFG.chrom_gap
    # v2 (no slowpath): junction relocated to the decoy pair.
    [v2] = run_reads(dindex, [("r", read_seq)], CFG)
    assert v2.status == ST_JUNCTION
    assert v2.start - gap == DECOY_S  # the round-1 miss, pinned
    assert v2.edits == 1
    # v3 (slowpath): identical to the oracle.
    [v3] = run_reads(dindex, [("r", read_seq)], CFG,
                     slowpath=(genome, index))
    oracle = call_read(genome, index, "r", read_seq, CFG)
    assert v3 == oracle
    assert (v3.start - gap, v3.end - gap) == (TRUE_S, TRUE_E)


def test_fast_multihit_path_equals_oracle():
    """models/multihit.call_read_multi (the vectorized slow-path twin) is
    field-identical to oracle.call_read on a repeat-rich library — every
    read, not just multi ones (the fast path must also reproduce the
    prefilter/unaligned/fallback chains)."""
    from find_circ2_tpu.models.multihit import call_read_multi
    from find_circ2_tpu.utils.simulate import rnase_r_library

    sim = rnase_r_library(seed=13, chrom_lengths={"chrR": 500_000},
                          n_circ=40, n_linear=8, depth_mean=4.0,
                          repeat_frac=0.35, cfg=CFG)
    index = build_index(sim.genome, CFG)
    n_multi = 0
    for name, seq in sim.reads:
        o = call_read(sim.genome, index, name, seq, CFG)
        f = call_read_multi(sim.genome, index, name, seq, CFG)
        assert o == f, (name, o, f)
        from find_circ2_tpu.io.twobit import seq_to_codes
        c = seq_to_codes(seq)
        hA, _ = anchor_candidates(sim.genome, index, c[:20], CFG)
        hB, _ = anchor_candidates(sim.genome, index, c[-20:], CFG)
        n_multi += int(hA.n_best > 1 or hB.n_best > 1)
    assert n_multi >= 20, f"library must exercise multi reads, got {n_multi}"


def test_fast_multihit_on_decoy_case():
    """The planted decoy scenario resolves identically through the fast
    path, and the streaming slowpath (which now routes through it) still
    matches the oracle."""
    from find_circ2_tpu.models.multihit import call_read_multi
    genome, index, read_seq = _setup()
    oracle = call_read(genome, index, "r", read_seq, CFG)
    fast = call_read_multi(genome, index, "r", read_seq, CFG)
    assert fast == oracle


def test_batched_multihit_equals_per_read():
    """call_reads_multi_batch (the r5 batched rescue path) is element-
    wise identical to per-read call_read_multi on a library mixing
    clean, erroneous (2-mm rescue), multi-hit, junction-spanning,
    too-short and dirty (N-containing) reads."""
    from find_circ2_tpu.models.multihit import (call_read_multi,
                                                call_reads_multi_batch)
    from find_circ2_tpu.utils.simulate import rnase_r_library

    sim = rnase_r_library(seed=29, chrom_lengths={"chrR": 400_000},
                          n_circ=30, n_linear=6, depth_mean=3.0,
                          repeat_frac=0.35, cfg=CFG)
    index = build_index(sim.genome, CFG)
    rng = np.random.default_rng(5)
    reads = list(sim.reads)
    # Inject 2 errors into one anchor of some reads (rescue workload),
    # an N into others (dirty-anchor chain), plus one too-short read.
    extra = []
    for i, (name, seq) in enumerate(reads[:60]):
        s = list(seq)
        if i % 3 == 0 and len(s) >= 40:
            j1, j2 = rng.choice(20, 2, replace=False)
            for j in (int(j1), int(j2)):
                s[j] = "ACGT"[("ACGT".index(s[j]) + 1) % 4]
            extra.append((name + "_2mm", "".join(s)))
        elif i % 3 == 1:
            s[5] = "N"
            extra.append((name + "_N", "".join(s)))
    extra.append(("short", "ACGTACGT"))
    reads = reads[:120] + extra
    single = [call_read_multi(sim.genome, index, nm, sq, CFG)
              for nm, sq in reads]
    batch = call_reads_multi_batch(sim.genome, index, reads, CFG)
    assert len(single) == len(batch)
    for s, b in zip(single, batch):
        assert s == b, (s, b)
