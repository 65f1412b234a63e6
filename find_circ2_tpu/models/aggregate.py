"""Junction aggregation, category flags, and BED table construction.

Host-side, shared verbatim by the CPU oracle and the device path —
per-read `ReadCall` records flow in, `JunctionRow`s flow out. Semantics:
SPEC.md §5 / SURVEY.md §3.5 (single pass over a junction dict at EOF).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from find_circ2_tpu.config import (
    Config,
    KIND_CIRCULAR,
    SENSE_CHARS,
    ST_JUNCTION,
    STATUS_NAMES,
)
from find_circ2_tpu.io.bed import JunctionRow, renumber
from find_circ2_tpu.io.genome import Genome
from find_circ2_tpu.models.oracle import ReadCall


def category_flags(circular: bool, breakpoints: int, uniq_bridges: int,
                   signal: str, strandmatch: str) -> str:
    """Frozen category derivation from junction evidence (SPEC.md §5).

    The single source of truth for the `category` column: the Aggregator
    builds fresh rows through it, and `merge_bed` re-derives categories
    from merged evidence through the same call — evidence-dependent flags
    (UNAMBIGUOUS_BP / ANCHOR_UNIQUE / NO_UNIQ_BRIDGES / STRANDMATCH) can
    never diverge between the two paths.
    """
    flags = ["CIRCULAR" if circular else "LINEAR"]
    if breakpoints == 1:
        flags.append("UNAMBIGUOUS_BP")
    if uniq_bridges >= 1:
        flags.append("ANCHOR_UNIQUE")
    else:
        flags.append("NO_UNIQ_BRIDGES")
    if signal == "GTAG":
        flags.append("CANONICAL")
    if strandmatch == "MATCH":
        flags.append("STRANDMATCH")
    return ",".join(flags)


@dataclass
class JunctionAgg:
    kind: int
    chrom_idx: int
    start: int                # global coordinate
    end: int
    sense: int
    signal: str
    n_reads: int = 0
    seqs: set = field(default_factory=set)
    uniq_bridges: int = 0
    best_qual_left: int = 0
    best_qual_right: int = 0
    edits: int = 1 << 30
    overlap: int = 1 << 30
    n_bp: int = 1 << 30
    n_strand_match: int = 0   # reads whose alignment strand == sense


@dataclass
class Stats:
    """Per-run counters (reference's `-s` stats file, SURVEY §2.1)."""
    counts: dict = field(default_factory=dict)

    # Per-READ counters that sum across processes (psum'd by the --nproc
    # CLI epilogue). Junction counts are excluded: they are derived from
    # the MERGED table in rows(), not summable per rank.
    REDUCE_ORDER = ("reads_total", *STATUS_NAMES.values(),
                    "circular_reads", "linear_reads")

    def add_status(self, status: int, n: int = 1) -> None:
        name = STATUS_NAMES[status]
        self.counts[name] = self.counts.get(name, 0) + n

    def add(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def lines(self) -> list[str]:
        order = [*self.REDUCE_ORDER, "circular_junctions",
                 "linear_junctions"]
        seen = [k for k in order if k in self.counts]
        extra = sorted(k for k in self.counts if k not in order)
        return [f"{k}\t{self.counts[k]}" for k in seen + extra]


# --- n_uniq sequence identity -----------------------------------------
# `n_uniq` counts DISTINCT processed read sequences per junction. Both
# aggregation paths identify a sequence by the same deterministic 64-bit
# hash of its RPAD-padded code vector (dot product with fixed odd
# weights mod 2^64) instead of the string itself: the vectorized batch
# path then hashes a whole encoded batch in one numpy op. Identical
# values on the per-read and batch paths by construction; a collision
# (~n^2 / 2^64) would undercount n_uniq by 1.
_SEQ_W: dict[int, "np.ndarray"] = {}


def _seq_weights(Lp: int):
    import numpy as np
    w = _SEQ_W.get(Lp)
    if w is None:
        rng = np.random.default_rng(0xF1FC2)
        w = rng.integers(1, 2 ** 63, Lp, dtype=np.uint64) | np.uint64(1)
        _SEQ_W[Lp] = w
    return w


def seq_hash(seq: str, Lp: int) -> int:
    """Hash of one processed read sequence (scalar path)."""
    import numpy as np
    from find_circ2_tpu.config import RPAD_CODE
    from find_circ2_tpu.io.twobit import seq_to_codes
    codes = np.full(Lp, RPAD_CODE, np.uint8)
    c = seq_to_codes(seq)
    codes[:c.size] = c
    return int((codes.astype(np.uint64) * _seq_weights(Lp))
               .sum(dtype=np.uint64))


def seq_hash_batch(arr: "np.ndarray"):
    """Hashes of an RPAD-padded encoded batch (uint8 [n, Lp])."""
    import numpy as np
    w = _seq_weights(arr.shape[1])
    return (arr.astype(np.uint64) * w[None, :]).sum(axis=1,
                                                    dtype=np.uint64)


class Aggregator:
    """Accumulates ReadCalls into the junction dictionary."""

    def __init__(self, genome: Genome, cfg: Config = Config()) -> None:
        self.genome = genome
        self.cfg = cfg
        self.junctions: dict[tuple, JunctionAgg] = {}
        self.stats = Stats()
        # Buffered vectorized batch summaries (add_batch); merged into
        # `junctions` lazily by _drain_batches — one python-loop pass
        # over globally-distinct junctions instead of one per batch.
        self._batches: list = []
        self._batch_pairs: list = []

    def add(self, call: ReadCall) -> None:
        self.stats.add("reads_total")
        self.stats.add_status(call.status)
        if call.status != ST_JUNCTION:
            return
        self.stats.add("circular_reads" if call.kind == KIND_CIRCULAR
                       else "linear_reads")
        key = (call.kind, call.chrom_idx, call.start, call.end, call.sense)
        agg = self.junctions.get(key)
        if agg is None:
            agg = JunctionAgg(kind=call.kind, chrom_idx=call.chrom_idx,
                              start=call.start, end=call.end,
                              sense=call.sense, signal=call.signal)
            self.junctions[key] = agg
        agg.n_reads += 1
        agg.seqs.add(seq_hash(call.seq, self.cfg.max_read_len))
        uniq = self.cfg.min_uniq_qual
        if call.qual_left >= uniq and call.qual_right >= uniq:
            agg.uniq_bridges += 1
        agg.best_qual_left = max(agg.best_qual_left, call.qual_left)
        agg.best_qual_right = max(agg.best_qual_right, call.qual_right)
        agg.edits = min(agg.edits, call.edits)
        agg.overlap = min(agg.overlap, call.overlap)
        agg.n_bp = min(agg.n_bp, call.n_bp)
        if call.align_strand == call.sense:
            agg.n_strand_match += 1

    def add_batch(self, res: dict, idx, seq_hashes) -> None:
        """Vectorized twin of `add` for unpacked device result rows.

        `res` is pipeline.unpack_results output, `idx` the row indices
        to aggregate (all must have status == ST_JUNCTION), `seq_hashes`
        the `seq_hash_batch` values aligned with `idx`. Raw columns are
        buffered; ALL grouping happens in `_drain_batches` as one global
        group-by over every buffered read (one np.unique instead of one
        per batch). Bit-identical to looping `add` (all accumulators are
        commutative ints/sets, and `signal` is a pure function of the
        junction key, so merge order is immaterial; tests/test_native.py
        pins BED equality)."""
        import numpy as np

        n = len(idx)
        if n == 0:
            return
        self.stats.add("reads_total", n)
        self.stats.add_status(ST_JUNCTION, n)
        kind = res["kind"][idx].astype(np.int64)
        n_circ = int((kind == KIND_CIRCULAR).sum())
        if n_circ:
            self.stats.add("circular_reads", n_circ)
        if n - n_circ:
            self.stats.add("linear_reads", n - n_circ)
        self._batches.append(dict(
            kind=kind,
            chrom=res["chrom"][idx].astype(np.int64),
            start=res["start"][idx].astype(np.int64),
            end=res["end"][idx].astype(np.int64),
            sense=res["sense"][idx].astype(np.int64),
            ql=res["qual_left"][idx].astype(np.int64),
            qr=res["qual_right"][idx].astype(np.int64),
            e=res["edits"][idx].astype(np.int64),
            o=res["overlap"][idx].astype(np.int64),
            b=res["n_bp"][idx].astype(np.int64),
            smatch=(res["sense"][idx]
                    == res["align_strand"][idx]).astype(np.int64),
            signal=res["signal"][idx],
            hash=np.asarray(seq_hashes, np.uint64)))

    def _drain_batches(self) -> None:
        """Merge the buffered read columns into the junction dict: one
        global group-by over all buffered junction reads."""
        import numpy as np
        if not self._batches:
            return

        def col(field):
            return np.concatenate([b[field] for b in self._batches])

        # Group-by over the 5-part junction key, packed into two int64
        # words + one stable lexsort (np.unique(axis=0)'s void-view
        # sort cost ~half the final-table stage). Group ORDER differs
        # from unique's row-lexicographic order, which is immaterial:
        # junctions land in a dict and rows() renumbers by the frozen
        # sort key. kind/sense are 1 bit, chrom_idx < 2^28, global
        # start/end < 2^33 (uint32 + gaps).
        kind_c, chrom_c = col("kind"), col("chrom")
        start_c, end_c, sense_c = col("start"), col("end"), col("sense")
        k1 = ((kind_c << 62) | (sense_c << 61) | (chrom_c << 33)
              | start_c)
        k2 = end_c
        N = k1.size
        order = np.lexsort((k2, k1))
        k1s, k2s = k1[order], k2[order]
        newg = np.empty(N, bool)
        newg[0] = True
        newg[1:] = (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])
        ginv = np.empty(N, np.int64)
        ginv[order] = np.cumsum(newg) - 1
        rep = order[newg]               # first original row per group
        guk = np.stack([kind_c[rep], chrom_c[rep], start_c[rep],
                        end_c[rep], sense_c[rep]], axis=1)
        G = guk.shape[0]

        def seg_sum(v):
            out = np.zeros(G, np.int64)
            np.add.at(out, ginv, v)
            return out

        def seg_opt(v, op, init):
            out = np.full(G, init, np.int64)
            op.at(out, ginv, v)
            return out

        uniq = self.cfg.min_uniq_qual
        ql_c, qr_c = col("ql"), col("qr")
        nb = np.bincount(ginv, minlength=G).astype(np.int64)
        bridges = seg_sum((ql_c >= uniq) & (qr_c >= uniq))
        smatch = seg_sum(col("smatch"))
        ql = seg_opt(ql_c, np.maximum, 0)
        qr = seg_opt(qr_c, np.maximum, 0)
        e = seg_opt(col("e"), np.minimum, 1 << 30)
        o = seg_opt(col("o"), np.minimum, 1 << 30)
        bmin = seg_opt(col("b"), np.minimum, 1 << 30)
        sig = np.concatenate([b["signal"] for b in self._batches])
        # Bulk-decode one representative signal per group ([G, 4] codes
        # -> 4-char strings in one LUT pass; signal is a pure function
        # of the junction key, so any representative is exact).
        from find_circ2_tpu.io.twobit import _BASE_LUT
        sig_bytes = _BASE_LUT[sig[rep]].tobytes()
        sig_l = [sig_bytes[4 * g:4 * g + 4].decode("ascii")
                 for g in range(G)]

        # Distinct (junction, seq_hash) pairs across all batches:
        # stable lexsort + adjacent-dedupe, sorted by group id.
        h = col("hash").view(np.int64)
        po = np.lexsort((h, ginv))
        gs, hs = ginv[po], h[po]
        keep = np.empty(N, bool)
        keep[0] = True
        keep[1:] = (gs[1:] != gs[:-1]) | (hs[1:] != hs[:-1])
        pj, ph = gs[keep], hs[keep]
        pb = np.searchsorted(pj, np.arange(G + 1))

        self._batches = []
        self._batch_pairs = []
        # Bulk-convert once (python ints); per-element np scalar
        # conversions dominated this loop at ~10k distinct junctions.
        keys_l = list(map(tuple, guk.tolist()))
        nb_l, bridges_l, smatch_l = nb.tolist(), bridges.tolist(), \
            smatch.tolist()
        ql_l, qr_l = ql.tolist(), qr.tolist()
        e_l, o_l, b_l = e.tolist(), o.tolist(), bmin.tolist()
        pb_l = pb.tolist()
        ph_l = ph.astype(np.uint64).tolist()
        junctions = self.junctions
        for g in range(G):
            key = keys_l[g]
            agg = junctions.get(key)
            if agg is None:
                # Fresh junction: construct with final accumulator
                # values directly (the common case — one batch-path
                # junction per key).
                junctions[key] = JunctionAgg(
                    kind=key[0], chrom_idx=key[1], start=key[2],
                    end=key[3], sense=key[4],
                    signal=sig_l[g],
                    n_reads=nb_l[g],
                    seqs=set(ph_l[pb_l[g]:pb_l[g + 1]]),
                    uniq_bridges=bridges_l[g],
                    best_qual_left=ql_l[g], best_qual_right=qr_l[g],
                    edits=e_l[g], overlap=o_l[g], n_bp=b_l[g],
                    n_strand_match=smatch_l[g])
                continue
            agg.n_reads += nb_l[g]
            agg.seqs.update(ph_l[pb_l[g]:pb_l[g + 1]])
            agg.uniq_bridges += bridges_l[g]
            agg.best_qual_left = max(agg.best_qual_left, ql_l[g])
            agg.best_qual_right = max(agg.best_qual_right, qr_l[g])
            agg.edits = min(agg.edits, e_l[g])
            agg.overlap = min(agg.overlap, o_l[g])
            agg.n_bp = min(agg.n_bp, b_l[g])
            agg.n_strand_match += smatch_l[g]

    def merge_from(self, junctions: dict) -> None:
        """Fold another process's junction dict into this one — the
        final cross-host merge of a multi-process run (SURVEY.md §2.4
        DP row; all accumulators are commutative, so the result equals
        a joint single-process run bit for bit, including n_uniq:
        sequence SETS union rather than summing partial counts)."""
        self._drain_batches()
        for key, o in junctions.items():
            a = self.junctions.get(key)
            if a is None:
                self.junctions[key] = o
                continue
            a.n_reads += o.n_reads
            a.seqs |= o.seqs
            a.uniq_bridges += o.uniq_bridges
            a.best_qual_left = max(a.best_qual_left, o.best_qual_left)
            a.best_qual_right = max(a.best_qual_right, o.best_qual_right)
            a.edits = min(a.edits, o.edits)
            a.overlap = min(a.overlap, o.overlap)
            a.n_bp = min(a.n_bp, o.n_bp)
            a.n_strand_match += o.n_strand_match

    def _strandmatch(self, agg: JunctionAgg) -> str:
        if not self.cfg.stranded:
            return "NA"
        if agg.n_strand_match == agg.n_reads:
            return "MATCH"
        if agg.n_strand_match == 0:
            return "MISMATCH"
        return "PARTIAL"

    def _category(self, agg: JunctionAgg, strandmatch: str) -> str:
        return category_flags(agg.kind == KIND_CIRCULAR, agg.n_bp,
                              agg.uniq_bridges, agg.signal, strandmatch)

    def rows(self, sample_name: str = "sample", prefix: str = "") -> list[JunctionRow]:
        self._drain_batches()
        out = []
        for agg in self.junctions.values():
            chrom = self.genome.chrom_names[agg.chrom_idx]
            offset = int(self.genome.chrom_offsets[agg.chrom_idx])
            strandmatch = self._strandmatch(agg)
            out.append(JunctionRow(
                chrom=chrom,
                start=agg.start - offset,
                end=agg.end - offset,
                name="",  # assigned by renumber()
                n_reads=agg.n_reads,
                strand=SENSE_CHARS[agg.sense],
                n_uniq=len(agg.seqs),
                uniq_bridges=agg.uniq_bridges,
                best_qual_left=agg.best_qual_left,
                best_qual_right=agg.best_qual_right,
                tissues=sample_name,
                tiss_counts=str(agg.n_reads),
                edits=agg.edits,
                anchor_overlap=agg.overlap,
                breakpoints=agg.n_bp,
                signal=agg.signal,
                strandmatch=strandmatch,
                category=self._category(agg, strandmatch),
            ))
        self.stats.counts["circular_junctions"] = sum(
            1 for a in self.junctions.values() if a.kind == KIND_CIRCULAR)
        self.stats.counts["linear_junctions"] = sum(
            1 for a in self.junctions.values() if a.kind != KIND_CIRCULAR)
        return renumber(out, prefix)
