"""Production streaming path: FASTQ file -> device batches with the
native C loader, bypassing per-read Python objects.

`run_fastq` produces results identical to pipeline.run_reads (the tests
assert BED-level equality) but parses and encodes whole chunks natively
(find_circ2_tpu/native): the host-side analog of the reference's
C-backed I/O chain (SURVEY.md §3.1 bowtie2|samtools pipes). Python-level
record handling happens only for junction-supporting reads (a small
fraction of a typical library).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from find_circ2_tpu.config import (RPAD_CODE, Config, ST_JUNCTION,
                                   ST_PREFILTERED, ST_TOO_LONG,
                                   ST_TOO_SHORT, ST_UNALIGNED_A,
                                   ST_UNALIGNED_B)
from find_circ2_tpu.io.twobit import _CODE_LUT, codes_to_seq
from find_circ2_tpu.models.aggregate import Aggregator, seq_hash_batch
from find_circ2_tpu.models.oracle import ReadCall
from find_circ2_tpu.models.pipeline import (DeviceIndex, dispatch_packed,
    redo_if_overflow, unpack_results)
from find_circ2_tpu import native

CHUNK = 16 << 20  # bytes per read(2) chunk


class _RescuePool:
    """One worker thread that runs the batched 2-mm rescue
    (multihit.call_reads_multi_batch) off the critical path, the way the
    reference overlapped bowtie2's threads with find_circ.py's stream
    (SURVEY.md §3.1). A thread, not a forked process: a fork after the
    CUDA backend has started copies a process that holds a device
    context and JAX's threads, which can deadlock the child. The rescue
    is numpy work that releases the GIL in its large array passes, so it
    still overlaps the loop's other host stages. Any failure (crash,
    timeout) permanently falls back to in-line calls — results are
    identical either way, rescue batches are keyed and consumed in
    order."""

    TIMEOUT_S = 120.0

    def __init__(self, genome, index, cfg, prefilter: bool) -> None:
        from multiprocessing.pool import ThreadPool
        self.args = (genome, index, cfg, prefilter)
        self.pool = ThreadPool(1)

    def submit(self, items):
        if self.pool is None:
            return items          # sync marker: compute at fetch time
        try:
            return self.pool.apply_async(_rescue, self.args[:2]
                                         + (items,) + self.args[2:])
        except Exception:
            self._disable()
            return items

    def fetch(self, handle):
        if isinstance(handle, list):  # sync marker
            return _rescue(*self.args[:2], handle, *self.args[2:])
        try:
            return handle.get(timeout=self.TIMEOUT_S)
        except Exception:
            # Worker died or hung: drop it, recompute in line, and stay
            # in line for the rest of the run.
            items = handle._fc2_items
            self._disable()
            return self.fetch(items)

    def submit_tagged(self, items):
        h = self.submit(items)
        if not isinstance(h, list):
            h._fc2_items = items
        return h

    def _disable(self) -> None:
        if self.pool is not None:
            try:
                self.pool.terminate()
            except Exception:
                pass
            self.pool = None

    def close(self) -> None:
        self._disable()


def _rescue(genome, index, items, cfg, prefilter):
    from find_circ2_tpu.models.multihit import call_reads_multi_batch
    return call_reads_multi_batch(genome, index, items, cfg, prefilter)


def _iter_records(path):
    """Yield (buffer, spans) chunks via the native FASTQ scanner."""
    opener = gzip.open if os.fspath(path).endswith(".gz") else open
    with opener(path, "rb") as fh:
        pending = b""
        while True:
            chunk = fh.read(CHUNK)
            buf = pending + chunk
            if not buf:
                return
            spans, resume = native.parse_fastq(buf)
            if spans.shape[0] == 0 and not chunk:
                if resume < len(buf):
                    raise ValueError("trailing partial FASTQ record")
                return
            yield buf, spans
            pending = buf[resume:]
            if not chunk and not pending:
                return
            if not chunk and pending:
                raise ValueError("trailing partial FASTQ record")


def run_fastq(dindex: DeviceIndex | None, path, agg: Aggregator,
              cfg: Config = Config(), prefilter: bool = True,
              batch_size: int | None = None, times=None,
              pipeline_depth: int = 4, slowpath=None,
              journal=None, revcomp: bool = False,
              explore: bool | None = None, dispatch=None,
              shard: tuple[int, int] | None = None, redo=None) -> None:
    """Stream a FASTQ(.gz) file through the device pipeline into `agg`.

    Dispatch is pipelined `pipeline_depth` batches deep with packed
    single-array readback (pipeline.detect_batch_packed), so each batch's
    readback wait overlaps device compute of the next. Aggregation is
    order-insensitive (the junction merge is associative/commutative),
    so consumption order does not affect output.

    `slowpath` = (genome, index) enables SPEC §2b multi-hit pairing;
    `explore` picks how (exactly as pipeline.run_reads: None = auto-use
    the device program when the index has §2b extras, True = force
    device, False = force the vectorized host path). `dispatch(arr,
    lens) -> packed device array` overrides the single-chip device step
    exactly as in run_reads — the sharded engine's collective step
    (parallel.sharded.ShardedEngine.dispatch_packed) plugs in here, so
    sharded CLI runs ride the chunked native encode instead of the
    per-read Python loop `journal`
    (utils.journal.RunJournal): completed device batches replay from
    compact FastBatch records on rerun — crash-resume on the production
    path.

    `revcomp=True` reverse-complements every read after encoding — the
    --pe mate-2 transform (SPEC.md §7); junction ReadCalls then carry the
    reverse-complemented sequence (it is the processed read).

    `shard=(proc_id, nproc)` is the multi-process mode (`find_circ
    --nproc`, SURVEY.md §7 step 6): every process scans the file but
    encodes/detects only batches with batch_id % nproc == proc_id —
    batch-granular round-robin, so multi-host runs ride this native
    fast path instead of the per-read Python loop
    Stats cover only owned batches (plus file-level too-short/too-long
    counts on proc 0 alone); callers psum them across processes. The
    union over all ranks processes each read exactly once, and the
    junction merge is order-free, so the merged output is byte-identical
    to a single-process run (tests/test_multiproc_cli.py)."""
    import contextlib
    from collections import deque

    assert native.available(), "native loader unavailable; use run_reads"
    bs = batch_size or cfg.batch_size
    Lp = cfg.max_read_len
    a2 = 2 * cfg.anchor_len
    inflight: deque = deque()   # (batch_id, buf, spans, sel, packed)
    done = journal.completed_batches() if journal is not None else {}
    next_batch_id = 0
    explorer = None
    if explore is None:
        explore = (slowpath is not None and dindex is not None
                   and dindex.ext is not None)
    if explore:
        from find_circ2_tpu.models.pipeline import DeviceExplorer
        explorer = DeviceExplorer(dindex, cfg, prefilter)
    rpool = None
    if (slowpath is not None and cfg.rescue_anchor_mm >= 2
            and journal is None):
        rpool = _RescuePool(slowpath[0], slowpath[1], cfg, prefilter)
    # Stage 2: batches whose routed reads await explore results.
    # (batch_id, n_reads, counts, batch_calls, explore_handle, rhashes,
    #  rescue_handle, multihit_handle)
    finishing: deque = deque()

    def timed(name):
        return times.stage(name) if times is not None \
            else contextlib.nullcontext()

    def finalize() -> None:
        batch_id, n_reads, counts, batch_calls, handle, rhashes, \
            rhandle, mhandle = finishing.popleft()
        if rhandle is not None:
            with timed("slowpath_rescue"):
                batch_calls = batch_calls + rpool.fetch(rhandle)
        if mhandle is not None:
            with timed("slowpath_multihit"):
                batch_calls = batch_calls + rpool.fetch(mhandle)
        if handle is not None and rhashes is not None:
            # Array-mode explore results: vectorized aggregation via
            # add_batch (same hashes the detect rows used), statuses
            # counted in bulk — no per-read ReadCall/seq_hash cost.
            with timed("explore_multihit"):
                resx = explorer.fetch_arrays(handle)
            with timed("aggregate"):
                st_x = resx["status"]
                jm = st_x == ST_JUNCTION
                agg.add_batch(resx, np.flatnonzero(jm), rhashes[jm])
                n_rest = int(st_x.size - jm.sum())
                if n_rest:
                    agg.stats.add("reads_total", n_rest)
                    rest = st_x[~jm]
                    for st in np.unique(rest):
                        agg.stats.add_status(int(st),
                                             int((rest == st).sum()))
        elif handle is not None:
            with timed("explore_multihit"):
                batch_calls = batch_calls + explorer.fetch(handle)
        with timed("aggregate"):
            for call in batch_calls:
                agg.add(call)
        if journal is not None:
            from find_circ2_tpu.utils.journal import FastBatch
            journal.record_fast(batch_id, FastBatch(
                n_reads=n_reads, counts=counts, calls=batch_calls))
        if times is not None:
            times.add_reads(n_reads)

    def replay(fast, expect_reads: int) -> None:
        from find_circ2_tpu.utils.journal import FastBatch
        assert isinstance(fast, FastBatch), \
            "journal was written by the per-read path; use run_reads"
        if fast.n_reads != expect_reads:
            raise ValueError(
                f"journal batch has {fast.n_reads} reads, input has "
                f"{expect_reads}: input changed since journal")
        agg.stats.add("reads_total",
                      fast.n_reads - len(fast.calls))
        for st, n in fast.counts.items():
            agg.stats.add_status(int(st), n)
        for call in fast.calls:
            agg.add(call)

    def consume() -> None:
        batch_id, buf, spans, sel, packed, arr, blens = \
            inflight.popleft()
        with timed("device_detect"):
            res = unpack_results(np.asarray(packed))
            # K1 v4 fallback overflow (multi bit 3): redo through the
            # classic program — the sharded engine's via `redo`, the
            # single-chip one via the index.
            if redo is not None and (res["multi"] & 8).any():
                res = unpack_results(np.asarray(redo(arr, blens)))
            else:
                res = redo_if_overflow(dindex, res, arr, blens, cfg,
                                       prefilter)
        # NOTE: the slow-path loops below keep their own timers; the
        # "aggregate" stage must not enclose them or the report
        # double-counts (negative wall residual).
        with timed("aggregate"):
            status = res["status"][:sel.size]
            # §2 2-mm anchor rescue [FROZEN v4]: device-unaligned reads
            # re-call on the host slow path, which widens the failing
            # anchor's ball when the mate aligned (oracle-mirrored).
            # Takes precedence over explore routing: the device explore
            # program knows only the <=1-mm ball. Gated on the device
            # rescuable bit (multi bit 1): only reads with EXACTLY one
            # failed anchor can pass the host mate gate, so junk with
            # both anchors unaligned keeps its device status free.
            if slowpath is not None and cfg.rescue_anchor_mm >= 2:
                rescue = (np.isin(status,
                                  (ST_UNALIGNED_A, ST_UNALIGNED_B))
                          & ((res["multi"][:sel.size] & 2) != 0))
            else:
                rescue = np.zeros(sel.size, bool)
            if slowpath is not None or explorer is not None:
                route = ((res["multi"][:sel.size] & 1) != 0) \
                    & (status != ST_PREFILTERED) & ~rescue
            else:
                route = np.zeros(sel.size, bool)
            plain_skip = (status != ST_JUNCTION) & ~route & ~rescue
            counts: dict[int, int] = {}
            if plain_skip.any():
                agg.stats.add("reads_total", int(plain_skip.sum()))
            for st in np.unique(status[plain_skip]):
                n = int((status[plain_skip] == st).sum())
                counts[int(st)] = n
                agg.stats.add_status(int(st), n)
            def read_seq(i: int) -> str:
                k = sel[i]
                seq = buf[spans[k, 2]:spans[k, 3]].decode("ascii")
                if revcomp:
                    from find_circ2_tpu.io.twobit import revcomp_seq
                    seq = revcomp_seq(seq)
                return seq

            def read_name(i: int) -> str:
                k = sel[i]
                return buf[spans[k, 0]:spans[k, 1]].decode("ascii")

            batch_calls: list[ReadCall] = []
            routed: list[tuple[str, str]] = []
            ridx_route = np.nonzero(route)[0]
            jidx = np.nonzero((status == ST_JUNCTION) & ~route)[0]
            rhashes = None
            if journal is None:
                # n_uniq hashes, lazily and only for rows that need
                # them (junction + routed; typically a fraction of the
                # batch — full-batch hashing cost ~5 ms/batch).
                need = np.concatenate([jidx, ridx_route])
                hh = seq_hash_batch(arr[need]) if need.size else \
                    np.empty(0, np.uint64)
                # Vectorized junction aggregation: one update per
                # distinct junction, no per-read ReadCall objects —
                # journal runs keep the per-read path below so replay
                # records stay complete.
                agg.add_batch(res, jidx, hh[:jidx.size])
                rhashes = hh[jidx.size:]
                jidx = jidx[:0]
            for i in jidx:
                batch_calls.append(ReadCall(
                    name=read_name(i), seq=read_seq(i),
                    status=ST_JUNCTION,
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
                ))
        mhandle = None
        if explorer is not None and journal is None:
            # Array-mode explore: reuse the batch's encoded rows and
            # the lazily computed hashes above — the finalize stage
            # aggregates the unpacked result arrays directly
            # (add_batch), no per-read string decode / ReadCall /
            # scalar seq_hash.
            pass
        elif explorer is not None:
            rhashes = None
            for i in ridx_route:
                # SPEC §2b multi-hit pair exploration on the device
                # program (ops/explore.py), per-read ReadCalls for the
                # journal's replay records.
                routed.append((read_name(i), read_seq(i)))
        else:
            # No device explore program (sharded engines: the collective
            # step has no §2b twin) — run the vectorized host twin
            # batched over ALL routed reads (models/multihit.
            # call_reads_multi_batch == batched call_read_multi), async
            # via the rescue worker when one exists.
            rhashes = None
            if ridx_route.size:
                items = [(read_name(i), read_seq(i))
                         for i in ridx_route]
                if rpool is not None:
                    with timed("rescue_dispatch"):
                        mhandle = rpool.submit_tagged(items)
                else:
                    from find_circ2_tpu.models.multihit import \
                        call_reads_multi_batch
                    with timed("slowpath_multihit"):
                        batch_calls.extend(call_reads_multi_batch(
                            slowpath[0], slowpath[1], items, cfg,
                            prefilter))
        ridx = np.nonzero(rescue)[0]
        rhandle = None
        if ridx.size:
            # ONE vectorized host program for the whole batch's rescued
            # reads (models/multihit.call_reads_multi_batch) — the r4
            # per-read loop cost ~5 ms/read, 91% of pipeline wall. With
            # a rescue pool it runs on the worker thread, overlapping
            # this loop's other stages; fetched one batch later in
            # finalize.
            items = [(read_name(i), read_seq(i)) for i in ridx]
            if rpool is not None:
                with timed("rescue_dispatch"):
                    rhandle = rpool.submit_tagged(items)
            else:
                from find_circ2_tpu.models.multihit import \
                    call_reads_multi_batch
                with timed("slowpath_rescue"):
                    batch_calls.extend(call_reads_multi_batch(
                        slowpath[0], slowpath[1], items, cfg,
                        prefilter))
        handle = None
        if rhashes is not None and ridx_route.size:
            with timed("explore_dispatch"):
                handle = explorer.dispatch_arrays(arr[ridx_route],
                                                  blens[ridx_route])
        elif rhashes is not None:
            rhashes = None
        elif routed:
            with timed("explore_dispatch"):
                handle = explorer.dispatch(routed)
        finishing.append((batch_id, int(sel.size), counts,
                          batch_calls, handle, rhashes, rhandle,
                          mhandle))
        # Keep explore-pending batches in flight so their programs (and
        # the rescue worker) overlap later batches' host work —
        # same depth as the detect pipeline.
        while len(finishing) > pipeline_depth:
            finalize()

    def process(buf: bytes, spans: np.ndarray) -> None:
        nonlocal next_batch_id
        with timed("encode"):
            lens_all = (spans[:, 3] - spans[:, 2]).astype(np.int64)
            short = lens_all < a2
            long_ = lens_all > Lp
            ok_idx = np.nonzero(~short & ~long_)[0]
        if shard is None or shard[0] == 0:
            # Out-of-batch reads are counted once, by rank 0.
            for st, mask in ((ST_TOO_SHORT, short), (ST_TOO_LONG, long_)):
                cnt = int(mask.sum())
                if cnt:
                    agg.stats.add("reads_total", cnt)
                    agg.stats.add_status(st, cnt)
        for lo in range(0, ok_idx.size, bs):
            batch_id = next_batch_id
            next_batch_id += 1
            if shard is not None and batch_id % shard[1] != shard[0]:
                continue
            if batch_id in done:
                replay(done[batch_id], min(bs, ok_idx.size - lo))
                continue
            sel = ok_idx[lo:lo + bs]
            arr = np.full((bs, Lp), RPAD_CODE, np.uint8)
            lens = np.zeros(bs, np.int32)
            with timed("encode"):
                native.encode_reads(buf, spans[sel, 2], spans[sel, 3],
                                    arr[:sel.size], lens[:sel.size],
                                    _CODE_LUT)
                if revcomp:
                    # Vectorized in-place reverse complement per true
                    # length; padding rows (lens 0) stay RPAD via the
                    # in-read mask.
                    pos = np.arange(Lp, dtype=np.int64)[None, :]
                    idx = np.clip(lens[:, None] - 1 - pos, 0, Lp - 1)
                    r = np.take_along_axis(arr, idx, axis=1)
                    r = np.where(r < 4, 3 - r, r)
                    arr = np.where(pos < lens[:, None], r,
                                   RPAD_CODE).astype(np.uint8)
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
            inflight.append((batch_id, buf, spans, sel, packed,
                             arr, lens))
            if len(inflight) > pipeline_depth:
                consume()

    # The chunk iterator (file read + gzip + native FASTQ scan) is timed
    # as its own stage so I/O cost can't hide in the wall residual.
    try:
        it = _iter_records(path)
        while True:
            with timed("read_parse"):
                item = next(it, None)
            if item is None:
                break
            process(*item)
        while inflight:
            consume()
        while finishing:
            finalize()
    finally:
        if rpool is not None:
            rpool.close()
