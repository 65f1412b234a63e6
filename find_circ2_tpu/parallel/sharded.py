"""Sharded multi-card detection step: shard_map over the (data, index)
mesh — optionally (dhost, data, index) for multi-host runs.

Reads stream data-parallel; the seed index is k-mer-range sharded
tensor-parallel (index/shard.py); anchor-hit statistics combine across
index shards with integer pmin/psum collectives (ops/anchor_align
.finalize_hits), which keeps results bit-identical to the single-card
path — the property tests/test_sharded.py asserts. Genome codes and the
breakpoint stage are replicated across "index" (K2's inputs are already
globally reduced), so only K1's tiny per-anchor statistics cross cards:
the collective payload is O(batch) int32s.

The junction merge is HIERARCHICAL when the mesh carries a "dhost" axis
(SURVEY.md §7 step 6): per-shard tables first all_gather + re-merge over
the intra-host "data" axis, then the already-collapsed tables cross
hosts over "dhost" — the cross-host payload is one deduplicated
table per host instead of one per card. Merging is associative and
commutative on integers, so both levels are bit-identical to a flat merge.

This realizes BASELINE.json:5/10/11's mandated parallelism; multi-host
execution only changes how the mesh is constructed (jax.distributed),
not this code.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from find_circ2_tpu.config import Config
from find_circ2_tpu.index.build import SeedIndex
from find_circ2_tpu.index.hashtable import shard_query_table
from find_circ2_tpu.io.genome import Genome
from find_circ2_tpu.models.pipeline import (PACK_FIELDS, detect_core,
                                            read_anchors)
from find_circ2_tpu.ops.anchor_align import align_anchor_pair
from find_circ2_tpu.ops.merge import merge_junctions, merge_tables
from find_circ2_tpu.ops.packed import pack_nibbles


def _data_axes(mesh: Mesh):
    return tuple(n for n in ("dhost", "data") if n in mesh.shape)


def _detect(gpacked, tables, metas, chrom_offsets, reads, lens, cfg,
            prefilter, nbases, rc=None):
    """Shared shard_map body (classic K1): cross-index-shard
    collectives, then the replicated-core detection. The K1 v4
    exact-first variant lives in sharded_detect_fn(fast=True); the
    collective junction-merge path stays on this classic body so
    on-device merged tables can never contain fallback-overflow rows."""
    table_l = tables[0]
    meta_l = metas[0]
    anchors_a, anchors_b = read_anchors(reads, lens, cfg)
    hits_a, hits_b = align_anchor_pair(table_l, meta_l, anchors_a,
                                       anchors_b, cfg, axis_name="index")
    return detect_core(gpacked, nbases, chrom_offsets, reads, lens,
                       hits_a, hits_b, cfg, prefilter, rc=rc)


def sharded_detect_fn(mesh: Mesh, cfg: Config, nbases: int,
                      prefilter: bool = True, packed: bool = False,
                      fast: bool = False):
    """Build the jitted sharded detect step over `mesh`.

    Signature of the returned fn:
        fn(gpacked[W], tables[nI, T, SLOTS*LANES], metas[nI, 3],
           chrom_offsets[C], reads[B, Lp], lens[B])
        -> dict of [B] arrays, or one int32 [B, len(PACK_FIELDS)] array
           when `packed` (same layout as pipeline.detect_batch_packed).
    With `fast`, the fn takes an extra per-shard neighbor-table operand
    after `tables` (K1 v4 exact-first; hashtable.shard_neighbor_tables)
    and the packed multi column carries the fallback-overflow flag in
    bit 3 exactly like detect_batch_packed_fast.
    B must divide evenly by the mesh's data axes.
    """
    da = _data_axes(mesh)

    def pack(res):
        sig = res["signal"].astype(jnp.int32)
        sigp = (sig[:, 0] | (sig[:, 1] << 3) | (sig[:, 2] << 6)
                | (sig[:, 3] << 9))
        cols = [res[k].astype(jnp.int32) for k in PACK_FIELDS[:-1]]
        cols.append(sigp)
        return jnp.stack(cols, axis=1)

    if fast:
        def step(gpacked, tables, ntables, metas, chrom_offsets, reads,
                 lens, rc):
            from find_circ2_tpu.ops.anchor_align import \
                align_anchor_pair_fast
            anchors_a, anchors_b = read_anchors(reads, lens, cfg)
            hits_a, hits_b, overflow = align_anchor_pair_fast(
                tables[0], ntables[0], metas[0], anchors_a, anchors_b,
                cfg, axis_name="index")
            res = detect_core(gpacked, nbases, chrom_offsets, reads,
                              lens, hits_a, hits_b, cfg, prefilter,
                              rc=rc)
            res["multi"] = res["multi"] | (overflow.astype(jnp.int32)
                                           << 3)
            return pack(res) if packed else res

        in_specs = (P(), P("index"), P("index"), P("index"), P(),
                    P(da), P(da), P(da))
    else:
        def step(gpacked, tables, metas, chrom_offsets, reads, lens,
                 rc):
            res = _detect(gpacked, tables, metas, chrom_offsets, reads,
                          lens, cfg, prefilter, nbases, rc=rc)
            return pack(res) if packed else res

        in_specs = (P(), P("index"), P("index"), P(), P(da), P(da),
                    P(da))

    smapped = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P(da),
        check_vma=False,
    )
    return jax.jit(smapped)


def sharded_detect_merge_fn(mesh: Mesh, cfg: Config, nbases: int,
                            prefilter: bool = True):
    """Like sharded_detect_fn, but additionally performs the collective
    junction dedup/merge on device (BASELINE.json:5/10): each data shard
    collapses its per-read records with a sort+segment combine, tables
    all_gather over the intra-host "data" axis and re-merge; with a
    "dhost" axis the collapsed tables then cross hosts and merge
    again — returning one replicated junction table. Multi-hit-flagged
    reads are EXCLUDED from the device table (res["multi"], SPEC §2b) —
    the host slow path re-calls and re-adds them."""

    def step(gpacked, tables, metas, chrom_offsets, reads, lens):
        res = _detect(gpacked, tables, metas, chrom_offsets, reads, lens,
                      cfg, prefilter, nbases)
        local = merge_junctions(res, lens, cfg)
        gathered = {k: jax.lax.all_gather(v, "data")
                    for k, v in local.items()}
        out = merge_tables(gathered)
        if "dhost" in mesh.shape:
            gathered2 = {k: jax.lax.all_gather(v, "dhost")
                         for k, v in out.items()}
            out = merge_tables(gathered2)
        return out

    da = _data_axes(mesh)
    smapped = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P("index"), P("index"), P(), P(da), P(da)),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(smapped)


class ShardedEngine:
    """Host-side wrapper: builds device arrays with the right shardings
    and runs batches through the sharded step."""

    def __init__(self, genome: Genome, index: SeedIndex, mesh: Mesh,
                 cfg: Config = Config(), prefilter: bool = True,
                 exact_first: bool | None = None) -> None:
        """`exact_first`: run K1 v4 (4 gathers/anchor, sharded psum/
        pmin combine) — None auto-enables it below genome scale (the
        one-time full-table neighbor aggregation costs ~8 us/key)."""
        self.cfg = cfg
        self.mesh = mesh
        n_index = mesh.shape["index"]
        self.n_data = 1
        for n in _data_axes(mesh):
            self.n_data *= mesh.shape[n]
        if exact_first is None:
            exact_first = index.positions.size <= (256 << 20)
        ntables = None
        if exact_first:
            from find_circ2_tpu.index.hashtable import (
                build_neighbor_table, build_query_table,
                shard_neighbor_tables)
            if index.qtable is None:
                index.qtable = build_query_table(index, cfg,
                                                 extras=False)
        tables, metas = shard_query_table(index, n_index, cfg)
        if exact_first:
            if index.qtable.ntable is None:
                index.qtable.ntable = build_neighbor_table(index, cfg)
            ntables = shard_neighbor_tables(index.qtable, tables)
        self.fast = ntables is not None
        self.fn = sharded_detect_fn(mesh, cfg, len(genome), prefilter,
                                    fast=self.fast)
        self.packed_fn = sharded_detect_fn(mesh, cfg, len(genome),
                                           prefilter, packed=True,
                                           fast=self.fast)
        # Classic program kept alongside for the fallback-overflow redo.
        self.classic_packed_fn = sharded_detect_fn(
            mesh, cfg, len(genome), prefilter, packed=True) \
            if self.fast else None
        self.merge_fn = sharded_detect_merge_fn(mesh, cfg, len(genome),
                                                prefilter)
        self._data_spec = P(_data_axes(mesh))

        def put(x, spec):
            return jax.device_put(x, NamedSharding(mesh, spec))

        self.gpacked = put(pack_nibbles(genome.codes), P())
        self.tables = put(tables, P("index"))
        self.metas = put(metas, P("index"))
        self.ntables = put(ntables, P("index")) if self.fast else None
        self.chrom_offsets = put(
            genome.chrom_offsets.astype(np.uint32), P())

    def _put_batch(self, reads: np.ndarray, lens: np.ndarray):
        """Place a batch (+ its host-computed rc, pipeline.revcomp_batch
        — the on-device construction is the slowest op in the core
        phase) with the data sharding. Single-process: plain device_put
        of the global array. Multi-process: `reads`/`lens` are this
        process's LOCAL slice of the global batch (global batch =
        concatenation over process index)."""
        from find_circ2_tpu.models.pipeline import revcomp_batch
        rc = revcomp_batch(reads, lens)
        sh = NamedSharding(self.mesh, self._data_spec)
        if jax.process_count() > 1:
            return (jax.make_array_from_process_local_data(sh, reads),
                    jax.make_array_from_process_local_data(sh, lens),
                    jax.make_array_from_process_local_data(sh, rc))
        return (jax.device_put(reads, sh), jax.device_put(lens, sh),
                jax.device_put(rc, sh))

    def _args(self, reads_d, lens_d, rc_d, classic: bool = False):
        if self.fast and not classic:
            return (self.gpacked, self.tables, self.ntables, self.metas,
                    self.chrom_offsets, reads_d, lens_d, rc_d)
        return (self.gpacked, self.tables, self.metas,
                self.chrom_offsets, reads_d, lens_d, rc_d)

    def detect(self, reads: np.ndarray, lens: np.ndarray):
        """reads uint8 [B, Lp], lens int32 [B]; B % n_data == 0.
        Synchronous; transparently redoes a fallback-overflow batch on
        the classic program (multi bit 3, K1 v4)."""
        reads_d, lens_d, rc_d = self._put_batch(reads, lens)
        out = self.fn(*self._args(reads_d, lens_d, rc_d))
        out = {k: np.asarray(v) for k, v in out.items()}
        if self.fast and (out["multi"] & 8).any():
            packed = self.classic_packed_fn(
                *self._args(reads_d, lens_d, rc_d, classic=True))
            from find_circ2_tpu.models.pipeline import unpack_results
            out = unpack_results(np.asarray(packed))
        return out

    def dispatch_packed(self, reads: np.ndarray, lens: np.ndarray):
        """Async packed dispatch for streaming loops (pipeline.run_reads
        `dispatch`): returns the device array without blocking. Callers
        must pair with `redo_packed` on the multi-bit-3 overflow flag
        (the streaming loops do — pipeline.run_reads/stream.run_fastq
        `redo`)."""
        reads_d, lens_d, rc_d = self._put_batch(reads, lens)
        return self.packed_fn(*self._args(reads_d, lens_d, rc_d))

    def redo_packed(self, reads: np.ndarray, lens: np.ndarray):
        """Classic-program packed dispatch (fallback-overflow redo)."""
        if not self.fast:
            return self.dispatch_packed(reads, lens)
        reads_d, lens_d, rc_d = self._put_batch(reads, lens)
        return self.classic_packed_fn(
            *self._args(reads_d, lens_d, rc_d, classic=True))

    def detect_merged(self, reads: np.ndarray, lens: np.ndarray):
        """Full sharded detect + on-device collective junction merge."""
        reads_d, lens_d, _ = self._put_batch(reads, lens)
        out = self.merge_fn(self.gpacked, self.tables, self.metas,
                            self.chrom_offsets, reads_d, lens_d)
        return {k: np.asarray(v) for k, v in out.items()}
