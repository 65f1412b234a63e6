"""Multi-process execution scaffolding (BASELINE.json:11, SURVEY.md §2.4).

Topology: the global mesh is (data, index); "data" spans processes (each
process streams its own read shard and meets the others only for the
final junction merge), "index" stays within a process so K1's pmin/psum
collectives never leave it. The cards of one host are joined all to all
(NVLink), so no mesh axis assumes a ring or a torus. This module wires
jax.distributed and input sharding; the compute path is exactly
parallel/sharded.py — several processes is a mesh-construction change,
not an algorithm change.

`find_circ --nproc N` runs N processes on one host, one card each
(utils.device.card_for_process); tests run the same code as CPU
processes joined over Gloo (tests/test_multiproc_cli.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from find_circ2_tpu.config import Config
from find_circ2_tpu.index.build import SeedIndex
from find_circ2_tpu.io.genome import Genome
from find_circ2_tpu.parallel.sharded import ShardedEngine


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids: list[int] | None = None) -> None:
    """Initialize jax.distributed for a multi-process run. Call once per
    process before any jax computation. Nothing in the environment
    describes a cluster, so pass the coordinator (`host:port`), the
    process count and this process's id. `local_device_ids` pins the
    process to those local cards (None: every local device, as on the
    CPU)."""
    if num_processes is not None and num_processes > 1 or \
            coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id,
            local_device_ids=local_device_ids)
    # Single-process: nothing to do; jax.devices() already covers the
    # locally attached cards.


def global_mesh(index_parallel: int | None = None) -> Mesh:
    """Build the global (data, index) mesh over all devices of the job.

    `index_parallel` defaults to the number of local devices per process
    so the index axis never crosses a process boundary; the data axis
    takes the rest (processes x remaining cards).
    """
    devices = np.asarray(jax.devices())
    n = devices.size
    if index_parallel is None:
        index_parallel = max(1, jax.local_device_count())
        while n % index_parallel:
            index_parallel //= 2
    data = n // index_parallel
    return Mesh(devices.reshape(data, index_parallel), ("data", "index"))


def host_read_slice(path_records: int, host_id: int | None = None,
                    n_hosts: int | None = None) -> tuple[int, int]:
    """[start, stop) record range this host should stream from the input
    (contiguous split; junction merge is order-free so any split works)."""
    host_id = jax.process_index() if host_id is None else host_id
    n_hosts = jax.process_count() if n_hosts is None else n_hosts
    per = -(-path_records // n_hosts)
    start = min(host_id * per, path_records)
    return start, min(start + per, path_records)


def allreduce_counts(vec: "np.ndarray") -> "np.ndarray":
    """Sum an int64 counter vector across processes (SURVEY.md §5:
    psum-aggregated cross-host stats). Single-process: identity.

    Uses a one-device-per-process mesh so the collective payload is one
    tiny vector per process."""
    vec = np.asarray(vec, np.int64)
    if jax.process_count() == 1:
        return vec
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    devs = {}
    for d in jax.devices():
        devs.setdefault(d.process_index, d)
    one_per_proc = np.asarray([devs[p] for p in sorted(devs)])
    mesh = Mesh(one_per_proc, ("proc",))
    sh = NamedSharding(mesh, P("proc"))
    arr = jax.make_array_from_process_local_data(sh, vec[None, :])
    out = jax.jit(lambda x: jnp.sum(x, axis=0),
                  out_shardings=NamedSharding(mesh, P()))(arr)
    return np.asarray(out)


def stats_to_vec(stats, order: list[str]) -> "np.ndarray":
    """Stats counters -> fixed-order vector for allreduce_counts."""
    return np.asarray([stats.counts.get(k, 0) for k in order], np.int64)


def make_engine(genome: Genome, index: SeedIndex,
                cfg: Config = Config(), prefilter: bool = True,
                index_parallel: int | None = None) -> ShardedEngine:
    """ShardedEngine over the global mesh (works 1-process or N-process:
    jax.device_put with NamedSharding handles cross-host placement)."""
    return ShardedEngine(genome, index, global_mesh(index_parallel), cfg,
                         prefilter)
