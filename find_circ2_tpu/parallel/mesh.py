"""Device mesh helpers.

The engine's mesh has two axes (SURVEY.md §2.4):
  "data"  — read batches stream data-parallel,
  "index" — the seed index shards k-mer-range tensor-parallel.
The cards of one host are joined all to all, so the shape follows the
algorithm alone: on four cards (2, 2), (4, 1) or (1, 4). Which is
fastest is measured, not assumed (ROADMAP R6). Several hosts extend
"data" across hosts, so the index's pmin/psum collectives stay within
one host (SURVEY.md §5 comm-backend row).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def factor_mesh(n_devices: int) -> tuple[int, int]:
    """(data, index) shape: prefer index parallelism up to 4, rest data."""
    for index in (4, 2, 1):
        if n_devices % index == 0:
            return n_devices // index, index
    return n_devices, 1


def make_mesh(n_devices: int | None = None,
              shape: tuple[int, int] | None = None) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    if shape is None:
        shape = factor_mesh(n)
    data, index = shape
    if data * index != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev = np.asarray(devices[:n]).reshape(data, index)
    return Mesh(dev, ("data", "index"))


def make_hier_mesh(dhost: int, data: int, index: int) -> Mesh:
    """Three-axis (dhost, data, index) mesh for the hierarchical junction
    merge (SURVEY.md §7 step 6): "dhost" spans hosts, "data" and
    "index" stay within a host. jax.devices() enumerates devices
    host-major, so reshaping keeps each host's devices contiguous on the
    trailing axes."""
    n = dhost * data * index
    devices = jax.devices()
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(dhost, data, index)
    return Mesh(dev, ("dhost", "data", "index"))
