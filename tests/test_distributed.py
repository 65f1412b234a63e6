"""Real N-process jax.distributed exercise: two OS
processes, each with 4 virtual CPU devices, form one global mesh whose
"data" (or "dhost") axis crosses the process boundary — collectives ride
Gloo, the CPU stand-in for DCN. The merged junction table and the psum'd
stats must match a single-process run exactly."""

import json
import socket
import subprocess
import sys
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from find_circ2_tpu.config import Config, RPAD_CODE
from find_circ2_tpu.index.build import build_index
from find_circ2_tpu.io.twobit import seq_to_codes
from find_circ2_tpu.models.pipeline import DeviceIndex, detect_batch
from find_circ2_tpu.ops.merge import merge_junctions
from find_circ2_tpu.utils.simulate import simulate

CFG = Config()
WORKER = os.path.join(os.path.dirname(__file__), "nproc_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _expected():
    """Single-process ground truth: same sim, single-chip detect+merge."""
    sim = simulate(seed=77, n_circ=5, n_linear=3, reads_per_junction=4,
                   n_contiguous=8, n_random=4, err_rate=0.3)
    idx = build_index(sim.genome, CFG)
    B = 64
    reads = np.full((B, CFG.max_read_len), RPAD_CODE, np.uint8)
    lens = np.zeros(B, np.int32)
    kept = [(n, s) for n, s in sim.reads
            if 2 * CFG.anchor_len <= len(s) <= CFG.max_read_len][:B]
    for i, (_, s) in enumerate(kept):
        codes = seq_to_codes(s)
        reads[i, :codes.size] = codes
        lens[i] = codes.size
    dindex = DeviceIndex.build(sim.genome, idx, CFG)
    res = detect_batch(dindex.gpacked, dindex.nbases, dindex.table,
                       dindex.meta, dindex.chrom_offsets, reads, lens,
                       CFG, True)
    merged = merge_junctions(res, jnp.asarray(lens), CFG)
    merged = {k: np.asarray(v) for k, v in merged.items()}
    n = int(merged["valid"].sum())
    return {k: v[:n].tolist() for k, v in merged.items()}, n


def _run_workers(tmp_path, hier: bool):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ("/root/repo" + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env.pop("JAX_PLATFORMS", None)   # workers force cpu themselves
    args = [sys.executable, WORKER, None, "2", str(port), str(tmp_path)]
    if hier:
        args.append("hier")
    procs = []
    for pid in range(2):
        a = list(args)
        a[2] = str(pid)
        procs.append(subprocess.Popen(a, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [json.load(open(tmp_path / f"out_{pid}.json"))
            for pid in range(2)]


@pytest.mark.parametrize("hier", [False, True])
def test_two_process_merge_matches_single(tmp_path, hier):
    want_table, want_n = _expected()
    results = _run_workers(tmp_path, hier)
    for pid, got in enumerate(results):
        assert got["n"] == want_n, (pid, got["mesh"])
        for k, v in want_table.items():
            assert got["table"][k] == v, (pid, k)
        # psum'd stats: 2 hosts x 32 local reads, n junctions each side.
        assert got["counts"] == [64, 2 * want_n]
    if hier:
        assert results[0]["mesh"] == {"dhost": 2, "data": 2, "index": 2}
