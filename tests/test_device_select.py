"""Device selection, the compile cache, the bench peak table, the K2
prefix sum and `--nproc` card pinning: what can be checked without a
card. The guard and cache tests replace `jax` inside utils.device with a
stand-in, so they pass on any machine."""

import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest

from find_circ2_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_jax(monkeypatch, backend, platforms):
    updates = {}
    fake = SimpleNamespace(
        default_backend=lambda: backend,
        config=SimpleNamespace(jax_platforms=platforms,
                               update=lambda k, v: updates.__setitem__(k, v)))
    monkeypatch.setattr(device, "jax", fake)
    return updates


@pytest.mark.parametrize("backend,platforms,refused", [
    ("gpu", None, False),
    ("gpu", "cuda", False),
    ("cpu", None, True),           # silent fall-through: refused
    ("cpu", "", True),
    ("cpu", "cuda,cpu", True),     # CPU only as a fallback: refused
    ("cpu", "cpu", False),         # --platform cpu / JAX_PLATFORMS=cpu
    ("rocm", None, True),
])
def test_require_gpu_refuses_non_gpu_unless_cpu_requested(
        monkeypatch, backend, platforms, refused):
    _fake_jax(monkeypatch, backend, platforms)
    if refused:
        with pytest.raises(SystemExit, match="needs a GPU"):
            device.require_gpu()
    else:
        device.require_gpu()


def test_cli_device_backend_refuses_cpu_fallback(monkeypatch, tmp_path):
    """The CLI's device backend exits before any work on a non-GPU
    backend that was not asked for."""
    from find_circ2_tpu.cli import find_circ
    _fake_jax(monkeypatch, "cpu", None)
    with pytest.raises(SystemExit, match="needs a GPU"):
        find_circ.main([str(tmp_path / "r.fastq"), "--reads-format",
                        "fastq", "-G", str(tmp_path / "g.fa")])


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    updates = _fake_jax(monkeypatch, "gpu", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)
    assert device.enable_compile_cache() == str(tmp_path)
    assert updates == {}           # JAX reads the variable itself


def test_compile_cache_fixed_in_checkout_path(monkeypatch):
    updates = _fake_jax(monkeypatch, "gpu", None)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = device.enable_compile_cache()
    second = device.enable_compile_cache()
    assert first == second == device.compile_cache_dir()
    assert first == os.path.join(REPO, ".jax_cache")
    assert updates == {"jax_compilation_cache_dir": first}
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_off_for_explicit_cpu(monkeypatch):
    updates = _fake_jax(monkeypatch, "cpu", "cpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.enable_compile_cache() is None
    assert updates == {}


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_peaks_hold_h100_and_refuse_unknown():
    bench = _bench()
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["bf16_flops_per_s"] == 989e12
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H200"):
        with pytest.raises(ValueError, match="no published peaks"):
            bench.device_peaks(kind)


def test_bench_roofline_is_bytes_bound():
    from find_circ2_tpu.config import Config
    bench = _bench()
    cfg = Config()
    fast = bench.roofline_reads_per_s(cfg, 100, 3.35e12, exact_first=True)
    classic = bench.roofline_reads_per_s(cfg, 100, 3.35e12)
    # Classic K1 reads 244 rows of 32 B per read, exact-first ~8.
    assert classic < fast
    per_read = 3.35e12 / classic
    assert 244 * 32 < per_read < 244 * 32 + 1024


@pytest.mark.parametrize("rows", ["ones", "random", "zeros"])
def test_k2_prefix_sum_exact(rows):
    """The K2/explore prefix sum equals np.cumsum exactly at Lp=160,
    worst case all-ones rows included."""
    import jax
    from find_circ2_tpu.ops.breakpoint import prefix_sum_rows
    rng = np.random.default_rng(3)
    shape = (2 * 512, 160)
    ind = {"ones": np.ones(shape, bool), "zeros": np.zeros(shape, bool),
           "random": rng.random(shape) < 0.5}[rows]
    got = np.asarray(jax.jit(prefix_sum_rows)(ind))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.cumsum(ind, axis=1))


def test_nproc_pins_process_i_to_card_i():
    """Rank i of an --nproc run owns local card i: distinct cards,
    checked against the 8 virtual CPU devices."""
    import jax
    devs = jax.devices()
    nproc = 4
    cards = [device.card_for_process(i, nproc, len(devs))
             for i in range(nproc)]
    assert cards == list(range(nproc))
    assert len({devs[c].id for c in cards}) == nproc
    with pytest.raises(SystemExit, match="one card per process"):
        device.card_for_process(0, len(devs) + 1, len(devs))


def test_visible_card_count_reads_cuda_visible_devices(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2")
    assert device.visible_card_count() == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert device.visible_card_count() == 0


def test_cli_refuses_more_processes_than_cards(monkeypatch, tmp_path):
    from find_circ2_tpu.cli import find_circ
    monkeypatch.setattr(device, "cpu_requested", lambda: False)
    monkeypatch.setattr(device, "visible_card_count", lambda: 1)
    with pytest.raises(SystemExit, match="one card per process"):
        find_circ.main([str(tmp_path / "r.fastq"), "--reads-format",
                        "fastq", "-G", str(tmp_path / "g.fa"),
                        "-o", str(tmp_path / "o.bed"), "--nproc", "2",
                        "--proc-id", "0"])


def test_rescue_pool_is_a_thread():
    """The rescue worker never forks: it is a thread of this process."""
    from multiprocessing.pool import ThreadPool
    from find_circ2_tpu.config import Config
    from find_circ2_tpu.index.build import build_index
    from find_circ2_tpu.models.stream import _RescuePool
    from find_circ2_tpu.utils.simulate import simulate
    sim = simulate(seed=5, n_circ=2, n_linear=1)
    pool = _RescuePool(sim.genome, build_index(sim.genome, Config()),
                       Config(), True)
    try:
        assert isinstance(pool.pool, ThreadPool)
    finally:
        pool.close()
