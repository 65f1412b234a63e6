"""Accelerator selection, the start-up device line and the compile cache.

Every entry point (the CLI, bench.py, chip_smoke.py) calls
`enable_compile_cache` before its first compile. The device path calls
`require_gpu` before its first device operation: it runs on a GPU, or
on the XLA CPU backend only when the CPU was asked for explicitly
(`--platform cpu`, or `JAX_PLATFORMS=cpu`, which tests/conftest.py
sets through `jax.config`). It never falls through to the CPU quietly.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Fixed, in the checkout and listed in .gitignore: the path is part of
# the cache key, so a directory that moved between runs would never hit.
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else the checkout's fixed
    `.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compilation cache; returns its directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, is used as it is (JAX reads
    the variable itself) and nothing else is set. Otherwise the fixed
    in-checkout directory is set, except on an explicit CPU run: XLA's
    CPU executables reload with host-feature mismatch errors, so CPU
    runs compile afresh (returns None)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return compile_cache_dir()
    if cpu_requested():
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def cpu_requested() -> bool:
    """True when the CPU was asked for explicitly (jax_platforms == cpu)."""
    plats = jax.config.jax_platforms or ""
    return {p.strip() for p in plats.split(",") if p.strip()} == {"cpu"}


def require_gpu(prog: str = "find_circ") -> None:
    """Exit with a one-line message unless JAX runs on a GPU or the CPU
    was requested explicitly."""
    backend = jax.default_backend()
    if backend != "gpu" and not cpu_requested():
        raise SystemExit(
            f"{prog}: the device backend needs a GPU but JAX found "
            f"'{backend}'; pass --platform cpu or set JAX_PLATFORMS=cpu "
            f"to run on the CPU on purpose")


def device_line() -> str:
    """`platform=... device_kind=... count=...` of the running backend."""
    devs = jax.devices()
    return (f"platform={devs[0].platform} device_kind={devs[0].device_kind}"
            f" count={len(devs)}")


def visible_card_count() -> int:
    """GPUs this process may open, counted without starting a JAX
    backend: the entries of CUDA_VISIBLE_DEVICES when it is set, else the
    /dev/nvidiaN device nodes."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([v for v in vis.split(",") if v.strip()])
    try:
        return sum(1 for n in os.listdir("/dev")
                   if n.startswith("nvidia") and n[6:].isdigit())
    except OSError:
        return 0


def card_for_process(proc_id: int, nproc: int, n_cards: int) -> int:
    """Local card of rank `proc_id` in an `--nproc` run on one host: rank
    i owns card i, so no card is opened by two processes."""
    if nproc > n_cards:
        raise SystemExit(f"--nproc {nproc} needs one card per process, "
                         f"but {n_cards} card(s) are visible")
    if not 0 <= proc_id < nproc:
        raise SystemExit("--nproc requires --proc-id in [0, nproc)")
    return proc_id
