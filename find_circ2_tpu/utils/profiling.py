"""Stage timers and throughput counters.

The reference offers only ad-hoc progress counters (SURVEY.md §5); here
every pipeline stage is timed and the north-star reads/s figure
(BASELINE.json:2) is first-class. `jax_trace` wraps jax.profiler for
device-level traces.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class StageTimes:
    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    n_reads: int = 0

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def add_reads(self, n: int) -> None:
        self.n_reads += n

    def report(self, wall: float | None = None) -> str:
        """Stage table, most expensive first.

        With `wall` (end-to-end seconds measured by the caller), a
        residual line shows how much wall time the stage timers do NOT
        cover — so untimed cost can never hide —
        and reads_per_s is computed over the true wall, not the timed
        subtotal."""
        lines = []
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(),
                              key=lambda kv: -kv[1]):
            lines.append(f"{name}\t{t:.3f}s\t{self.counts[name]}x")
        if wall is not None:
            resid = wall - total
            lines.append(f"wall\t{wall:.3f}s\tuntimed residual "
                         f"{resid:.3f}s ({100 * resid / wall:.0f}%)")
        if self.n_reads and (wall or total):
            lines.append(
                f"reads_per_s\t{self.n_reads / (wall or total):,.0f}")
        return "\n".join(lines)


@dataclass
class CompileStats:
    """Seconds JAX spent compiling (persistent-cache loads included),
    programs compiled, and persistent-cache hits, counted from
    jax.monitoring events once `listen` has been called."""
    seconds: float = 0.0
    programs: int = 0
    cache_hits: int = 0

    def listen(self) -> "CompileStats":
        import jax.monitoring

        def on_duration(event, secs, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.seconds += secs
                self.programs += 1

        def on_event(event, **_):
            if event == "/jax/compilation_cache/cache_hits":
                self.cache_hits += 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)
        return self

    def line(self) -> str:
        return (f"compile\t{self.seconds:.3f}s\t{self.programs}x programs, "
                f"{self.cache_hits} persistent-cache hits")


@contextlib.contextmanager
def jax_trace(logdir: str | None):
    """Wrap a block in a jax.profiler trace when logdir is given."""
    if not logdir:
        yield
        return
    import jax.profiler
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
