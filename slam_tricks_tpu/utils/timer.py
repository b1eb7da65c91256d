"""Scoped wall-clock timing with device synchronization — the ns_timer role
(reference: artwork timer usage around each solver call, e.g.
st17-ceres/src/include/solver.hpp:253-288) adapted to JAX's async dispatch:
every stop() calls block_until_ready on tracked outputs so timings are real.
"""

import statistics
import time
from contextlib import contextmanager

import jax


class Timer:
    """t = Timer(); ...; t.lap("stage"); print(t.report())"""

    def __init__(self):
        self._t0 = time.perf_counter()
        self.laps = []

    def re_start(self):
        self._t0 = time.perf_counter()

    def lap(self, tag, sync=None):
        if sync is not None:
            jax.block_until_ready(sync)
        now = time.perf_counter()
        self.laps.append((tag, now - self._t0))
        self._t0 = now
        return self.laps[-1][1]

    def report(self):
        return " | ".join(f"{tag}: {dt * 1e3:.3f} ms" for tag, dt in self.laps)


@contextmanager
def timed(tag="block", out=None, log=None):
    """with timed("solve", out=result): ... — blocks on `out` at exit."""
    t0 = time.perf_counter()
    yield
    if out is not None:
        jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    msg = f"{tag}: {dt * 1e3:.3f} ms"
    if log is not None:
        log.process(msg)
    else:
        print(msg)


@contextmanager
def profile_trace(log_dir, *, host_profiler=False):
    """jax.profiler trace context (SURVEY §5 tracing/profiling): wraps the
    body in `jax.profiler.trace(log_dir)` so device timelines land in
    TensorBoard/XProf format under log_dir. Usage:

        with profile_trace("/tmp/trace"):
            out = solve(...); jax.block_until_ready(out)
    """
    with jax.profiler.trace(log_dir, create_perfetto_link=False,
                            create_perfetto_trace=host_profiler):
        yield


def annotate(name):
    """Named region for profiler timelines (TraceAnnotation role)."""
    return jax.profiler.TraceAnnotation(name)


def time_median(fn, *args, warmup=1, reps=5):
    """Median wall time of `reps` calls that each end in block_until_ready,
    after `warmup` untimed calls (which absorb compilation). Returns
    (median_seconds, per-call seconds, last result)."""
    result = None
    for _ in range(warmup):
        result = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        result = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times, result
