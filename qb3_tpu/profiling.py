"""Profiling hooks (SURVEY §5 tracing/observability).

The reference keeps timing in its callers (cqb3.cpp:478-481 MB/s prints);
the device equivalent is a `jax.profiler` trace plus the same rate counters:

    with qb3_tpu.profiling.trace("/tmp/qb3-trace"):
        stream = qb3_tpu.encode(img)
    # inspect with TensorBoard, or tools/trace_bench.py's event summary

    with qb3_tpu.profiling.meter(img.nbytes) as m:
        qb3_tpu.encode(img)
    print(m.mbps)

The CLI exposes `--trace DIR` on both directions.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str, host: bool = False):
    """Capture a device (+ optionally host) profiler trace into log_dir."""
    import jax

    with jax.profiler.trace(log_dir, create_perfetto_link=False):
        yield


class _Meter:
    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self.seconds = 0.0

    @property
    def mbps(self) -> float:
        return self.nbytes / 1e6 / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def meter(nbytes: int):
    """Wall-clock MB/s counter (blocks on outstanding device work)."""
    import jax

    m = _Meter(nbytes)
    t0 = time.perf_counter()
    try:
        yield m
    finally:
        jax.effects_barrier()
        m.seconds = time.perf_counter() - t0
