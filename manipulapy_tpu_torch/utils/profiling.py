"""Profiling and performance monitoring.

Counterpart of ``manipulapy_tpu/utils/profiling.py``: the same stats-dict
API, with ``torch.profiler`` traces in place of ``jax.profiler`` and
``torch.cuda.synchronize()`` in place of ``block_until_ready`` as the fence.
Unlike the JAX code, :meth:`PerformanceMonitor.time_op` does fence device
work (the current CUDA stream, once CUDA is initialized), as its docstring
there promises.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Any, Callable, Dict

import torch

__all__ = ["PerformanceMonitor", "benchmark_fn", "profile_trace"]


def _fence() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class PerformanceMonitor:
    """Aggregate per-operation call counts and wall times, in the JAX
    monitor's reporting shape (``get_performance_stats``: calls, total and
    average seconds per name)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._counts: Dict[str, int] = defaultdict(int)
        self._times: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def time_op(self, name: str):
        """Time a block; fences device work so times are honest."""
        _fence()
        start = time.perf_counter()
        try:
            yield
        finally:
            _fence()
            elapsed = time.perf_counter() - start
            self._counts[name] += 1
            self._times[name] += elapsed

    def record(self, name: str, seconds: float) -> None:
        self._counts[name] += 1
        self._times[name] += seconds

    def get_performance_stats(self) -> Dict[str, Any]:
        stats: Dict[str, Any] = {}
        for name in self._counts:
            count = self._counts[name]
            total = self._times[name]
            stats[name] = {
                "calls": count,
                "total_time_s": total,
                "avg_time_s": total / max(count, 1),
            }
        return stats


def benchmark_fn(
    fn: Callable,
    *args,
    warmup: int = 2,
    iters: int = 10,
    **kwargs,
) -> Dict[str, float]:
    """Warmup + timed micro-benchmark of a callable: avg/min/max/std
    (population)/median in ms and the iteration count, the JAX dict. Every
    run is fenced by ``torch.cuda.synchronize()`` when CUDA is initialized."""
    for _ in range(warmup):
        fn(*args, **kwargs)
        _fence()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _fence()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    n = len(times)
    mean = sum(times) / n
    var = sum((t - mean) ** 2 for t in times) / n
    return {
        "avg_time_ms": mean,
        "min_time_ms": times[0],
        "max_time_ms": times[-1],
        "std_time_ms": var**0.5,
        "median_time_ms": times[n // 2],
        "iterations": n,
    }


@contextlib.contextmanager
def profile_trace(log_dir: str = os.path.join(tempfile.gettempdir(), "manipulapy_tpu_torch_trace")):
    """Wrap a block in a ``torch.profiler`` trace of the CPU and, where a
    CUDA device is available, the card; on exit its Chrome trace is written
    to ``<log_dir>/trace.json`` (open in Perfetto or ``chrome://tracing``).
    Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            _fence()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
