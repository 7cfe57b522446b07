"""Timing and memory measurement utilities for benchmarks (counterpart of
``osr_tpu/utils/timing.py``).

Capability parity with the reference's benchmark framework primitives:
``TimingContext`` (ns-resolution timer with warmup, reference
bench/core/benchmark_framework.py:75-114), ``MemoryMonitor`` (RSS sampling,
:116-147), and latency percentile helpers (bench/utils.py:25-71).

CUDA note: kernels are launched asynchronously, so anything measured
around device work must synchronize — ``block_and_time`` synchronizes every
CUDA device that the thunk's result lives on, so the device queue can't
hide behind async dispatch; ``device_seconds`` times device work with
CUDA events instead, for calls too short for the host clock.

``span`` marks a stage of the served path for ``torch.profiler``: a
``record_function`` range while a profiler runs, so the stage lands on the
trace's clock beside the device's operations, and nothing otherwise.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler is running, else a shared no-op context (a range costs host
    time even with no profiler running; the check costs far less). The
    engines name theirs ``osr.<engine>.<stage>`` and mark batches and
    requests, never single queries."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def process_rss_mb() -> float:
    """Current process RSS in MB (0.0 when psutil is unavailable)."""
    try:
        import psutil

        return psutil.Process().memory_info().rss / 2**20
    except Exception:  # pragma: no cover
        return 0.0


class TimingContext:
    """Context manager measuring wall time of its body.

    For warmup-aware timing of device work use :func:`time_fn`, which
    runs (and discards) warmup executions before measuring."""

    def __init__(self, name: str = ""):
        self.name = name
        self.elapsed_ns: int = 0

    def __enter__(self):
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.elapsed_ns = time.perf_counter_ns() - self._start
        return False

    @property
    def elapsed_ms(self) -> float:
        return self.elapsed_ns / 1e6

    @property
    def elapsed_s(self) -> float:
        return self.elapsed_ns / 1e9


def _cuda_devices(out: Any, found: set) -> set:
    """The CUDA devices of every tensor in a (nested) result."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (list, tuple)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    return found


def block_and_time(fn: Callable[[], Any]) -> float:
    """Run a thunk, synchronize the CUDA devices its result lives on,
    return elapsed seconds."""
    t0 = time.perf_counter()
    out = fn()
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def time_fn(
    fn: Callable[[], Any],
    warmup: int = 1,
    runs: int = 5,
) -> Dict[str, float]:
    """Median/mean timing of a thunk with warmup runs excluded."""
    for _ in range(warmup):
        block_and_time(fn)
    times = [block_and_time(fn) for _ in range(runs)]
    return {
        "median_s": float(np.median(times)),
        "mean_s": float(np.mean(times)),
        "min_s": float(np.min(times)),
        "max_s": float(np.max(times)),
        "runs": runs,
    }


def device_seconds(
    fn: Callable[[], object], device: torch.device, runs: int = 3
) -> float:
    """Mean seconds of one call of ``fn`` after one warmup call: CUDA
    events around ``runs`` back-to-back calls on a CUDA device (no host
    sync between them, unlike :func:`time_fn`), the host clock around
    them on the CPU. The benchmark suites time their kernel rows so."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        return (time.perf_counter() - t0) / runs
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / runs


def percentiles(
    latencies_ms: Sequence[float], ps: Sequence[int] = (50, 95, 99)
) -> Dict[str, float]:
    arr = np.asarray(latencies_ms, dtype=np.float64)
    if arr.size == 0:
        return {f"p{p}_ms": 0.0 for p in ps}
    return {f"p{p}_ms": float(np.percentile(arr, p)) for p in ps}


class MemoryMonitor:
    """Host RSS before/after/peak sampling around a workload."""

    def __init__(self):
        self.baseline_mb: Optional[float] = None
        self.peak_mb: float = 0.0
        self.samples: List[float] = []

    _rss_mb = staticmethod(process_rss_mb)

    def __enter__(self):
        self.baseline_mb = self._rss_mb()
        self.peak_mb = self.baseline_mb
        return self

    def sample(self) -> float:
        mb = self._rss_mb()
        self.samples.append(mb)
        self.peak_mb = max(self.peak_mb, mb)
        return mb

    def __exit__(self, *exc):
        self.sample()
        return False

    @property
    def delta_mb(self) -> float:
        return (self.samples[-1] if self.samples else 0.0) - (
            self.baseline_mb or 0.0
        )
