"""The traced stretch of a ``--trace 1`` run and its reduction to a summary
that the per-layer readers read.

``torch.profiler`` (host and CUDA activity) runs over a short steady
stretch of the window, which the drivers open and close between calls, or
over the whole window where an end-to-end metric reads the trace.
The benchmark's own spans around its calls into the program are
``record_function`` annotations, so they share the trace's clock with the
device's operations. The summary holds:

- ``window_s``: the stretch's length, from its own annotation;
- ``busy_s``: the seconds in which some device operation (kernel, copy,
  fill) ran, the union of their intervals inside the stretch;
- ``ops``: {device operation name: [count, seconds]};
- ``spans``: {span name: count};
- ``idle``: {what the host was doing: idle device seconds}, by the span
  the host was in, ``harness`` outside every span.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

STRETCH = "perfbench.stretch"
PREFIX = "perfbench."
HARNESS = "harness"
TOP = 10  # entries of each list of the breakdown
NAME_CHARS = 200


class Tracer:
    """Opens the profiler ``start_s`` into the window for ``length_s``
    seconds from its opening, when enabled; otherwise every method is a
    no-op."""

    def __init__(self, enabled: bool, start_s: float, length_s: float,
                 device: torch.device):
        self.enabled = enabled
        self.start_s, self.length_s = start_s, length_s
        self.device = device
        self._prof = None
        self._stretch = None
        self._opened = 0.0
        self.done = False

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once before the window: its first
        start initialises the device tracing, which takes seconds."""
        if self.enabled:
            with self._profile():
                torch.ones(8, device=self.device).sum()
                self._sync()

    @property
    def active(self) -> bool:
        return self._stretch is not None

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def due(self, elapsed: float) -> bool:
        """Whether the stretch should open or close at ``elapsed`` seconds
        into the window (the caller drains its work first, then calls
        :meth:`toggle`)."""
        if not self.enabled or self.done:
            return False
        if self.active:
            return time.perf_counter() - self._opened >= self.length_s
        return elapsed >= self.start_s

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def toggle(self) -> None:
        if not self.active:
            self._prof = self._profile()
            self._prof.start()
            self._sync()
            self._stretch = torch.profiler.record_function(STRETCH)
            self._stretch.__enter__()
            self._opened = time.perf_counter()
        else:
            self._sync()
            self._stretch.__exit__(None, None, None)
            self._stretch = None
            self._prof.stop()
            self.done = True

    def finish(self) -> None:
        if self.active:
            self.toggle()

    def summary(self) -> Optional[Dict[str, object]]:
        """The stretch reduced (None without one)."""
        if self._prof is None or not self.done:
            return None
        t0 = time.perf_counter()
        out = reduce_events(_events(self._prof))
        out["reduce_s"] = time.perf_counter() - t0
        return out


def _events(prof) -> List[Tuple[str, bool, int, int, bool]]:
    """(name, on the device, start ns, end ns, user annotation) of every
    event the profiler kept."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns(), e.end_ns(),
             e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _covered(merged, starts, prefix, a: int, b: int) -> int:
    """Nanoseconds of [a, b) that the sorted, disjoint ``merged``
    intervals cover (``prefix[i]`` the lengths of the first i)."""
    if b <= a:
        return 0

    def upto(t: int) -> int:
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0
        lo, hi = merged[i - 1]
        return prefix[i - 1] + max(0, min(hi, t) - lo)

    return upto(b) - upto(a)


def reduce_events(events) -> Dict[str, object]:
    """The summary of a stretch's events (see the module's docstring)."""
    stretch = [(s, e) for n, dev, s, e, _ in events
               if n == STRETCH and not dev]
    if not stretch:
        raise RuntimeError("the trace holds no stretch annotation")
    t0, t1 = stretch[0]
    ops: Dict[str, List[float]] = {}
    busy = []
    spans: Dict[str, int] = {}
    host = []
    for name, dev, s, e, ann in events:
        if name.startswith(PREFIX):
            if not dev and name != STRETCH:
                short = name[len(PREFIX):]
                spans[short] = spans.get(short, 0) + 1
                host.append((max(s, t0), min(e, t1), short))
            continue
        if not dev or ann:
            continue
        a, b = max(s, t0), min(e, t1)
        if b <= a:
            continue
        entry = ops.setdefault(name[:NAME_CHARS], [0, 0.0])
        entry[0] += 1
        entry[1] += (b - a) / 1e9
        busy.append((a, b))
    merged = _union(busy)
    starts = [a for a, _ in merged]
    prefix = [0]
    for a, b in merged:
        prefix.append(prefix[-1] + b - a)
    busy_ns = prefix[-1]
    idle: Dict[str, float] = {}
    in_spans = 0
    for a, b, name in host:
        if b <= a:
            continue
        gap = (b - a) - _covered(merged, starts, prefix, a, b)
        in_spans += gap
        idle[name] = idle.get(name, 0.0) + gap / 1e9
    idle[HARNESS] = ((t1 - t0) - busy_ns - in_spans) / 1e9
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "ops": ops,
        "spans": spans,
        "idle": idle,
    }


def breakdown(summary: Dict[str, object]) -> Dict[str, list]:
    """The ten device operations that took most time and the idle device
    time by what the host was doing, most first."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][1])
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])
    return {
        "device_ops": [[n, v[1]] for n, v in ops[:TOP]],
        "idle_gaps": [[n, v] for n, v in idle[:TOP]],
    }


# Readers' helpers -------------------------------------------------------


def kernel(record, pattern: "re.Pattern[str]") -> Tuple[int, float]:
    """(launches, device seconds) of the operations whose name matches."""
    t = record.get("trace")
    if not t:
        return 0, 0.0
    n, s = 0, 0.0
    for name, (count, secs) in t["ops"].items():
        if pattern.search(name):
            n += count
            s += secs
    return n, s


def idle_pct(record) -> Optional[float]:
    """100 x the share of the stretch with no device operation running;
    None where the trace saw none."""
    t = record.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


# Kernel names as the trace gives them, demangled or mangled
# (csrc/head_wgmma.cu: head_wgmma_kernel<kInt8, kEpi>, kEpiBlockMax 0,
# kEpiScores 2; csrc/similarity_wgmma.cu: similarity_wgmma_kernel<kInt4,
# kTmaStore>; csrc/quantize.cu: quantize_rows_kernel<kStochastic, kVec>).
K1 = re.compile(r"head_wgmma_kernel(ILb1ELi2E|<\s*true\s*,\s*2\s*>)")
K5 = re.compile(r"similarity_wgmma_kernel(ILb0ELb1E|<\s*false\s*,\s*true\s*>)")
K7 = re.compile(r"quantize_rows_kernel(ILb0E|<\s*false\s*,)")
COPY = re.compile(r"^Mem(cpy|set)")
