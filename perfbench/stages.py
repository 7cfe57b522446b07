"""The program's own stages in a traced run: the ``osr.*`` spans that the
engines of ``osr_tpu_torch`` open while a profiler runs
(``osr_tpu_torch/utils/timing.py:span``), on the trace's clock beside the
benchmark's ``perfbench.*`` spans and the device's operations, and the
sparse engine's counters over the window.

    python3 perfbench/stages.py --workload <cell> --seed <n> --seconds <s>

sets the cell up and runs its window as ``run.py --trace 1`` does (the
same stretch, or the whole window where an end-to-end metric of the cell
reads the trace), then prints one JSON line: the window record, the
stretch's ``busy_s`` and ``window_s``, ``program`` (each ``osr.*`` span's
count, total, self and idle seconds and p50 / p95 milliseconds),
``idle_gaps`` (idle device seconds by the innermost span the host was in,
the ten largest), the counters' difference over the window, and the
values of :data:`READERS`. It checks no answer: ``run.py`` judges them.

``run.py`` does not read any of this: its summary (``trace.reduce_events``)
counts only the ``perfbench.*`` spans and puts each idle gap down to the
outermost one. :func:`reduce_program` is the reduction to add to it, and
each entry of :data:`READERS` a per-layer reader over the record it would
then give: ``record["trace"]["program"]`` and, from the sparse driver,
``record["window"]["counters"]``.

Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import trace as tr  # noqa: E402

OSR = "osr."  # the program's spans
TOP = tr.TOP


def events(prof) -> List[tuple]:
    """(name, on the device, start ns, end ns, user annotation, thread) of
    every event the profiler kept: ``trace._events`` with the thread."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns(), e.end_ns(),
             e.is_user_annotation(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()]


def reduce_program(events) -> Dict[str, object]:
    """The program's spans in the stretch, and each idle gap put down to
    the innermost span open on its thread.

    - ``program``: {``osr.*`` span: {count, total_s, self_s, idle_s,
      durations_s}}, for each span on the host clipped to the stretch:
      ``self_s`` its time less what the spans nested directly in it (the
      benchmark's or the program's) cover on its thread, ``idle_s`` the
      part of its self time in which no device operation ran;
    - ``idle``: {span: idle device seconds in its self time}, the
      benchmark's spans by their short names as ``trace.reduce_events``
      gives them, the program's by their full names, and
      ``trace.HARNESS`` the idle time outside every span.

    The device's busy time is ``trace.reduce_events``'s: every device
    operation but user annotations, the device copies of spans."""
    stretch = [(s, e) for n, dev, s, e, _, _ in events
               if n == tr.STRETCH and not dev]
    if not stretch:
        raise RuntimeError("the trace holds no stretch annotation")
    t0, t1 = stretch[0]
    busy = []
    spans = []
    for name, dev, s, e, ann, thread in events:
        a, b = max(s, t0), min(e, t1)
        if b <= a or name == tr.STRETCH:
            continue
        if name.startswith(tr.PREFIX):
            if not dev:
                spans.append((thread, a, b, name[len(tr.PREFIX):]))
        elif name.startswith(OSR) and not dev:
            spans.append((thread, a, b, name))
        elif dev and not ann:
            busy.append((a, b))
    merged = tr._union(busy)
    starts = [a for a, _ in merged]
    prefix = [0]
    for a, b in merged:
        prefix.append(prefix[-1] + b - a)

    def idle_ns(a: int, b: int) -> int:
        return (b - a) - tr._covered(merged, starts, prefix, a, b)

    spans.sort(key=lambda x: (x[0], x[1], -x[2]))
    children: List[List[tuple]] = [[] for _ in spans]
    stack: List[int] = []
    for i, (thread, a, b, _) in enumerate(spans):
        while stack and (spans[stack[-1]][0] != thread
                         or spans[stack[-1]][2] <= a):
            stack.pop()
        if stack:
            children[stack[-1]].append((a, b))
        stack.append(i)
    program: Dict[str, Dict[str, object]] = {}
    idle: Dict[str, float] = {}
    for (thread, a, b, name), kids in zip(spans, children):
        self_ns = gap_ns = 0
        at = a
        for c, d in kids + [(b, b)]:
            if c > at:
                self_ns += c - at
                gap_ns += idle_ns(at, c)
            at = max(at, d)
        idle[name] = idle.get(name, 0.0) + gap_ns / 1e9
        if name.startswith(OSR):
            p = program.setdefault(name, {"count": 0, "total_s": 0.0,
                                          "self_s": 0.0, "idle_s": 0.0,
                                          "durations_s": []})
            p["count"] += 1
            p["total_s"] += (b - a) / 1e9
            p["self_s"] += self_ns / 1e9
            p["idle_s"] += gap_ns / 1e9
            p["durations_s"].append((b - a) / 1e9)
    covered = tr._union([(a, b) for _, a, b, _ in spans])
    in_spans = sum(idle_ns(a, b) for a, b in covered)
    idle[tr.HARNESS] = ((t1 - t0) - prefix[-1] - in_spans) / 1e9
    return {"program": program, "idle": idle}


def idle_gaps(idle: Dict[str, float]) -> list:
    """The ten largest entries of :func:`reduce_program`'s ``idle``, most
    first: what ``trace.breakdown``'s ``idle_gaps`` would then list."""
    return [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])
            [:TOP]]


# Readers over a run's record --------------------------------------------


def _program(record) -> Optional[Dict[str, dict]]:
    """The trace's program spans, where the trace saw a device operation."""
    t = record.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return t.get("program")


def sparse_us(span: str, part: str = "self_s"):
    """Microseconds a query of ``span``'s ``part`` over a trace of the
    whole window (the queries the window completed)."""
    def read(record):
        spans = _program(record)
        done = record["window"]["completed"]
        if (not spans or span not in spans
                or not record.get("trace_is_window") or not done):
            return None
        return 1e6 * spans[span][part] / done
    return read


def request_us(span: str, part: str = "self_s"):
    """Microseconds a request of ``span``'s ``part``, over the
    ``osr.dense.search`` spans of the stretch."""
    def read(record):
        spans = _program(record)
        if not spans or span not in spans or "osr.dense.search" not in spans:
            return None
        return 1e6 * spans[span][part] / spans["osr.dense.search"]["count"]
    return read


def request_p95_ms(record):
    """The 95th percentile of the stretch's ``osr.dense.search`` times."""
    spans = _program(record)
    if not spans or "osr.dense.search" not in spans:
        return None
    return 1e3 * float(np.percentile(
        spans["osr.dense.search"]["durations_s"], 95))


def candidates_per_query(record):
    """Tail candidates a query over the window, from the engine's
    counters."""
    c = record["window"].get("counters")
    if not c or not c.get("queries"):
        return None
    return c["tail_candidates"] / c["queries"]


# name: (reader, unit, the cell it reads in)
SPARSE, INTERACTIVE = "fiqa-bm25.top1000", "nq-contriever-int8.interactive"
READERS = {
    "encode_us.sparse": (sparse_us("osr.sparse.encode"), "us/query", SPARSE),
    "tail_walk_us.sparse": (sparse_us("osr.sparse.tail_walk"), "us/query",
                            SPARSE),
    "cand_dots_us.sparse": (sparse_us("osr.sparse.cand_dots"), "us/query",
                            SPARSE),
    "merge_us.sparse": (sparse_us("osr.sparse.merge"), "us/query", SPARSE),
    "dicts_us.sparse": (sparse_us("osr.sparse.dicts"), "us/query", SPARSE),
    "device_wait_us.sparse": (sparse_us("osr.sparse.wait"), "us/query",
                              SPARSE),
    "candidates_per_query.sparse": (candidates_per_query,
                                    "candidates/query", SPARSE),
    "dispatch_us.interactive": (request_us("osr.dense.dispatch", "total_s"),
                                "us/request", INTERACTIVE),
    "device_wait_us.interactive": (request_us("osr.dense.wait"),
                                   "us/request", INTERACTIVE),
    "dicts_us.interactive": (request_us("osr.dense.dicts"), "us/request",
                             INTERACTIVE),
    "request_p95_ms.interactive": (request_p95_ms, "ms", INTERACTIVE),
}


# The tool ---------------------------------------------------------------


def _counters(driver) -> Optional[Dict[str, int]]:
    stats = getattr(driver.engine, "stats", None)
    return dict(stats().get("counters") or {}) if stats else None


def run_cell(cell, seed: int, seconds: float, device="cuda"):
    """Set-up, the traced window, the reduction; returns the line."""
    import torch

    from perfbench import drivers

    dev = torch.device(device)
    driver = drivers.load(cell.traffic["driver"])(
        cell.config, cell.traffic, seed, dev, False)
    whole = any(m["source"] == "device_trace" for m in cell.end_to_end)
    if whole:
        tracer = tr.Tracer(True, 0.0, float(seconds), dev)
    else:
        stretch = cell.traffic.get("trace", {})
        tracer = tr.Tracer(
            True, min(stretch.get("start_s", 2.0), 0.2 * seconds),
            min(stretch.get("length_s", 3.0), 0.5 * seconds), dev)
    tracer.warm()
    before = _counters(driver)
    window = driver.window(seconds, tracer)
    after = _counters(driver)
    driver.release()
    if before is not None and after:
        window["counters"] = {k: v - before.get(k, 0)
                              for k, v in after.items()}
    ev = events(tracer._prof)
    summary = tr.reduce_events([e[:5] for e in ev])
    stages = reduce_program(ev)
    summary["program"] = stages["program"]
    record = {"window": window, "trace": summary, "trace_is_window": whole}
    values = {}
    for name, (read, unit, where) in READERS.items():
        value = read(record) if cell.name == where else None
        if value is not None:
            values[name] = {"value": float(value), "unit": unit}
    program = {
        n: {**{k: v for k, v in p.items() if k != "durations_s"},
            "p50_ms": 1e3 * float(np.percentile(p["durations_s"], 50)),
            "p95_ms": 1e3 * float(np.percentile(p["durations_s"], 95))}
        for n, p in stages["program"].items()}
    return {"workload": cell.name, "seed": seed, "window": window,
            "window_s": summary["window_s"], "busy_s": summary["busy_s"],
            "spans": summary["spans"], "program": program,
            "idle_gaps": idle_gaps(stages["idle"]), "values": values,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else dev.type)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from perfbench.cell import Cell, load_bench

    cell = Cell(load_bench(), args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    print(json.dumps(run_cell(cell, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
