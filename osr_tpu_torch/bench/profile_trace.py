"""A ``torch.profiler`` trace of steady-state search passes on the CUDA card
(counterpart of ``tools/profile_trace.py``).

One ``SparseSearchEngine`` at ``batch_sizes=(--batch,)`` over the
script's corpus and queries (one seed-42 generator, corpus first) does a
warm search, then ``--passes`` passes under ``torch.profiler.profile``
(host and CUDA activity), each inside ``record_function("search_pass_i")``
as the script's ``TraceAnnotation``. The script writes a TensorBoard
trace directory and prints the files; here ``--out DIR`` (no default)
gets one Chrome trace, ``DIR/trace.json``, and the JSON line always holds
each pass's QPS, the ten device operations with the most device time
(name, count, milliseconds per pass, from ``key_averages()``), the device
time over the passes' wall time (``device_busy_share``), the files
written and the kernels launched.

The trace must show the device's work: on the card, a trace with no
device event, or in which a head kernel's events (K2, ``head_blockmax_i8``,
at the defaults) are not as many as its launch counter's increase over
the traced passes, fails the mode (exit 1, with the reason), as the
script exits 1 when its capture fails. The passes' own annotations, which
the profiler also lays on the device's timeline, are not device
operations and count in neither the table nor the busy share. The
tables go to stderr.

Usage: python -m osr_tpu_torch.bench profile-trace [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from osr_tpu_torch.bench.common import (
    NUM_DOCS,
    TOP_K,
    VOCAB,
    device_name,
    launched,
    log,
    no_card,
    reset_all_launches,
    workload,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "search_trace_device_busy_share"
# The head kernels' instantiations of head_wgmma_kernel<kInt8, kEpi>
# (csrc/head_wgmma.cu: kEpiBlockMax 0, kEpiTopM 1, kEpiScores 2).
HEAD_INSTANCES = {
    "head_scores_i8": (True, 2),
    "head_blockmax_i8": (True, 0),
    "head_blocktopm_i8": (True, 1),
    "head_blockmax_i4": (False, 0),
    "head_blocktopm_i4": (False, 1),
}
TOP_OPS = 10
NAME_CHARS = 200  # a device operation's name as the JSON line keeps it


def event_pattern(name: str) -> "re.Pattern[str]":
    """A head kernel's events as the trace names them: demangled, or
    mangled where the demangler does not run."""
    int8, epi = HEAD_INSTANCES[name]
    return re.compile(
        rf"head_wgmma_kernel(ILb{int(int8)}ELi{epi}E"
        rf"|<\s*{'true' if int8 else 'false'}\s*,\s*{epi}\s*>)"
    )


class TraceCheckError(RuntimeError):
    """The trace does not show the device work the passes launched."""


def device_ops(prof, annotations) -> List[object]:
    """The profile's device events (kernels, copies, fills), averaged by
    name, most device time first; ``annotations`` are left out."""
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.key not in annotations]
    return sorted(ops, key=lambda e: e.device_time_total, reverse=True)


def run(
    *,
    docs: int = NUM_DOCS,
    vocab: int = VOCAB,
    batch: int = 2048,
    topk: int = TOP_K,
    passes: int = 3,
    out: Optional[str] = None,
    device=None,
) -> Dict[str, object]:
    """Trace the passes and return the summary; raises TraceCheckError on
    the card when the trace lacks the device's work. The tests pass
    ``device="cpu"`` (host activity only) and small sizes."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    log(f"device: {device_name(dev)}")
    corpus, queries = workload(docs, vocab, batch)
    index = SparseIndexBuilder(method="bm25").build(corpus)
    del corpus
    engine = SparseSearchEngine(
        index, device=dev, batch_sizes=(batch,), cache_queries=False
    )
    if on_card and engine.head_backend != "cuda":
        raise RuntimeError(f"the engine's head step is "
                           f"{engine.head_backend!r}, not the kernel")
    engine.search(queries, top_k=topk)  # first calls + warm

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    qps, walls = [], []
    annotations = [f"search_pass_{i}" for i in range(passes)]
    reset_all_launches()
    with profile(activities=activities) as prof:
        for i in range(passes):
            with record_function(annotations[i]):
                t0 = time.perf_counter()
                engine.search(queries, top_k=topk)
                if on_card:
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
            walls.append(dt)
            qps.append(round(batch / dt, 1))
            log(f"pass {i}: {batch / dt:.0f} QPS")
    launches = launched()

    trace_files = []
    if out:
        path = Path(out) / "trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        trace_files.append(str(path))
        log(f"wrote {path}")

    ops = device_ops(prof, annotations)
    busy_us = sum(e.device_time_total for e in ops)
    events = {
        name: sum(e.count for e in ops if event_pattern(name).search(e.key))
        for name in HEAD_INSTANCES
        if launches.get(name)
    }
    top = [
        {"name": e.key[:NAME_CHARS], "count": e.count,
         "ms_per_pass": round(e.device_time_total / 1e3 / passes, 4)}
        for e in ops[:TOP_OPS]
    ]
    log(f"{'device operation':70s} {'count':>7s} {'ms/pass':>9s}")
    for op in top:
        log(f"{op['name'][:70]:70s} {op['count']:7d} {op['ms_per_pass']:9.4f}")
    summary = {
        "metric": METRIC,
        "num_docs": docs,
        "batch": batch,
        "top_k": topk,
        "passes": passes,
        "passes_qps": qps,
        "top_device_ops": top,
        "device_busy_share": (
            round(busy_us / 1e6 / sum(walls), 4) if on_card else None
        ),
        "kernel_trace_events": events,
        "trace_files": trace_files,
        "kernel_launches": launches,
        "device": device_name(dev),
    }
    if on_card:
        if not ops:
            raise TraceCheckError(
                "the profiler recorded no device event (CUPTI activity "
                "tracing gave nothing on this machine)"
            )
        head = {k: v for k, v in launches.items() if k in HEAD_INSTANCES}
        if not events or events != head:
            raise TraceCheckError(
                f"the trace holds head kernel events {events}, the launch "
                f"counters rose by {head}"
            )
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench profile-trace",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, default=NUM_DOCS)
    ap.add_argument("--vocab", type=int, default=VOCAB)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--topk", type=int, default=TOP_K)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome trace (none written "
                    "without it)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    try:
        summary = run(docs=args.docs, vocab=args.vocab, batch=args.batch,
                      topk=args.topk, passes=args.passes, out=args.out)
    except TraceCheckError as e:
        print(json.dumps({"metric": METRIC, "value": None,
                          "error": f"trace capture failed: {e}"}), flush=True)
        return 1
    print(json.dumps(summary), flush=True)
    return 0
