"""Efficiency benchmarking of the retrieval stack (counterpart of
``osr_tpu/pipeline/efficiency.py``; the engine runs on the caller's
``device``, ``cuda`` unless named).

Capability parity with reference rag_system/pipeline/benchmark_efficiency.py:
index-build time/memory (:19-45), query latency with warmup and p50/p95/p99
(:48-98), index scaling across corpus sizes (:101-134), and a comprehensive
runner (:137+). Every timed search returns host dicts, so async
dispatch can't flatter the numbers.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from osr_tpu_torch.index.builder import SparseIndexBuilder
from osr_tpu_torch.retrieval.engine import SparseSearchEngine
from osr_tpu_torch.utils.timing import MemoryMonitor, percentiles

logger = logging.getLogger(__name__)


def measure_build_performance(
    corpus: Mapping[str, Any], method: str = "bm25", **builder_kwargs
) -> Dict[str, Any]:
    """Index build wall time + host memory delta + layout stats."""
    with MemoryMonitor() as mem:
        t0 = time.perf_counter()
        index = SparseIndexBuilder(method=method, **builder_kwargs).build(corpus)
        build_s = time.perf_counter() - t0
        mem.sample()
    return {
        "build_time_s": build_s,
        "docs_per_second": len(corpus) / build_s if build_s else 0.0,
        "memory_delta_mb": mem.delta_mb,
        "index": index.stats(),
        "_index_object": index,
    }


def benchmark_query_latency(
    engine: SparseSearchEngine,
    queries: Mapping[str, str],
    top_k: int = 10,
    warmup: int = 3,
    batch_size: int = 1,
) -> Dict[str, Any]:
    """Per-query latency distribution at a given client batch size."""
    items = list(queries.items())
    if not items:
        return {"error": "no queries"}
    # Warm up at the measured client batch size and at the trailing
    # partial-batch size, which pads to a DIFFERENT engine shape, so no
    # first-use cost of either lands inside the timed region.
    for _ in range(max(1, warmup)):
        engine.search(dict(items[:batch_size]), top_k=top_k)
    rem = len(items) % batch_size
    if rem:
        engine.search(dict(items[:rem]), top_k=top_k)
    engine.clear_cache()
    latencies: List[float] = []
    for i in range(0, len(items), batch_size):
        batch = dict(items[i : i + batch_size])
        t0 = time.perf_counter()
        engine.search(batch, top_k=top_k)
        latencies.append((time.perf_counter() - t0) / len(batch) * 1000)
        engine.clear_cache()
    return {
        "num_queries": len(items),
        "batch_size": batch_size,
        "mean_latency_ms": float(np.mean(latencies)),
        **percentiles(latencies, (50, 95, 99)),
        "qps": 1000.0 / float(np.mean(latencies)),
    }


def benchmark_index_scaling(
    corpus: Mapping[str, Any],
    sizes: Sequence[int] = (1000, 5000, 10000),
    method: str = "bm25",
) -> List[Dict[str, Any]]:
    """Build + memory across corpus subsets of increasing size."""
    doc_ids = list(corpus.keys())
    out = []
    for size in sizes:
        if size > len(doc_ids):
            break
        subset = {d: corpus[d] for d in doc_ids[:size]}
        r = measure_build_performance(subset, method=method)
        r.pop("_index_object")
        r["corpus_size"] = size
        out.append(r)
    return out


def run_comprehensive_benchmark(
    corpus: Mapping[str, Any],
    queries: Mapping[str, str],
    top_k: int = 10,
    out_path: Optional[Union[str, Path]] = None,
    batch_sizes: Sequence[int] = (1, 32, 128),
    device=None,
) -> Dict[str, Any]:
    """Full efficiency report: build, latency per batch size, throughput,
    with the engine on ``device`` (``cuda`` unless named)."""
    build = measure_build_performance(corpus)
    index = build.pop("_index_object")
    engine = SparseSearchEngine(index, cache_queries=False, device=device)

    latency = {
        f"batch_{b}": benchmark_query_latency(
            engine, queries, top_k=top_k, batch_size=b
        )
        for b in batch_sizes
        if b <= max(1, len(queries))
    }

    # Sustained throughput: one pass over everything, engine-batched.
    t0 = time.perf_counter()
    engine.search(queries, top_k=top_k)
    elapsed = time.perf_counter() - t0
    report = {
        "build": build,
        "latency": latency,
        "throughput_qps": len(queries) / elapsed if elapsed else 0.0,
        "top_k": top_k,
    }
    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    return report
