"""Hybrid (sparse 0.3 + dense 0.7) retrieval throughput at FiQA scale on
the CUDA card (counterpart of ``tools/bench_hybrid.py``).

The hybrid retriever through ``RetrieverRegistry``'s dict surface over
``bench.py``'s corpus and queries: its sparse leg on K2, its dense leg on
K7 and K5. Warmed at the full batch bucket, then the median of 5 passes;
the fusion is checked against its two constituent retrievers. Prints one
JSON row.

Usage: python -m osr_tpu_torch.bench hybrid [--fusion weighted|rrf]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import torch

from osr_tpu_torch.bench.common import (
    NUM_DOCS,
    NUM_QUERIES,
    TOP_K,
    device_name,
    launched,
    log,
    make_corpus,
    make_queries,
    no_card,
    reset_all_launches,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "hybrid_qps_fiqa_scale"
PASSES = 5
FUSION_DEPTH = 100
SPARSE_WEIGHT = 0.3
DENSE_WEIGHT = 0.7


def check_fusion(retr, queries, results, fusion: str) -> None:
    """Every fused result of the first non-empty query draws only from the
    union of the constituents' ``fusion_depth`` pools, and its scores lie
    in the fusion's range: [0, 1] for weighted min-max, [0, 2/61] for RRF
    (two unit-weight legs, rrf_k = 60). Raises on a violation."""
    qid = next(q for q, r in results.items() if r)
    s_pool = retr.sparse.search({qid: queries[qid]}, top_k=FUSION_DEPTH)[qid]
    d_pool = retr.dense.search({qid: queries[qid]}, top_k=FUSION_DEPTH)[qid]
    if not set(results[qid]) <= set(s_pool) | set(d_pool):
        raise RuntimeError(f"{qid}: fused docs outside the constituent pools")
    hi = 1.0 + 1e-6 if fusion == "weighted" else 2.0 / 61.0 + 1e-6
    if not all(0.0 <= s <= hi for s in results[qid].values()):
        raise RuntimeError(f"{qid}: fused scores outside [0, {hi}]")


def run(
    fusion: str = "weighted",
    device=None,
    *,
    num_docs: int = NUM_DOCS,
    num_queries: int = NUM_QUERIES,
    passes: int = PASSES,
) -> Dict[str, object]:
    """Build, warm, time ``passes`` passes, print the row and return it.
    The tests pass ``device="cpu"`` and small sizes."""
    from osr_tpu_torch.retrieval.registry import RetrieverRegistry

    dev = resolve_device(device)
    corpus = make_corpus(num_docs)
    queries = make_queries(num_queries)
    retr = RetrieverRegistry.create({
        "type": "hybrid",
        "params": {
            "sparse_weight": SPARSE_WEIGHT,
            "dense_weight": DENSE_WEIGHT,
            "fusion_depth": FUSION_DEPTH,
            "fusion": fusion,
            "cache_dir": None,
            "device": dev,
        },
    })
    t0 = time.perf_counter()
    retr.build_index_from_corpus(corpus)
    build_s = time.perf_counter() - t0
    del corpus
    if dev.type == "cuda" and (
        retr.sparse.engine.head_backend != "cuda"
        or retr.dense.engine.backend != "cuda"
    ):
        raise RuntimeError("the hybrid's legs do not take the CUDA kernels")

    # Warm at the full batch bucket, so no pass pays a first call.
    bucket = retr.sparse.engine.batch_sizes[-1]
    retr.search(dict(list(queries.items())[:bucket]), top_k=TOP_K)

    qps_passes: List[float] = []
    results = None
    reset_all_launches()
    for _ in range(passes):
        retr.clear_cache()
        t0 = time.perf_counter()
        results = retr.search(queries, top_k=TOP_K)
        qps_passes.append(
            round(num_queries / (time.perf_counter() - t0), 1)
        )
        log(f"hybrid pass qps: {qps_passes[-1]:.1f}")
    launches = launched()
    qps = sorted(qps_passes)[len(qps_passes) // 2]
    check_fusion(retr, queries, results, fusion)

    row = {
        "metric": METRIC,
        "path": "array-fusion",
        "fusion": fusion,
        "qps": qps,
        "qps_passes": qps_passes,
        "build_s": round(build_s, 2),
        "num_docs": num_docs,
        "num_queries": num_queries,
        "top_k": TOP_K,
        "fusion_depth": FUSION_DEPTH,
        "sparse_weight": SPARSE_WEIGHT,
        "dense_weight": DENSE_WEIGHT,
        "nonempty_results": sum(1 for r in results.values() if r),
        "kernel_launches": launches,
        "device": device_name(dev),
    }
    print(json.dumps(row), flush=True)
    return row


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench hybrid",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument(
        "--fusion", choices=("weighted", "rrf"), default="weighted",
        help="weighted min-max (the reference's semantics) or "
        "reciprocal-rank (rrf_k=60)",
    )
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    run(args.fusion)
    return 0
