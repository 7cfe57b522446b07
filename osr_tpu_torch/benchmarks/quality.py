"""Retrieval-quality benchmark harness over BEIR-format datasets.

Capability parity with reference bench/fiqa_benchmark.py: run a set of
retrieval methods over a dataset's test split, compute nDCG/MAP/Recall/P at
{10, 100} plus latency, and emit JSON + markdown + CSV reports with the
published community ranges for context (reference fiqa_benchmark.py:251-256).

Dataset acquisition differs by design: the reference downloads FiQA over
HTTP at benchmark time; here datasets are local directories (use
``osr_tpu_torch.storage.loaders.prepare_dataset`` to materialize one from
HuggingFace where network access exists).

Counterpart of ``osr_tpu/benchmarks/quality.py``: every method's
retriever runs on ``device`` (None means ``cuda``), set in its registry
params unless the caller's params name one, as the CLI's ``--platform``
does for the pipeline.
"""

from __future__ import annotations

import csv
import json
import logging
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

from osr_tpu_torch.benchmarks.framework import format_results_table, save_json
from osr_tpu_torch.metrics.ir import evaluate_retrieval
from osr_tpu_torch.retrieval.engine import _resolve_device
from osr_tpu_torch.retrieval.registry import RetrieverRegistry
from osr_tpu_torch.storage.loaders import (
    extract_query_text,
    load_corpus,
    load_qrels,
    load_queries,
)

logger = logging.getLogger(__name__)

DEFAULT_METHODS = ("bm25_custom", "tfidf", "dpr", "contriever")

# Published community ranges on FiQA for context
# (reference bench/fiqa_benchmark.py:251-256).
EXPECTED_NDCG10_RANGES = {
    "bm25": (0.23, 0.26),
    "bm25_custom": (0.23, 0.26),
    "dpr": (0.22, 0.28),
    "contriever": (0.25, 0.30),
    "splade": (0.27, 0.32),
}


def run_method(
    method: str,
    corpus: Dict[str, Dict],
    queries: Dict[str, str],
    qrels: Dict[str, Dict[str, int]],
    top_k: int = 100,
    params: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    p = dict(params or {})
    # A reserved 'type' param lets one registry type run under several
    # result keys (e.g. 'hybrid' vs 'hybrid_rrf' with fusion='rrf').
    cfg = {"type": p.pop("type", method), "params": p}
    cfg["params"].setdefault("cache_matrices", False)
    retriever = RetrieverRegistry.create(cfg)

    t0 = time.perf_counter()
    retriever.build_index_from_corpus(corpus)
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    results = retriever.search(queries, top_k=top_k)
    cold_search_s = time.perf_counter() - t0

    # Warm steady-state pass for the throughput number: the cold pass
    # pays per-process startup (kernel builds and loads, first
    # allocations), not query throughput. Cold time is still reported.
    if hasattr(retriever, "clear_cache"):
        retriever.clear_cache()
    t0 = time.perf_counter()
    results = retriever.search(queries, top_k=top_k)
    search_s = time.perf_counter() - t0

    metrics = evaluate_retrieval(results, qrels, k_values=(10, 100))
    return {
        "method": method,
        "num_queries": len(queries),
        "num_docs": len(corpus),
        "top_k": top_k,
        "build_time_s": build_s,
        "search_time_s": search_s,
        "cold_search_s": cold_search_s,
        "avg_latency_ms": search_s / len(queries) * 1000 if queries else 0.0,
        "qps": len(queries) / search_s if search_s else 0.0,
        **metrics,
    }


def run_quality_benchmark(
    dataset_dir: Union[str, Path],
    methods: Sequence[str] = DEFAULT_METHODS,
    out_dir: Union[str, Path] = "bench_results",
    top_k: int = 100,
    max_queries: Optional[int] = None,
    method_params: Optional[Dict[str, Dict[str, Any]]] = None,
    device=None,
) -> Dict[str, Any]:
    device = str(_resolve_device(device))
    dataset_dir = Path(dataset_dir)
    out_dir = Path(out_dir)
    corpus = load_corpus(dataset_dir)
    queries_raw = load_queries(dataset_dir)
    qrels = load_qrels(dataset_dir)
    # Like BEIR: evaluate only queries that appear in the test qrels.
    queries = {
        qid: extract_query_text(q)
        for qid, q in queries_raw.items()
        if not qrels or qid in qrels
    }
    if max_queries:
        queries = dict(list(queries.items())[:max_queries])

    all_results: Dict[str, Any] = {}
    for method in methods:
        logger.info("Benchmarking %s ...", method)
        params = dict((method_params or {}).get(method) or {})
        params.setdefault("device", device)
        try:
            summary = run_method(
                method,
                corpus,
                queries,
                qrels,
                top_k=top_k,
                params=params,
            )
            all_results[method] = summary
            save_json(summary, out_dir / f"{dataset_dir.name}_{method}_summary.json")
        except Exception as e:
            logger.error("Method %s failed: %s", method, e)
            all_results[method] = {"method": method, "error": str(e)}
    generate_quality_report(all_results, dataset_dir.name, out_dir)
    return all_results


def generate_quality_report(
    results: Dict[str, Any], dataset: str, out_dir: Union[str, Path]
) -> str:
    """Markdown + CSV report (reference fiqa_benchmark.py:224-267)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = [r for r in results.values() if "error" not in r]
    columns = [
        "method", "ndcg@10", "ndcg@100", "map@100", "recall@10",
        "recall@100", "p@10", "avg_latency_ms", "qps",
    ]
    lines = [
        f"# Retrieval quality benchmark — {dataset}",
        "",
        f"Generated: {datetime.now().isoformat()}",
        "",
        format_results_table(ok, columns),
        "",
        "## Expected community ranges (FiQA, nDCG@10)",
        "",
    ]
    for method, (lo, hi) in EXPECTED_NDCG10_RANGES.items():
        lines.append(f"- {method}: {lo:.2f}–{hi:.2f}")
    failed = {m: r["error"] for m, r in results.items() if "error" in r}
    if failed:
        lines += ["", "## Failures", ""]
        lines += [f"- {m}: {e}" for m, e in failed.items()]
    report = "\n".join(lines)
    (out_dir / f"{dataset}_quality_report.md").write_text(report)

    with open(out_dir / f"{dataset}_quality_results.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns, extrasaction="ignore")
        writer.writeheader()
        for r in ok:
            writer.writerow(r)
    return report


def main(argv=None) -> int:  # CLI: python -m osr_tpu_torch.benchmarks.quality
    import argparse

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="Retrieval quality benchmark")
    parser.add_argument("--dataset", required=True, help="BEIR-format dataset dir")
    parser.add_argument("--methods", nargs="*", default=list(DEFAULT_METHODS))
    parser.add_argument("--top-k", type=int, default=100)
    parser.add_argument("--max-queries", type=int)
    parser.add_argument("--out-dir", default="bench_results")
    args = parser.parse_args(argv)
    results = run_quality_benchmark(
        args.dataset,
        methods=args.methods,
        out_dir=args.out_dir,
        top_k=args.top_k,
        max_queries=args.max_queries,
    )
    failures = sum(1 for r in results.values() if "error" in r)
    for method, r in results.items():
        if "error" not in r:
            print(
                f"{method}: nDCG@10={r['ndcg@10']:.4f} "
                f"recall@100={r['recall@100']:.4f} qps={r['qps']:.1f}"
            )
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
