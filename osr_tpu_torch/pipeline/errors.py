"""Post-hoc error analysis of RAG predictions (counterpart of
``osr_tpu/pipeline/errors.py``).

Capability parity with reference rag_system/pipeline/analyze_errors.py:
bucket failed queries into no_gold_standard / no_retrieval /
retriever_miss / reader_issue (:94-130) and compute per-query retrieval
recall/precision against the qrels (:133-172), emitting a report (:175+).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Mapping, Sequence, Union

CATEGORIES = (
    "no_gold_standard",
    "no_retrieval",
    "retriever_miss",
    "reader_issue",
    "ok",
)


def categorize_errors(
    predictions: Sequence[Mapping[str, Any]],
    qrels: Mapping[str, Mapping[str, int]],
) -> Dict[str, List[str]]:
    """Bucket each prediction into an error category.

    - no_gold_standard: query has no positive qrels
    - no_retrieval: nothing was retrieved
    - retriever_miss: retrieved, but no relevant doc among contexts
    - reader_issue: relevant doc retrieved, but the answer is empty or a
      fallback message
    - ok: none of the above
    """
    buckets: Dict[str, List[str]] = {c: [] for c in CATEGORIES}
    for pred in predictions:
        qid = pred.get("qid")
        if qid is None:
            continue
        relevant = {
            d for d, r in qrels.get(qid, {}).items() if r > 0
        }
        retrieved = [c.get("docid") for c in pred.get("contexts", [])]
        if not relevant:
            buckets["no_gold_standard"].append(qid)
            continue
        if not retrieved:
            buckets["no_retrieval"].append(qid)
            continue
        if not (set(retrieved) & relevant):
            buckets["retriever_miss"].append(qid)
            continue
        answer = (pred.get("answer") or "").strip()
        if not answer or answer.lower().startswith(
            ("no sufficient", "unable to", "i don't have")
        ):
            buckets["reader_issue"].append(qid)
            continue
        buckets["ok"].append(qid)
    return buckets


def analyze_retrieval_performance(
    predictions: Sequence[Mapping[str, Any]],
    qrels: Mapping[str, Mapping[str, int]],
) -> Dict[str, Any]:
    """Per-query context recall/precision vs qrels, plus aggregates."""
    per_query: Dict[str, Dict[str, float]] = {}
    for pred in predictions:
        qid = pred.get("qid")
        relevant = {d for d, r in qrels.get(qid, {}).items() if r > 0}
        if not relevant:
            continue
        retrieved = [c.get("docid") for c in pred.get("contexts", [])]
        hit = len(set(retrieved) & relevant)
        per_query[qid] = {
            "recall": hit / len(relevant),
            "precision": hit / len(retrieved) if retrieved else 0.0,
            "num_retrieved": len(retrieved),
            "num_relevant": len(relevant),
        }
    n = len(per_query)
    mean = lambda key: (
        sum(v[key] for v in per_query.values()) / n if n else 0.0
    )
    return {
        "queries_evaluated": n,
        "avg_recall": mean("recall"),
        "avg_precision": mean("precision"),
        "per_query": per_query,
    }


def generate_error_report(
    predictions: Sequence[Mapping[str, Any]],
    qrels: Mapping[str, Mapping[str, int]],
    out_path: Union[str, Path, None] = None,
) -> Dict[str, Any]:
    buckets = categorize_errors(predictions, qrels)
    retrieval = analyze_retrieval_performance(predictions, qrels)
    total = sum(len(v) for v in buckets.values())
    report = {
        "total_predictions": total,
        "category_counts": {c: len(v) for c, v in buckets.items()},
        "category_fractions": {
            c: len(v) / total if total else 0.0 for c, v in buckets.items()
        },
        "retrieval_performance": {
            k: v for k, v in retrieval.items() if k != "per_query"
        },
        "categories": buckets,
    }
    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, ensure_ascii=False)
    return report
