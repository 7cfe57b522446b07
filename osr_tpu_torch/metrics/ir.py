"""Retrieval quality metrics, implemented natively (counterpart of
``osr_tpu/metrics/ir.py``).

The reference delegates nDCG/MAP/Recall/P@k to BEIR's ``EvaluateRetrieval``
(reference bench/fiqa_benchmark.py:194-216), which wraps pytrec_eval (a
torch-adjacent dependency this framework avoids). The definitions here
follow pytrec_eval's so numbers are comparable with the reference's
committed results:

- nDCG@k: LINEAR gains ``rel / log2(rank + 1)`` (Jarvelin & Kekalainen, the
  trec_eval/pytrec_eval ndcg_cut form), ideal DCG from the full qrel set,
  ranks from 1.
- MAP@k: mean average precision cut at k, normalized by the TOTAL number of
  relevant documents (trec_eval map_cut).
- Recall@k: |relevant in top k| / |relevant|.
- P@k: |relevant in top k| / k.

Only qrels entries with relevance > 0 count as relevant, ties are broken by
DESCENDING doc id, and queries with no positively-judged document are
dropped from every measure — all trec_eval behaviors. Queries absent from
qrels are skipped, like BEIR does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

Results = Mapping[str, Mapping[str, float]]  # qid -> {doc_id: score}
Qrels = Mapping[str, Mapping[str, int]]  # qid -> {doc_id: relevance}


def _ranked_docs(scores: Mapping[str, float], k: int) -> List[str]:
    # Score descending, ties by doc id DESCENDING (trec_eval's tie order).
    return [
        d
        for d, _ in sorted(
            scores.items(), key=lambda kv: (kv[1], kv[0]), reverse=True
        )[:k]
    ]


def _has_relevant(rels: Mapping[str, int]) -> bool:
    return any(r > 0 for r in rels.values())


def ndcg_at_k(results: Results, qrels: Qrels, k: int) -> float:
    total, n = 0.0, 0
    for qid, rels in qrels.items():
        if qid not in results or not _has_relevant(rels):
            continue
        n += 1
        ranked = _ranked_docs(results[qid], k)
        dcg = sum(
            rels.get(d, 0) / math.log2(rank + 2)
            for rank, d in enumerate(ranked)
        )
        ideal = sorted((r for r in rels.values() if r > 0), reverse=True)[:k]
        idcg = sum(
            r / math.log2(rank + 2) for rank, r in enumerate(ideal)
        )
        total += dcg / idcg if idcg > 0 else 0.0
    return total / n if n else 0.0


def map_at_k(results: Results, qrels: Qrels, k: int) -> float:
    total, n = 0.0, 0
    for qid, rels in qrels.items():
        if qid not in results or not _has_relevant(rels):
            continue
        n += 1
        relevant = {d for d, r in rels.items() if r > 0}
        hits, ap = 0, 0.0
        for rank, d in enumerate(_ranked_docs(results[qid], k)):
            if d in relevant:
                hits += 1
                ap += hits / (rank + 1)
        total += ap / len(relevant)  # trec_eval map_cut denominator
    return total / n if n else 0.0


def recall_at_k(results: Results, qrels: Qrels, k: int) -> float:
    total, n = 0.0, 0
    for qid, rels in qrels.items():
        if qid not in results or not _has_relevant(rels):
            continue
        relevant = {d for d, r in rels.items() if r > 0}
        n += 1
        got = set(_ranked_docs(results[qid], k))
        total += len(got & relevant) / len(relevant)
    return total / n if n else 0.0


def precision_at_k(results: Results, qrels: Qrels, k: int) -> float:
    total, n = 0.0, 0
    for qid, rels in qrels.items():
        if qid not in results or not _has_relevant(rels):
            continue
        n += 1
        relevant = {d for d, r in rels.items() if r > 0}
        got = _ranked_docs(results[qid], k)
        total += len(set(got) & relevant) / k
    return total / n if n else 0.0


def evaluate_retrieval(
    results: Results,
    qrels: Qrels,
    k_values: Sequence[int] = (10, 100),
) -> Dict[str, float]:
    """The reference's quality-metric set (bench/fiqa_benchmark.py:194-216):
    nDCG@k, MAP@k, Recall@k, P@k for each cutoff."""
    out: Dict[str, float] = {}
    for k in k_values:
        out[f"ndcg@{k}"] = ndcg_at_k(results, qrels, k)
        out[f"map@{k}"] = map_at_k(results, qrels, k)
        out[f"recall@{k}"] = recall_at_k(results, qrels, k)
        out[f"p@{k}"] = precision_at_k(results, qrels, k)
    return out
