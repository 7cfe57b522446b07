"""Array-level late fusion for hybrid retrieval (counterpart of
``osr_tpu/retrieval/fusion.py``; NumPy on the host, as there).

The reference's hybrid experiment (reference
rag_system/configs/ms_marco_paper_results.yaml: sparse 0.3 + dense 0.7)
implies per-query min-max normalization of each retriever's top-``depth``
results followed by a weighted sum. The first osr_tpu implementation did
exactly that on Python result *dicts* — measured 13x slower than the
sparse engine alone (bench_results/hybrid.jsonl r3 rows), dominated by
dict assembly + per-doc merges.

This module fuses on the engines' native (scores, ids) arrays instead:
one vectorized NumPy pass per batch — normalize both sides, concatenate,
sort rows by id to collapse duplicates (each side's ids are unique, so
runs have length <= 2), then one argpartition for the fused top-k. The
result dict is assembled once, at the end, for the final k only.

Semantics match the dict path exactly: entries with score <= 0 are
dropped *before* normalization (the engines' result contract), the
minimum kept score normalizes to 0.0 and is still a valid (kept) result,
and a single kept score normalizes to 0.0 (span fallback 1.0).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

_NEG_INF = np.float32(-np.inf)
_SENTINEL = np.int64(np.iinfo(np.int64).max)


def _normalize_rows(
    scores: np.ndarray, ids: np.ndarray, weight: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row min-max over the kept (score > 0, valid id) entries, scaled
    by ``weight``; dropped entries get id=sentinel / score=-inf so they
    sort last and never collide with a real doc id."""
    scores = np.asarray(scores, dtype=np.float32)
    ids64 = np.asarray(ids, dtype=np.int64)
    keep = (scores > 0) & (ids64 >= 0)
    lo = np.min(np.where(keep, scores, np.inf), axis=1, keepdims=True)
    hi = np.max(np.where(keep, scores, -np.inf), axis=1, keepdims=True)
    none_kept = ~keep.any(axis=1, keepdims=True)
    lo = np.where(none_kept, 0.0, lo)
    hi = np.where(none_kept, 0.0, hi)
    span = hi - lo
    span = np.where(span == 0.0, 1.0, span)
    norm = (scores - lo) / span * np.float32(weight)
    norm = np.where(keep, norm, _NEG_INF).astype(np.float32)
    out_ids = np.where(keep, ids64, _SENTINEL)
    return norm, out_ids


def _rrf_rows(
    scores: np.ndarray, ids: np.ndarray, weight: float, rrf_k: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Reciprocal-rank-fusion contributions: ``weight / (rrf_k + rank)``
    with rank = 1-based position of each kept entry in descending-score
    order (stable, so the engines' own tie order is preserved). Dropped
    entries get id=sentinel / score=-inf like :func:`_normalize_rows`.

    Rank-based fusion is score-scale-free: the weighted min-max fusion
    the reference's hybrid config implies can be dominated by the weaker
    leg when its normalized scores are spread out (measured: hybrid
    nDCG@10 0.448 vs BM25-alone 0.622 on the 87k-doc noisy regime,
    bench_results/quality_real_text.json at_scale_noisy)."""
    scores = np.asarray(scores, dtype=np.float32)
    ids64 = np.asarray(ids, dtype=np.int64)
    keep = (scores > 0) & (ids64 >= 0)
    masked = np.where(keep, scores, _NEG_INF)
    order = np.argsort(-masked, axis=1, kind="stable")
    ranks = np.empty(order.shape, dtype=np.int64)
    seq = np.broadcast_to(
        np.arange(1, order.shape[1] + 1, dtype=np.int64), order.shape
    )
    np.put_along_axis(ranks, order, seq, axis=1)
    contrib = np.float32(weight) / (np.float32(rrf_k) + ranks)
    contrib = np.where(keep, contrib, _NEG_INF).astype(np.float32)
    out_ids = np.where(keep, ids64, _SENTINEL)
    return contrib, out_ids


def fuse_topk_arrays(
    sparse_scores: np.ndarray,  # (B, ds)
    sparse_ids: np.ndarray,  # (B, ds) int doc indices (<0 = empty slot)
    dense_scores: np.ndarray,  # (B, dd)
    dense_ids: np.ndarray,  # (B, dd)
    sparse_weight: float,
    dense_weight: float,
    top_k: int,
    mode: str = "weighted",
    rrf_k: float = 60.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fused (scores (B, top_k), ids (B, top_k)) — ids < 0 mark empty
    slots (fewer than top_k fused results for that query).

    ``mode='weighted'`` (default) is the reference-config semantics:
    per-leg min-max normalization then a weighted sum. ``mode='rrf'`` is
    reciprocal rank fusion: ``sum(weight / (rrf_k + rank))`` — rank-based
    and therefore robust to score-scale mismatch between the legs."""
    if mode == "weighted":
        ns, is_ = _normalize_rows(sparse_scores, sparse_ids, sparse_weight)
        nd, id_ = _normalize_rows(dense_scores, dense_ids, dense_weight)
    elif mode == "rrf":
        ns, is_ = _rrf_rows(sparse_scores, sparse_ids, sparse_weight, rrf_k)
        nd, id_ = _rrf_rows(dense_scores, dense_ids, dense_weight, rrf_k)
    else:
        raise ValueError(f"unknown fusion mode: {mode!r}")
    cat_ids = np.concatenate([is_, id_], axis=1)
    cat_sc = np.concatenate([ns, nd], axis=1)

    # Collapse duplicate doc ids (a doc in both top lists sums its two
    # weighted contributions). Each side's ids are unique per row, so any
    # run of equal ids has length exactly 2 — one adjacent add suffices.
    order = np.argsort(cat_ids, axis=1, kind="stable")
    ids_sorted = np.take_along_axis(cat_ids, order, axis=1)
    sc_sorted = np.take_along_axis(cat_sc, order, axis=1)
    dup = ids_sorted[:, 1:] == ids_sorted[:, :-1]
    real = ids_sorted[:, 1:] != _SENTINEL  # sentinel runs stay -inf
    add = np.where(dup & real, sc_sorted[:, 1:], 0.0)
    sc_sorted[:, :-1] += add
    # Kill the absorbed duplicate (the later of the pair).
    sc_sorted[:, 1:][dup & real] = _NEG_INF

    k = min(top_k, sc_sorted.shape[1])
    part = np.argpartition(-sc_sorted, k - 1, axis=1)[:, :k]
    part_sc = np.take_along_axis(sc_sorted, part, axis=1)
    inner = np.argsort(-part_sc, axis=1, kind="stable")
    top_pos = np.take_along_axis(part, inner, axis=1)
    top_sc = np.take_along_axis(sc_sorted, top_pos, axis=1)
    top_ids = np.take_along_axis(ids_sorted, top_pos, axis=1)

    empty = ~np.isfinite(top_sc)
    top_ids = np.where(empty, -1, top_ids)
    top_sc = np.where(empty, 0.0, top_sc).astype(np.float32)
    if k < top_k:
        pad = top_k - k
        top_ids = np.pad(top_ids, ((0, 0), (0, pad)), constant_values=-1)
        top_sc = np.pad(top_sc, ((0, 0), (0, pad)))
    return top_sc, top_ids.astype(np.int64)


def fused_rows_to_results(
    qids: Sequence[str],
    scores: np.ndarray,
    ids: np.ndarray,
    doc_ids: Sequence[str],
) -> Dict[str, Dict[str, float]]:
    """Assemble {qid: {doc_id: fused_score}} from fused arrays with the
    shared batch-vectorized assembler (retrieval/results.py); ``-1`` ids
    are the padding sentinel."""
    from osr_tpu_torch.retrieval.results import (
        as_object_names,
        assemble_result_dicts,
    )

    names = as_object_names(doc_ids)
    dicts = assemble_result_dicts(names, ids, scores, ids >= 0)
    return dict(zip(qids, dicts))
