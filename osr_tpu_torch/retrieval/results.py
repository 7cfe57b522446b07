"""Vectorized result-dict assembly (counterpart of
``osr_tpu/retrieval/results.py``): ``{qid: {doc_id: score}}`` from (B, k)
rows and scores with one mask, one object-array gather and one bulk
``tolist`` for the whole batch."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def as_object_names(doc_ids) -> np.ndarray:
    """Object-dtype doc-id array for vectorized (B, k) -> name gathers."""
    if isinstance(doc_ids, np.ndarray) and doc_ids.dtype == object:
        return doc_ids
    return np.array(doc_ids, dtype=object)


def assemble_result_dicts(
    doc_names: np.ndarray,  # (N,) object ndarray (as_object_names)
    ids: np.ndarray,  # (B, k) integer rows
    scores: np.ndarray,  # (B, k) scores
    mask: np.ndarray,  # (B, k) bool: which entries to keep
) -> List[Dict[str, float]]:
    """One ``{doc_id: score}`` dict per row, in row-major entry order.
    ``mask`` must already exclude out-of-range ids."""
    flat = np.nonzero(mask.ravel())[0]
    names = doc_names[ids.ravel()[flat]].tolist()
    vals = scores.ravel()[flat].astype(np.float64).tolist()
    bounds = np.cumsum(mask.sum(axis=1), dtype=np.int64).tolist()
    out: List[Dict[str, float]] = []
    start = 0
    for end in bounds:
        out.append(dict(zip(names[start:end], vals[start:end])))
        start = end
    return out
