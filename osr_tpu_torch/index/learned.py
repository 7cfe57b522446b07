"""Learned-sparse (SPLADE-style) index ingestion (counterpart of
``osr_tpu/index/learned.py``).

The reference lists SPLADE among its benchmark methods
(reference bench/fiqa_benchmark.py:47-52) but routes the pipeline's
``splade`` experiments to the TF-IDF kernel over the term matrix
(reference evaluate_rag_pipeline.py:392-399). This module adds the real
capability: ingest EXTERNAL per-document (term, weight) vectors — the
output of a learned sparse encoder — into the same hybrid head/postings
layout, scored by the same engine. Scoring is the standard learned-sparse
inner product: score(q, d) = sum_t w_q(t) * w_d(t).

Exactness note: learned-sparse weights are non-negative (SPLADE applies a
ReLU + log-saturation), which the engine's head-topk/candidate merge
requires of tail weights (ops/bm25.py). Negative document weights
are rejected at build time.

Accepted vector formats (see :func:`load_learned_vectors`):
  - ``.npz``: doc_ids_json, vocab_json, indptr (N+1,), term_ids (nnz,),
    weights (nnz,)
  - ``.jsonl``: one object per line: {"id": ..., "vector": {term: weight}}
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from osr_tpu_torch.index.builder import SparseIndex
from osr_tpu_torch.index.layout import (
    DEFAULT_HEAD_BUDGET_BYTES,
    DEFAULT_HEAD_CAP,
    choose_head_terms,
    pack_flat,
)


def load_learned_vectors(
    path: Union[str, Path],
) -> Tuple[List[str], List[str], np.ndarray, np.ndarray, np.ndarray]:
    """Load external learned-sparse vectors.

    Returns (doc_ids, terms, indptr, term_ids, weights) with term_ids
    indexing into ``terms``.
    """
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path, allow_pickle=False) as z:
            doc_ids = json.loads(str(z["doc_ids_json"]))
            terms = json.loads(str(z["vocab_json"]))
            return (
                doc_ids,
                terms,
                z["indptr"].astype(np.int64),
                z["term_ids"].astype(np.int32),
                z["weights"].astype(np.float32),
            )
    doc_ids: List[str] = []
    vocab: Dict[str, int] = {}
    rows: List[Tuple[np.ndarray, np.ndarray]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            doc_ids.append(str(rec.get("id", rec.get("_id", len(doc_ids)))))
            vec = rec.get("vector", {})
            tids = np.empty(len(vec), dtype=np.int32)
            ws = np.empty(len(vec), dtype=np.float32)
            for i, (t, w) in enumerate(vec.items()):
                tids[i] = vocab.setdefault(t, len(vocab))
                ws[i] = w
            rows.append((tids, ws))
    indptr = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum([len(t) for t, _ in rows], out=indptr[1:])
    term_ids = (
        np.concatenate([t for t, _ in rows])
        if rows
        else np.zeros(0, np.int32)
    )
    weights = (
        np.concatenate([w for _, w in rows])
        if rows
        else np.zeros(0, np.float32)
    )
    terms = [""] * len(vocab)
    for t, i in vocab.items():
        terms[i] = t
    return doc_ids, terms, indptr, term_ids, weights


class LearnedSparseIndexBuilder:
    """Builds a :class:`SparseIndex` from external (term, weight) vectors.

    The vocabulary is renumbered by descending document frequency so the
    highest-traffic terms land in the dense head (same layout policy as the
    lexical builder; index/layout.py).
    """

    def __init__(
        self,
        head_terms: Optional[int] = None,
        head_budget_bytes: int = DEFAULT_HEAD_BUDGET_BYTES,
        head_cap: int = DEFAULT_HEAD_CAP,
        head_dtype: str = "int8",
    ):
        self.head_terms = head_terms
        self.head_budget_bytes = head_budget_bytes
        self.head_cap = head_cap
        self.head_dtype = head_dtype

    def build_from_arrays(
        self,
        doc_ids: List[str],
        terms: List[str],
        indptr: np.ndarray,
        term_ids: np.ndarray,
        weights: np.ndarray,
    ) -> SparseIndex:
        weights = np.asarray(weights, dtype=np.float32)
        if weights.size and float(weights.min()) < 0:
            raise ValueError(
                "Learned-sparse document weights must be non-negative "
                "(the exact head/tail merge relies on it)"
            )
        num_docs = len(doc_ids)
        n_terms = len(terms)
        df = np.bincount(term_ids, minlength=n_terms).astype(np.int64)
        order = np.lexsort((np.asarray(terms), -df))  # df desc, ties by term
        final_of_old = np.empty(n_terms, dtype=np.int32)
        final_of_old[order] = np.arange(n_terms, dtype=np.int32)
        vocabulary = {terms[o]: int(i) for i, o in enumerate(order)}
        new_tids = final_of_old[term_ids]
        df_sorted = df[order]

        f = choose_head_terms(
            num_docs,
            n_terms,
            df_sorted,
            0,  # learned weights are non-negative: no IDF floor needed
            self.head_terms,
            self.head_budget_bytes,
            self.head_cap,
        )
        doc_idx = np.repeat(
            np.arange(num_docs, dtype=np.int64), np.diff(indptr)
        )
        layout = pack_flat(
            doc_idx,
            new_tids,
            weights,
            num_docs,
            n_terms,
            head_terms=f,
            head_dtype=self.head_dtype,
        )
        doc_lengths = np.diff(indptr).astype(np.float32)
        return SparseIndex(
            method="splade",
            vocabulary=vocabulary,
            doc_ids=[str(d) for d in doc_ids],
            layout=layout,
            idf=np.ones(n_terms, dtype=np.float32),  # weights are final
            doc_lengths=doc_lengths,
            avgdl=float(doc_lengths.mean()) if num_docs else 0.0,
            k1=0.0,
            b=0.0,
        )

    def build(
        self, vectors: Union[str, Path, Mapping[str, Mapping[str, float]]]
    ) -> SparseIndex:
        """Build from a vectors file path or an in-memory mapping
        ``{doc_id: {term: weight}}``."""
        if isinstance(vectors, (str, Path)):
            return self.build_from_arrays(*load_learned_vectors(vectors))
        doc_ids = list(vectors.keys())
        vocab: Dict[str, int] = {}
        indptr = np.zeros(len(doc_ids) + 1, dtype=np.int64)
        tids_l, ws_l = [], []
        for i, d in enumerate(doc_ids):
            vec = vectors[d]
            indptr[i + 1] = indptr[i] + len(vec)
            for t, w in vec.items():
                tids_l.append(vocab.setdefault(t, len(vocab)))
                ws_l.append(w)
        terms = [""] * len(vocab)
        for t, i in vocab.items():
            terms[i] = t
        return self.build_from_arrays(
            doc_ids,
            terms,
            indptr,
            np.asarray(tids_l, dtype=np.int32),
            np.asarray(ws_l, dtype=np.float32),
        )
