"""Query-batch encoding (counterpart of ``osr_tpu/retrieval/encoding.py``).

Queries split at the index's head/tail boundary (``index/layout.py``):
HEAD terms (id < F) become fixed-shape (B, Q) int32/float32 arrays for the
device scatter + head product; TAIL terms (id >= F) stay on the host as
flat (local id, count, ptr) arrays for the postings walk. Tokenize + count
runs in the shared C++ runtime for ASCII batches when it is available.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from osr_tpu_torch import native
from osr_tpu_torch.index.tokenizer import Tokenizer

# Padded unique-term widths. Queries are short; 128+ steps cover outliers.
QUERY_WIDTH_MENU = (8, 16, 32, 64, 128)


def pick_batch_size(batch_sizes: Sequence[int], n: int) -> int:
    """Smallest menu batch size covering n queries (largest if none do)."""
    for b in batch_sizes:
        if n <= b:
            return b
    return batch_sizes[-1]


def pad_query_width(n_terms: int) -> int:
    for w in QUERY_WIDTH_MENU:
        if n_terms <= w:
            return w
    return ((n_terms + 127) // 128) * 128


class EncodedBatch:
    """Fixed-shape head arrays + flat host-side head/tail term arrays."""

    __slots__ = (
        "head_ids",
        "head_weights",
        "head_flat_ids",
        "head_flat_counts",
        "head_ptr",
        "tail_ids",
        "tail_counts",
        "tail_ptr",
        "num_queries",
    )

    def __init__(
        self,
        head_ids,
        head_weights,
        head_flat_ids,
        head_flat_counts,
        head_ptr,
        tail_ids,
        tail_counts,
        tail_ptr,
        num_queries,
    ):
        self.head_ids = head_ids  # (B, Q) int32, padding = head_terms
        self.head_weights = head_weights  # (B, Q) float32, padding = 0
        self.head_flat_ids = head_flat_ids  # (Nh,) int32 GLOBAL ids
        self.head_flat_counts = head_flat_counts  # (Nh,) float32
        self.head_ptr = head_ptr  # (nq+1,) int64
        self.tail_ids = tail_ids  # (Nt,) int32 LOCAL ids (t - F)
        self.tail_counts = tail_counts  # (Nt,) float32
        self.tail_ptr = tail_ptr  # (nq+1,) int64
        self.num_queries = num_queries


class QueryEncoder:
    """Vocabulary-bound batch encoder with a cached native fast path."""

    def __init__(self, tokenizer: Tokenizer):
        self.tokenizer = tokenizer
        self._native_vocab = None
        self._native_tried = False

    def _native(self):
        if not self._native_tried:
            self._native_tried = True
            vocab = self.tokenizer.vocabulary
            if native.available() and all(t.isascii() for t in vocab):
                terms = [""] * len(vocab)
                for t, i in vocab.items():
                    terms[i] = t
                self._native_vocab = native.NativeVocab(terms)
        return self._native_vocab

    def encode_flat(
        self, texts: Sequence[str]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(tids, counts, ptr): sorted unique in-vocab terms per query."""
        nv = self._native()
        if nv is not None and all(t.isascii() for t in texts):
            return nv.encode_queries(texts)
        encoded = self.tokenizer.encode_batch(texts)
        ptr = np.zeros(len(texts) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=ptr[1:])
        pairs = [p for e in encoded for p in e]
        tids = np.fromiter((t for t, _ in pairs), np.int32, len(pairs))
        counts = np.fromiter((c for _, c in pairs), np.float32, len(pairs))
        return tids, counts, ptr


def encode_query_batch(
    encoder: QueryEncoder,
    texts: Sequence[str],
    batch_size: int,
    head_terms: int,
) -> EncodedBatch:
    """Tokenize up to ``batch_size`` query strings and split head/tail.
    Head padding uses the id ``head_terms``, which the scatter drops."""
    if len(texts) > batch_size:
        raise ValueError(
            f"{len(texts)} queries exceed the engine batch size "
            f"{batch_size}; chunk the batch first"
        )
    tids, counts, ptr = encoder.encode_flat(texts)
    return _split_flat_batch(tids, counts, ptr, batch_size, head_terms)


def _split_flat_batch(
    tids: np.ndarray,  # (N,) int32 sorted unique per query segment
    counts: np.ndarray,  # (N,) float32
    ptr: np.ndarray,  # (nq+1,) int64
    batch_size: int,
    head_terms: int,
) -> EncodedBatch:
    """Split flat queries at the head/tail boundary and build the padded
    (B, Q) head arrays (each query's head terms are a prefix)."""
    nq = len(ptr) - 1
    in_head = tids < head_terms
    qidx = np.repeat(np.arange(nq, dtype=np.int64), np.diff(ptr))
    n_head = np.bincount(qidx[in_head], minlength=nq).astype(np.int64)
    n_tail = np.bincount(qidx[~in_head], minlength=nq).astype(np.int64)
    head_flat_ids = tids[in_head]
    head_flat_counts = counts[in_head]
    head_ptr = np.zeros(nq + 1, dtype=np.int64)
    np.cumsum(n_head, out=head_ptr[1:])
    tail_ids = (tids[~in_head] - head_terms).astype(np.int32)
    tail_counts = counts[~in_head]
    tail_ptr = np.zeros(nq + 1, dtype=np.int64)
    np.cumsum(n_tail, out=tail_ptr[1:])
    q = pad_query_width(int(n_head.max(initial=1)) or 1)
    head_ids = np.full((batch_size, q), head_terms, dtype=np.int32)
    head_weights = np.zeros((batch_size, q), dtype=np.float32)
    if head_flat_ids.size:
        rows = np.repeat(np.arange(nq, dtype=np.int64), n_head)
        cols = np.arange(head_flat_ids.shape[0], dtype=np.int64)
        cols -= np.repeat(head_ptr[:-1], n_head)
        head_ids[rows, cols] = head_flat_ids
        head_weights[rows, cols] = head_flat_counts
    return EncodedBatch(
        head_ids, head_weights, head_flat_ids, head_flat_counts, head_ptr,
        tail_ids, tail_counts, tail_ptr, nq,
    )


def encode_weighted_batch(
    vocabulary,
    queries: Sequence[dict],
    batch_size: int,
    head_terms: int,
) -> EncodedBatch:
    """Encode already-weighted sparse queries ({term: weight}), the
    learned-sparse path: weights are used verbatim, OOV terms dropped,
    weights must be non-negative (the exact merge needs non-negative tail
    contributions)."""
    if len(queries) > batch_size:
        raise ValueError(
            f"{len(queries)} queries exceed the engine batch size "
            f"{batch_size}; chunk the batch first"
        )
    nq = len(queries)
    ptr = np.zeros(nq + 1, dtype=np.int64)
    tids_l, ws_l = [], []
    for i, vec in enumerate(queries):
        pairs = sorted(
            (vocabulary[t], float(w)) for t, w in vec.items() if t in vocabulary
        )
        for tid, w in pairs:
            if w < 0:
                raise ValueError(
                    "learned-sparse query weights must be non-negative"
                )
            tids_l.append(tid)
            ws_l.append(w)
        ptr[i + 1] = len(tids_l)
    tids = np.asarray(tids_l, dtype=np.int32)
    counts = np.asarray(ws_l, dtype=np.float32)
    return _split_flat_batch(tids, counts, ptr, batch_size, head_terms)
