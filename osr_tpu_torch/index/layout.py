"""Hybrid dense-head / postings-tail index layout (counterpart of
``osr_tpu/index/layout.py``).

The vocabulary is numbered by descending document frequency, so the F
most common terms occupy ids ``[0, F)``. The **head** holds every
document's weights over those terms as a dense ``(R, F)`` matrix scored
for a whole query batch by one matrix product on the device, stored
quantized (int8 or int4 with per-column scales) or as bf16/f32. The
**tail** (ids ``>= F``) is a term-major inverted file
(``post_ptr/post_rows/post_weights``) walked on the host per query.
Every term with non-positive IDF is forced into the head, so tail weights
are strictly positive, which the exact host merge relies on.

Host arrays are NumPy. A bf16 head is held as its uint16 bit patterns
(round to nearest even), since NumPy has no bfloat16 type.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

DOC_ALIGN = 8  # rows pad to a multiple of this
DEFAULT_HEAD_BUDGET_BYTES = 2 * 1024**3  # head budget, in elements
HEAD_ALIGN = 128  # lane-align the head width when it is not all of V
DEFAULT_HEAD_CAP = 2048
HEAD_DTYPES = ("int8", "int4", "bf16", "f32")


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), round to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32 values (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32
    )


def bf16_round(x: np.ndarray) -> np.ndarray:
    """Round float32 to the nearest bfloat16 value, returned as float32."""
    return bf16_to_f32(bf16_bits(x))


def unpack_int4(packed: np.ndarray, f: int) -> np.ndarray:
    """Decode the block-packed int4 head to int8 codes.

    ``packed`` is (R, ceil(F/2)) uint8 or wider; the LOW nibble of packed
    column c holds logical column c and the HIGH nibble logical column
    ``c + packed.shape[1]``. Codes are unsigned [0, 15]: a head column's
    weights share the sign of its IDF, which the per-column signed scale
    carries."""
    lo = (packed & 0xF).astype(np.int8)
    hi = (packed >> 4).astype(np.int8)
    return np.concatenate([lo, hi], axis=1)[:, :f]


def repack_int4(packed: np.ndarray, f: int, width: int) -> np.ndarray:
    """Re-pack an int4 head to a packed width ``width >= ceil(F/2)`` (the
    high-nibble block moves to columns ``c + width``)."""
    codes = np.zeros((packed.shape[0], 2 * width), dtype=np.uint8)
    codes[:, :f] = unpack_int4(packed, f)
    return (codes[:, :width] | (codes[:, width:] << 4)).astype(np.uint8)


@dataclasses.dataclass
class HybridLayout:
    """Device-ready head + host-resident postings tail."""

    head_terms: int  # F
    head: np.ndarray  # (R, F) int8 | (R, ceil(F/2)) uint8 | uint16 bf16 | f32
    head_scales: Optional[np.ndarray]  # (F,) f32 per-column (int8/int4)
    post_ptr: np.ndarray  # (V - F + 1,) int64
    post_rows: np.ndarray  # (nnz_tail,) int32, ascending per term
    post_weights: np.ndarray  # (nnz_tail,) float32
    valid: np.ndarray  # (R,) bool, False on alignment padding
    num_docs: int
    vocab_size: int
    head_dtype: str

    @property
    def num_rows(self) -> int:
        return self.head.shape[0]

    @property
    def tail_nnz(self) -> int:
        return int(self.post_rows.shape[0])

    @property
    def max_tail_df(self) -> int:
        if self.post_ptr.shape[0] <= 1:
            return 0
        return int(np.diff(self.post_ptr).max(initial=0))

    @property
    def nbytes(self) -> int:
        n = self.head.nbytes + self.post_ptr.nbytes
        n += self.post_rows.nbytes + self.post_weights.nbytes
        if self.head_scales is not None:
            n += self.head_scales.nbytes
        return n

    def stats(self) -> Dict[str, object]:
        return {
            "num_docs": self.num_docs,
            "num_rows": self.num_rows,
            "vocab_size": self.vocab_size,
            "head_terms": self.head_terms,
            "head_dtype": self.head_dtype,
            "head_mb": self.head.nbytes / 2**20,
            "tail_nnz": self.tail_nnz,
            "max_tail_df": self.max_tail_df,
            "postings_mb": (
                self.post_ptr.nbytes
                + self.post_rows.nbytes
                + self.post_weights.nbytes
            )
            / 2**20,
            "memory_mb": self.nbytes / 2**20,
        }


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def choose_head_terms(
    num_docs: int,
    vocab_size: int,
    df: np.ndarray,  # (V,) document frequencies, descending
    n_nonpositive_idf: int,
    head_terms: Optional[int] = None,
    head_budget_bytes: int = DEFAULT_HEAD_BUDGET_BYTES,
    head_cap: int = DEFAULT_HEAD_CAP,
) -> int:
    """F: at least every non-positive-IDF term; an explicit ``head_terms``
    above that floor; else the largest lane-aligned width within the
    budget, capped at ``head_cap``."""
    floor = min(n_nonpositive_idf, vocab_size)
    if head_terms is not None:
        return max(min(head_terms, vocab_size), floor)
    rows = max(round_up(num_docs, DOC_ALIGN), 1)
    f = int(min(head_cap, head_budget_bytes // rows, vocab_size))
    if f < vocab_size:
        f = (f // HEAD_ALIGN) * HEAD_ALIGN
    return max(f, floor, 0)


def pack_flat(
    doc_idx: np.ndarray,  # (nnz,) document index per entry, non-decreasing
    term_ids: np.ndarray,  # (nnz,) int32 term ids (descending-df order)
    weights: np.ndarray,  # (nnz,) float32 score weights
    num_docs: int,
    vocab_size: int,
    head_terms: int,
    head_dtype: str = "int8",
) -> HybridLayout:
    """Pack flat (doc, term, weight) triples into the hybrid layout; the
    NumPy reference of the native pack (byte-identical)."""
    if head_dtype not in HEAD_DTYPES:
        raise ValueError(f"Unknown head_dtype: {head_dtype}")
    f = head_terms
    rows = max(round_up(num_docs, DOC_ALIGN), DOC_ALIGN)
    doc_idx = np.asarray(doc_idx)
    term_ids = np.asarray(term_ids)
    weights = np.asarray(weights, dtype=np.float32)
    in_head = term_ids < f

    head_scales: Optional[np.ndarray] = None
    h_docs, h_terms, h_w = doc_idx[in_head], term_ids[in_head], weights[in_head]
    if head_dtype == "int8":
        colmax = np.zeros(f, dtype=np.float32)
        if h_terms.size:
            np.maximum.at(colmax, h_terms, np.abs(h_w))
        head_scales = np.where(colmax > 0, colmax / 127.0, 1.0).astype(
            np.float32
        )
        head = np.zeros((rows, f), dtype=np.int8)
        if h_terms.size:
            q = np.rint(h_w / head_scales[h_terms])
            head[h_docs, h_terms] = np.clip(q, -127, 127).astype(np.int8)
    elif head_dtype == "int4":
        colmax = np.zeros(f, dtype=np.float32)
        colmin = np.zeros(f, dtype=np.float32)
        if h_terms.size:
            np.maximum.at(colmax, h_terms, h_w)
            np.minimum.at(colmin, h_terms, h_w)
        head_scales = np.where(
            colmax > 0,
            colmax / 15.0,
            np.where(colmin < 0, colmin / 15.0, 1.0),
        ).astype(np.float32)
        fp = (f + 1) // 2
        codes = np.zeros((rows, 2 * fp), dtype=np.uint8)
        if h_terms.size:
            q = np.clip(np.rint(h_w / head_scales[h_terms]), 0, 15)
            codes[h_docs, h_terms] = q.astype(np.uint8)
        head = (codes[:, :fp] | (codes[:, fp:] << 4)).astype(np.uint8)
    elif head_dtype == "bf16":
        head = np.zeros((rows, f), dtype=np.uint16)
        if h_terms.size:
            head[h_docs, h_terms] = bf16_bits(h_w)
    else:
        head = np.zeros((rows, f), dtype=np.float32)
        if h_terms.size:
            head[h_docs, h_terms] = h_w

    # Term-major tail postings, rows ascending within each term.
    in_tail = ~in_head
    t_docs = doc_idx[in_tail].astype(np.int32)
    t_terms = term_ids[in_tail] - f
    t_w = weights[in_tail]
    n_tail_terms = vocab_size - f
    order = np.argsort(t_terms, kind="stable")
    post_rows = np.ascontiguousarray(t_docs[order])
    post_weights = np.ascontiguousarray(t_w[order])
    counts = np.bincount(t_terms, minlength=max(n_tail_terms, 0))
    post_ptr = np.zeros(n_tail_terms + 1, dtype=np.int64)
    if n_tail_terms > 0:
        np.cumsum(counts[:n_tail_terms], out=post_ptr[1:])

    valid = np.zeros(rows, dtype=bool)
    valid[:num_docs] = True
    return HybridLayout(
        head_terms=f,
        head=head,
        head_scales=head_scales,
        post_ptr=post_ptr,
        post_rows=post_rows,
        post_weights=post_weights,
        valid=valid,
        num_docs=num_docs,
        vocab_size=vocab_size,
        head_dtype=head_dtype,
    )
