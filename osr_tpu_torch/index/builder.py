"""Sparse index construction (counterpart of ``osr_tpu/index/builder.py``).

Semantics of the reference index build:

- tokenize with ``\\b\\w+\\b`` on lowercased text;
- document length = total token count (with multiplicity);
- BM25 IDF ``log((N - df + 0.5) / (df + 0.5))`` (Robertson; may be
  negative), TF-IDF IDF ``log(N / (df + 1))``.

The per-(doc, term) score weight (BM25 saturation x IDF, or TF x IDF) is
precomputed here, term ids are numbered by descending document frequency
(ties alphabetical) so the dense head is a contiguous id range, and the
term matrix stays as flat arrays end to end. The output is byte-identical
to ``osr_tpu``'s builder, with the shared C++ runtime and without it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from collections import Counter
from typing import Dict, List, Mapping, Optional, Union

import numpy as np

from osr_tpu_torch import native
from osr_tpu_torch.index.layout import (
    DEFAULT_HEAD_BUDGET_BYTES,
    DEFAULT_HEAD_CAP,
    DOC_ALIGN,
    HybridLayout,
    choose_head_terms,
    pack_flat,
    round_up,
)
from osr_tpu_torch.index.tokenizer import Tokenizer, tokenize

logger = logging.getLogger(__name__)

TEXT_FIELDS = ("text", "content", "body", "passage", "document")


def extract_text(doc: Union[str, Mapping]) -> str:
    """The text field of a corpus entry (first non-empty of TEXT_FIELDS)."""
    if isinstance(doc, str):
        return doc
    for field in TEXT_FIELDS:
        value = doc.get(field)
        if value:
            return value
    return ""


def bm25_idf(df: np.ndarray, num_docs: int) -> np.ndarray:
    return np.log((num_docs - df + 0.5) / (df + 0.5)).astype(np.float32)


def tfidf_idf(df: np.ndarray, num_docs: int) -> np.ndarray:
    return np.log(num_docs / (df + 1.0)).astype(np.float32)


def bm25_saturation(
    tf: np.ndarray, doc_len, k1: float, b: float, avgdl: float
) -> np.ndarray:
    norm = k1 * (1.0 - b + b * doc_len / avgdl)
    return tf * (k1 + 1.0) / (tf + norm)


@dataclasses.dataclass
class SparseIndex:
    """A built sparse index: host metadata + the device-ready layout."""

    method: str  # 'bm25' or 'tfidf'
    vocabulary: Dict[str, int]  # term -> id (descending-df order)
    doc_ids: List[str]
    layout: HybridLayout
    idf: np.ndarray  # (V,) float32
    doc_lengths: np.ndarray  # (N,) float32
    avgdl: float
    k1: float
    b: float
    # The IDF-free term matrix, kept when the builder is asked to
    # (keep_raw_rows): what index/cache.py re-weights on a parameter change.
    raw_indptr: Optional[np.ndarray] = None  # (N+1,) int64
    raw_term_ids: Optional[np.ndarray] = None  # (nnz,) int32
    raw_tfs: Optional[np.ndarray] = None  # (nnz,) float32

    @property
    def num_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def vocab_size(self) -> int:
        return len(self.vocabulary)

    def tokenizer(self) -> Tokenizer:
        return Tokenizer(self.vocabulary)

    def stats(self) -> Dict[str, object]:
        s = self.layout.stats()
        s.update(
            {"method": self.method, "avgdl": self.avgdl, "k1": self.k1,
             "b": self.b}
        )
        return s


def compute_weights_flat(
    term_ids: np.ndarray,
    tfs: np.ndarray,
    indptr: np.ndarray,
    doc_lengths: np.ndarray,
    idf: np.ndarray,
    method: str,
    k1: float,
    b: float,
    avgdl: float,
) -> np.ndarray:
    """Per-(doc, term) score weights in one vectorized pass."""
    if term_ids.size == 0:
        return np.zeros(0, dtype=np.float32)
    if method == "bm25":
        dl = np.repeat(doc_lengths, np.diff(indptr))
        sat = bm25_saturation(tfs, dl, k1, b, avgdl)
        return (idf[term_ids] * sat).astype(np.float32)
    return (idf[term_ids] * tfs).astype(np.float32)


class SparseIndexBuilder:
    """Builds a :class:`SparseIndex` from a corpus mapping doc_id -> doc."""

    def __init__(
        self,
        method: str = "bm25",
        k1: float = 1.2,
        b: float = 0.75,
        head_terms: Optional[int] = None,
        head_budget_bytes: int = DEFAULT_HEAD_BUDGET_BYTES,
        head_cap: int = DEFAULT_HEAD_CAP,
        head_dtype: str = "int8",  # 'int8' | 'int4' | 'bf16' | 'f32'
        keep_raw_rows: bool = False,  # keep the term matrix (index cache)
    ):
        method = method.lower()
        if method in ("bm25", "bm25_custom", "bm25_retriever"):
            method = "bm25"
        elif method in ("tfidf", "tf-idf", "dpr", "contriever", "splade"):
            method = "tfidf"
        else:
            raise ValueError(f"Unknown sparse method: {method}")
        self.method = method
        self.k1 = float(k1)
        self.b = float(b)
        self.head_terms = head_terms
        self.head_budget_bytes = head_budget_bytes
        self.head_cap = head_cap
        self.head_dtype = head_dtype
        self.keep_raw_rows = keep_raw_rows

    @staticmethod
    def _count_corpus_native(texts: List[str]):
        """Tokenize + TF-count in C++; None when the runtime is missing or
        the corpus is not ASCII (the C tokenizer matches the regex only on
        ASCII)."""
        if not native.available():
            return None
        encoded: List[bytes] = []
        for t in texts:
            if not t.isascii():
                return None
            encoded.append(t.encode("ascii"))
        offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        indptr, temp_ids, counts, doc_lengths, df_temp, terms = (
            native.build_corpus_tf(b"".join(encoded), offsets)
        )
        order = sorted(
            range(len(terms)), key=lambda i: (-int(df_temp[i]), terms[i])
        )
        order_arr = np.asarray(order, dtype=np.int64)
        final_of_temp = np.empty(len(terms), dtype=np.int32)
        final_of_temp[order_arr] = np.arange(len(terms), dtype=np.int32)
        vocabulary = {terms[t]: int(f) for f, t in enumerate(order)}
        return (
            vocabulary, df_temp[order_arr], doc_lengths, indptr,
            final_of_temp[temp_ids], counts,
        )

    @staticmethod
    def _count_corpus_python(texts: List[str]):
        """Reference counting: regex tokenizer + Counters; rows keep
        first-seen term order, as the native path does."""
        doc_counts: List[Counter] = []
        df_counter: Counter = Counter()
        doc_lengths = np.zeros(len(texts), dtype=np.float32)
        for i, text in enumerate(texts):
            toks = tokenize(text)
            doc_lengths[i] = len(toks)
            counts = Counter(toks)
            doc_counts.append(counts)
            df_counter.update(counts.keys())
        terms_sorted = sorted(df_counter.items(), key=lambda kv: (-kv[1], kv[0]))
        vocabulary = {t: i for i, (t, _) in enumerate(terms_sorted)}
        df = np.fromiter(
            (c for _, c in terms_sorted), dtype=np.int64, count=len(terms_sorted)
        )
        indptr = np.zeros(len(texts) + 1, dtype=np.int64)
        np.cumsum([len(c) for c in doc_counts], out=indptr[1:])
        nnz = int(indptr[-1])
        flat_tids = np.empty(nnz, dtype=np.int32)
        flat_tfs = np.empty(nnz, dtype=np.float32)
        pos = 0
        for counts in doc_counts:
            n = len(counts)
            if n:
                flat_tids[pos : pos + n] = np.fromiter(
                    (vocabulary[t] for t in counts), dtype=np.int32, count=n
                )
                flat_tfs[pos : pos + n] = np.fromiter(
                    counts.values(), dtype=np.float32, count=n
                )
            pos += n
        return vocabulary, df, doc_lengths, indptr, flat_tids, flat_tfs

    def _pack_native(
        self, indptr, flat_tids, flat_tfs, doc_lengths, idf, num_docs,
        vocab_size, head_terms, avgdl,
    ) -> Optional[HybridLayout]:
        """Fused C++ weight + pack (int8/int4 heads), bit-identical to
        compute_weights_flat + pack_flat; None when it does not apply."""
        if self.head_dtype not in ("int8", "int4"):
            return None
        if not native.available():
            return None
        pack = (
            native.pack_hybrid_int8_native
            if self.head_dtype == "int8"
            else native.pack_hybrid_int4_native
        )
        rows = max(round_up(num_docs, DOC_ALIGN), DOC_ALIGN)
        head, scales, post_ptr, post_rows, post_weights = pack(
            indptr, flat_tids, flat_tfs, doc_lengths, idf,
            rows, head_terms, vocab_size, self.method,
            self.k1, self.b, avgdl,
        )
        valid = np.zeros(rows, dtype=bool)
        valid[:num_docs] = True
        return HybridLayout(
            head_terms=head_terms,
            head=head,
            head_scales=scales,
            post_ptr=post_ptr,
            post_rows=post_rows,
            post_weights=post_weights,
            valid=valid,
            num_docs=num_docs,
            vocab_size=vocab_size,
            head_dtype=self.head_dtype,
        )

    def build(self, corpus: Mapping[str, Union[str, Mapping]]) -> SparseIndex:
        if not corpus:
            raise ValueError("Empty corpus provided")
        t0 = time.perf_counter()
        doc_ids = list(corpus.keys())
        texts = [extract_text(corpus[d]) for d in doc_ids]
        counted = self._count_corpus_native(texts)
        if counted is None:
            counted = self._count_corpus_python(texts)
        return self.build_from_term_matrix(*counted, doc_ids, t0=t0)

    def build_from_term_matrix(
        self,
        vocabulary: Dict[str, int],
        df: np.ndarray,
        doc_lengths: np.ndarray,
        indptr: np.ndarray,
        flat_tids: np.ndarray,
        flat_tfs: np.ndarray,
        doc_ids: List[str],
        t0: Optional[float] = None,
    ) -> SparseIndex:
        """Weight + pack an already-counted term matrix."""
        if t0 is None:
            t0 = time.perf_counter()
        vocab_size = len(vocabulary)
        num_docs = len(doc_ids)
        avgdl = float(doc_lengths.mean()) if num_docs else 0.0
        idf = (
            bm25_idf(df, num_docs)
            if self.method == "bm25"
            else tfidf_idf(df, num_docs)
        )
        # IDF ascends with rank, so non-positive-IDF terms are a prefix;
        # they must land in the head (layout.py exactness).
        n_nonpos = int(np.searchsorted(idf, 0.0, side="right"))
        budget = self.head_budget_bytes
        if self.head_dtype == "int4":
            budget *= 2  # two head elements per byte
        f = choose_head_terms(
            num_docs, vocab_size, df, n_nonpos, self.head_terms, budget,
            self.head_cap,
        )
        if self.head_dtype == "int4" and self.head_terms is None:
            # Keep the packed width 128-aligned (F % 256) when the
            # vocabulary allows, as osr_tpu does.
            aligned = round_up(f, 256)
            if aligned <= vocab_size:
                f = aligned
        layout = self._pack_native(
            indptr, flat_tids, flat_tfs, doc_lengths, idf, num_docs,
            vocab_size, f, avgdl,
        )
        if layout is None:
            weights = compute_weights_flat(
                flat_tids, flat_tfs, indptr, doc_lengths, idf, self.method,
                self.k1, self.b, avgdl,
            )
            doc_idx = np.repeat(
                np.arange(num_docs, dtype=np.int64), np.diff(indptr)
            )
            layout = pack_flat(
                doc_idx, flat_tids, weights, num_docs, vocab_size,
                head_terms=f, head_dtype=self.head_dtype,
            )
        index = SparseIndex(
            method=self.method,
            vocabulary=vocabulary,
            doc_ids=doc_ids,
            layout=layout,
            idf=idf,
            doc_lengths=doc_lengths,
            avgdl=avgdl,
            k1=self.k1,
            b=self.b,
            raw_indptr=indptr if self.keep_raw_rows else None,
            raw_term_ids=flat_tids if self.keep_raw_rows else None,
            raw_tfs=flat_tfs if self.keep_raw_rows else None,
        )
        logger.info(
            "Built %s index: %d docs, %d terms, head=%d (%s), tail_nnz=%d, "
            "%.1f MB in %.2fs",
            self.method, num_docs, vocab_size, f, self.head_dtype,
            layout.tail_nnz, layout.nbytes / 2**20, time.perf_counter() - t0,
        )
        return index


def corpus_fingerprint(corpus: Mapping[str, object]) -> str:
    """Cache key for a corpus (``osr_tpu``'s, so both packages name a
    corpus's cache file alike): md5 over the corpus size, every doc id,
    every document's text length and a strided sample of 128-character
    text prefixes, first 16 hex digits. An edit to any document changes
    it unless the edit keeps the length and misses the sampled prefixes."""
    h = hashlib.md5()
    h.update(str(len(corpus)).encode())
    ids = sorted(str(k) for k in corpus.keys())
    lengths = bytearray()
    for doc_id in ids:
        h.update(doc_id.encode())
        lengths += len(extract_text(corpus[doc_id])).to_bytes(8, "little")
    h.update(bytes(lengths))
    stride = max(1, len(ids) // 128)
    for doc_id in ids[::stride]:
        h.update(extract_text(corpus[doc_id])[:128].encode())
    return h.hexdigest()[:16]
