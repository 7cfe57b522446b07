"""ctypes bindings to the port's C++ host runtime,
``osr_tpu_torch/csrc/host_runtime.cc``.

The port's counterpart of ``osr_tpu.native``, limited to the functions
its search path, its index builder and its HashingEncoder call. The
runtime is the port's own copy of those loops: it compiles at first use
with ``$CXX`` (or ``g++``) into ``build/osr_tpu_torch/``
(``ops/_build.py:build_host``), and every entry point carries the
``osrh_`` prefix, so a process that also loads ``osr_tpu``'s runtime never
mixes the two. It leaves the process's allocator alone, and its tail
walker takes any int32 row count.

Nothing loads or builds at import: :func:`library` builds and loads the
runtime when first called and raises ImportError, with the compiler's
output, when it cannot (the failure is remembered for the life of the
process). On the CPU every caller then takes its NumPy body, as in
``osr_tpu``; the engines on a CUDA device call :func:`library` and raise
instead (``retrieval/engine.py:host_runtime``).
"""

from __future__ import annotations

import ctypes
import threading
import types
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from osr_tpu_torch.index.layout import bf16_round
from osr_tpu_torch.ops import _build

_ABI_VERSION = 1  # osrh_abi_version() in csrc/host_runtime.cc
_PREFIX = "osrh_"

_lock = threading.Lock()
_lib: Optional[types.SimpleNamespace] = None
_error: Optional[str] = None


def _signatures():
    """restype and argtypes of each entry point, by unprefixed name."""
    c_char_p = ctypes.c_char_p
    c_void_p = ctypes.c_void_p
    c_i64 = ctypes.c_int64
    c_int = ctypes.c_int
    c_dbl = ctypes.c_double
    c_u64 = ctypes.c_uint64
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    p_i8 = ctypes.POINTER(ctypes.c_int8)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_u64 = ctypes.POINTER(c_u64)
    pp_char = ctypes.POINTER(c_char_p)
    pack_args = [
        p_i64, c_i64, c_i64, p_i32, p_f32, p_f32, p_f32, c_i64, c_i64,
        c_int, c_dbl, c_dbl, c_dbl,
    ]
    return {
        "set_num_threads": (None, [c_int]),
        "get_num_threads": (c_int, []),
        "tf_build": (c_void_p, [c_char_p, c_i64, p_i64, c_i64]),
        "tf_num_terms": (c_i64, [c_void_p]),
        "tf_nnz": (c_i64, [c_void_p]),
        "tf_term_bytes": (c_i64, [c_void_p]),
        "tf_copy": (None, [
            c_void_p, p_i64, p_i32, p_f32, p_f32, p_i64, c_char_p, p_i64,
        ]),
        "tf_free": (None, [c_void_p]),
        "tokenize_ascii": (c_i64, [
            c_char_p, c_i64, c_char_p, p_i64, p_i64, c_i64,
        ]),
        "vocab_build": (c_void_p, [c_char_p, p_i64, c_i64]),
        "vocab_free": (None, [c_void_p]),
        "encode_queries": (c_i64, [
            c_void_p, c_char_p, p_i64, c_i64, p_i32, p_f32, p_i64, c_i64,
        ]),
        "tail_candidates": (c_i64, [
            p_i64, p_i32, p_f32, p_i32, p_f32, p_i64, c_i64,
            p_i32, p_i32, p_f32, p_i64, c_i64,
        ]),
        "cand_head_dot": (None, [
            c_void_p, c_i64, p_f32, c_i64, p_i32, p_i32, c_i64,
            p_i32, p_f32, p_i64, p_f32,
        ]),
        "merge_topk": (None, [
            p_f32, p_i32, c_i64, c_i64, p_i32, p_f32, p_i64, c_i64, p_f32,
            p_f32, p_i32,
        ]),
        "transpose_i8": (None, [p_i8, c_i64, c_i64, p_i8]),
        "cand_head_dot_t": (None, [
            p_i8, c_i64, p_i32, p_i64, c_i64, p_i32, p_f32, p_i64, p_f32,
        ]),
        "pack_hybrid_int8": (c_i64, pack_args + [
            p_i8, p_f32, p_i64, p_i32, p_f32, c_i64,
        ]),
        "pack_hybrid_int4": (c_i64, pack_args + [
            p_u8, p_f32, p_i64, p_i32, p_f32, c_i64,
        ]),
        "henc_create": (c_void_p, [c_i64, c_i64, c_int]),
        "henc_free": (None, [c_void_p]),
        "henc_hash": (c_u64, [c_char_p, c_i64]),
        "henc_df_size": (c_i64, [c_void_p]),
        "henc_idf": (c_dbl, [c_void_p, c_u64]),
        "henc_fit": (None, [c_void_p, pp_char, p_i64, c_i64]),
        "henc_export_df": (None, [c_void_p, p_u64, p_i32]),
        "henc_import_df": (None, [c_void_p, p_u64, p_i32, c_i64, c_i64]),
        "henc_encode": (None, [c_void_p, pp_char, p_i64, c_i64, p_f32]),
    }


def _bind(cdll: ctypes.CDLL, path: Path) -> types.SimpleNamespace:
    """The entry points under their unprefixed names, plus ``path``."""
    abi = cdll[_PREFIX + "abi_version"]
    abi.restype = ctypes.c_int64
    abi.argtypes = []
    got = int(abi())
    if got != _ABI_VERSION:
        raise RuntimeError(
            f"host runtime ABI {got}, bindings expect {_ABI_VERSION}"
        )
    lib = types.SimpleNamespace(path=path, cdll=cdll)
    for name, (restype, argtypes) in _signatures().items():
        fn = cdll[_PREFIX + name]
        fn.restype = restype
        fn.argtypes = argtypes
        setattr(lib, name, fn)
    return lib


def library() -> types.SimpleNamespace:
    """The loaded runtime, built first if needed; raises ImportError with
    the compiler's or the loader's message when it cannot be built or
    loaded (the failure is remembered for the life of the process)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if _error is not None:
                raise ImportError(_error)
            try:
                path = _build.build_host()
                _lib = _bind(ctypes.CDLL(str(path)), path)
            except (OSError, RuntimeError, AttributeError) as e:
                _error = (
                    f"the host runtime ({_build.HOST_SOURCE.name}) cannot be "
                    f"built or loaded: {e}"
                )
                raise ImportError(_error) from e
    return _lib


def available() -> bool:
    try:
        library()
        return True
    except ImportError:
        return False


def _i64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def set_num_threads(n: Optional[int]) -> None:
    """Force the runtime's thread count (0 or None restores auto). Every
    parallel section partitions its work deterministically and each thread
    owns a disjoint output range, so results are bit-identical across
    thread counts."""
    library().set_num_threads(int(n or 0))


def get_num_threads() -> int:
    """The thread count a large parallel section of the runtime uses."""
    return int(library().get_num_threads())


def build_corpus_tf(
    texts_ascii: bytes, doc_offsets: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Tokenize + TF-count a concatenated ASCII corpus: (indptr, term ids
    in first-seen order, counts, doc lengths, df, terms)."""
    lib = library()
    ndocs = len(doc_offsets) - 1
    doc_offsets = np.ascontiguousarray(doc_offsets, dtype=np.int64)
    handle = lib.tf_build(texts_ascii, len(texts_ascii), _i64(doc_offsets), ndocs)
    if not handle:
        raise RuntimeError("tf_build failed")
    try:
        nterms = lib.tf_num_terms(handle)
        nnz = lib.tf_nnz(handle)
        tbytes = lib.tf_term_bytes(handle)
        indptr = np.empty(ndocs + 1, dtype=np.int64)
        term_ids = np.empty(nnz, dtype=np.int32)
        counts = np.empty(nnz, dtype=np.float32)
        doc_lengths = np.empty(ndocs, dtype=np.float32)
        df = np.empty(nterms, dtype=np.int64)
        term_buf = ctypes.create_string_buffer(max(tbytes, 1))
        term_offs = np.empty(nterms + 1, dtype=np.int64)
        lib.tf_copy(
            handle, _i64(indptr), _i32(term_ids), _f32(counts),
            _f32(doc_lengths), _i64(df), term_buf, _i64(term_offs),
        )
    finally:
        lib.tf_free(handle)
    raw = term_buf.raw[:tbytes]
    terms = [
        raw[term_offs[i] : term_offs[i + 1]].decode("ascii")
        for i in range(nterms)
    ]
    return indptr, term_ids, counts, doc_lengths, df, terms


def ascii_tokenize(text: str) -> List[str]:
    """Tokenize ASCII text exactly like ``re.findall(r'\\b\\w+\\b',
    text.lower())``."""
    lib = library()
    data = text.encode("ascii")
    n = len(data)
    out = ctypes.create_string_buffer(max(n, 1))
    max_tokens = n // 2 + 1  # tokens alternate with separators at worst
    starts = np.empty(max_tokens, dtype=np.int64)
    ends = np.empty(max_tokens, dtype=np.int64)
    count = lib.tokenize_ascii(
        data, n, out, _i64(starts), _i64(ends), max_tokens
    )
    lowered = out.raw[:n]
    return [lowered[starts[i] : ends[i]].decode("ascii") for i in range(count)]


class NativeVocab:
    """C++ vocabulary handle for batch query encoding. Terms are given in
    term-id order; queries encode to sorted unique (term id, count) pairs
    with out-of-vocabulary terms dropped."""

    def __init__(self, terms_in_id_order):
        self._lib = library()
        buf = "".join(terms_in_id_order).encode("ascii")
        offs = np.zeros(len(terms_in_id_order) + 1, dtype=np.int64)
        np.cumsum([len(t) for t in terms_in_id_order], out=offs[1:])
        self._handle = self._lib.vocab_build(buf, _i64(offs), len(offs) - 1)
        if not self._handle:
            raise RuntimeError("vocab_build failed")

    def close(self) -> None:
        h, self._handle = getattr(self, "_handle", None), None
        if h:
            self._lib.vocab_free(h)

    def __del__(self):
        self.close()

    def encode_queries(self, texts):
        """Encode a batch of ASCII queries -> flat (tids, counts, ptr)."""
        encoded = [t.encode("ascii") for t in texts]
        buf = b"".join(encoded)
        offs = np.zeros(len(encoded) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=offs[1:])
        cap = sum(len(e) // 2 + 1 for e in encoded)
        tids = np.empty(max(cap, 1), dtype=np.int32)
        counts = np.empty(max(cap, 1), dtype=np.float32)
        ptr = np.zeros(len(encoded) + 1, dtype=np.int64)
        total = self._lib.encode_queries(
            self._handle, buf, _i64(offs), len(encoded),
            _i32(tids), _f32(counts), _i64(ptr), cap,
        )
        if total < 0:
            raise RuntimeError("encode_queries capacity exceeded")
        return tids[:total].copy(), counts[:total].copy(), ptr


def tail_candidates_native(
    post_ptr, post_rows, post_weights, q_tids, q_counts, q_ptr
):
    """Flat tail-candidate scoring (see index/postings.py); rows are
    non-negative int32s, any count of them."""
    lib = library()
    nq = len(q_ptr) - 1
    post_ptr = np.ascontiguousarray(post_ptr, dtype=np.int64)
    post_rows = np.ascontiguousarray(post_rows, dtype=np.int32)
    post_weights = np.ascontiguousarray(post_weights, dtype=np.float32)
    q_tids = np.ascontiguousarray(q_tids, dtype=np.int32)
    q_counts = np.ascontiguousarray(q_counts, dtype=np.float32)
    q_ptr = np.ascontiguousarray(q_ptr, dtype=np.int64)
    cap = (
        int((post_ptr[q_tids + 1] - post_ptr[q_tids]).sum())
        if len(q_tids)
        else 0
    )
    cap = max(cap, 1)
    rows = np.empty(cap, dtype=np.int32)
    cols = np.empty(cap, dtype=np.int32)
    tail = np.empty(cap, dtype=np.float32)
    qptr = np.zeros(nq + 1, dtype=np.int64)
    total = lib.tail_candidates(
        _i64(post_ptr), _i32(post_rows), _f32(post_weights), _i32(q_tids),
        _f32(q_counts), _i64(q_ptr), nq, _i32(rows), _i32(cols),
        _f32(tail), _i64(qptr), cap,
    )
    if total < 0:
        raise RuntimeError("tail_candidates capacity exceeded")
    return rows, cols, tail, qptr, int(total)


_HEAD_KIND = {"int8": 0, "f32": 1, "bf16": 2}


def cand_head_dot_native(
    head, head_dtype, head_scales, rows, cols, total,
    qh_tids, qh_counts, qh_ptr,
):
    """out[m] = head score of candidate m's (row, owning query). A bf16
    head is passed as its uint16 bit patterns."""
    lib = library()
    kind = _HEAD_KIND[head_dtype]
    f = head.shape[1]
    head_c = np.ascontiguousarray(head)
    rows = np.ascontiguousarray(rows[:total], dtype=np.int32)
    cols = np.ascontiguousarray(cols[:total], dtype=np.int32)
    qh_tids = np.ascontiguousarray(qh_tids, dtype=np.int32)
    qh_counts = np.ascontiguousarray(qh_counts, dtype=np.float32)
    qh_ptr = np.ascontiguousarray(qh_ptr, dtype=np.int64)
    if kind == 0 and head_scales is not None and len(qh_tids):
        # Fold the column scales into the query weights and round to bf16,
        # as the device rounds its query operand (ops/head.py).
        qh_counts = bf16_round(
            qh_counts * np.asarray(head_scales, np.float32)[qh_tids]
        )
        kind = 3
    scales = (
        np.ascontiguousarray(head_scales, dtype=np.float32)
        if head_scales is not None
        else np.zeros(1, dtype=np.float32)
    )
    out = np.zeros(max(total, 1), dtype=np.float32)
    lib.cand_head_dot(
        head_c.ctypes.data_as(ctypes.c_void_p), kind, _f32(scales), f,
        _i32(rows), _i32(cols), total, _i32(qh_tids), _f32(qh_counts),
        _i64(qh_ptr), _f32(out),
    )
    return out[:total]


def transpose_i8_native(head: np.ndarray) -> np.ndarray:
    """Blocked (R, F) -> (F, R) int8 transpose copy."""
    lib = library()
    r, f = head.shape
    src = np.ascontiguousarray(head)
    dst = np.empty((f, r), dtype=np.int8)
    p8 = ctypes.POINTER(ctypes.c_int8)
    lib.transpose_i8(src.ctypes.data_as(p8), r, f, dst.ctypes.data_as(p8))
    return dst


def cand_head_dot_t_native(
    head_t, head_scales, rows, c_ptr, total, qh_tids, qh_counts, qh_ptr
):
    """Candidate head scores from the term-major (F, R) int8 head copy;
    bit-identical to :func:`cand_head_dot_native`'s folded int8 path."""
    lib = library()
    f, r = head_t.shape
    rows = np.ascontiguousarray(rows[:total], dtype=np.int32)
    qh_tids = np.ascontiguousarray(qh_tids, dtype=np.int32)
    qh_counts = np.ascontiguousarray(qh_counts, dtype=np.float32)
    qh_ptr = np.ascontiguousarray(qh_ptr, dtype=np.int64)
    nq = len(qh_ptr) - 1
    c_ptr = np.ascontiguousarray(c_ptr, dtype=np.int64)
    if len(c_ptr) > nq + 1:  # batch padding repeats the total
        c_ptr = np.ascontiguousarray(c_ptr[: nq + 1])
    elif len(c_ptr) < nq + 1:
        c_ptr = np.concatenate(
            [c_ptr, np.full(nq + 1 - len(c_ptr), c_ptr[-1], c_ptr.dtype)]
        )
    if head_scales is not None and len(qh_tids):
        qh_counts = bf16_round(
            qh_counts * np.asarray(head_scales, np.float32)[qh_tids]
        )
    out = np.zeros(max(total, 1), dtype=np.float32)
    p8 = ctypes.POINTER(ctypes.c_int8)
    lib.cand_head_dot_t(
        np.ascontiguousarray(head_t).ctypes.data_as(p8), r, _i32(rows),
        _i64(c_ptr), nq, _i32(qh_tids), _f32(qh_counts), _i64(qh_ptr),
        _f32(out),
    )
    return out[:total]


def _pack_hybrid(
    fn_name, head_dtype, indptr, term_ids, tfs, doc_lengths, idf,
    rows, head_terms, vocab_size, method, k1, b, avgdl,
):
    lib = library()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    term_ids = np.ascontiguousarray(term_ids, dtype=np.int32)
    tfs = np.ascontiguousarray(tfs, dtype=np.float32)
    doc_lengths = np.ascontiguousarray(doc_lengths, dtype=np.float32)
    idf = np.ascontiguousarray(idf, dtype=np.float32)
    ndocs = len(indptr) - 1
    f = int(head_terms)
    width = (f + 1) // 2 if head_dtype == np.uint8 else f
    n_tail_terms = max(vocab_size - f, 0)
    tail_cap = int(np.count_nonzero(term_ids >= f)) if term_ids.size else 0
    head = np.empty((rows, width), dtype=head_dtype)
    scales = np.empty(f, dtype=np.float32)
    post_ptr = np.zeros(n_tail_terms + 1, dtype=np.int64)
    post_rows = np.empty(max(tail_cap, 1), dtype=np.int32)
    post_weights = np.empty(max(tail_cap, 1), dtype=np.float32)
    p_head = ctypes.POINTER(
        ctypes.c_uint8 if head_dtype == np.uint8 else ctypes.c_int8
    )
    got = getattr(lib, fn_name)(
        _i64(indptr), ndocs, rows, _i32(term_ids), _f32(tfs),
        _f32(doc_lengths), _f32(idf), f, vocab_size,
        0 if method == "bm25" else 1, float(k1), float(b), float(avgdl),
        head.ctypes.data_as(p_head), _f32(scales), _i64(post_ptr),
        _i32(post_rows), _f32(post_weights), tail_cap,
    )
    if got != tail_cap:
        raise RuntimeError(f"{fn_name} tail mismatch: {got} != {tail_cap}")
    return head, scales, post_ptr, post_rows[:tail_cap], post_weights[:tail_cap]


def pack_hybrid_int8_native(
    indptr, term_ids, tfs, doc_lengths, idf,
    rows, head_terms, vocab_size, method, k1, b, avgdl,
):
    """Fused weight + int8-head + postings pack, bit-identical to
    builder.compute_weights_flat + layout.pack_flat(head_dtype='int8')."""
    return _pack_hybrid(
        "pack_hybrid_int8", np.int8, indptr, term_ids, tfs, doc_lengths,
        idf, rows, head_terms, vocab_size, method, k1, b, avgdl,
    )


def pack_hybrid_int4_native(
    indptr, term_ids, tfs, doc_lengths, idf,
    rows, head_terms, vocab_size, method, k1, b, avgdl,
):
    """The int4 counterpart of :func:`pack_hybrid_int8_native` (unsigned
    nibble codes, signed scales, block packing)."""
    return _pack_hybrid(
        "pack_hybrid_int4", np.uint8, indptr, term_ids, tfs, doc_lengths,
        idf, rows, head_terms, vocab_size, method, k1, b, avgdl,
    )


def merge_topk_native(
    head_s, head_r, c_rows, c_tot, c_ptr, total, k, tau_slack=None
):
    """Exact host merge (see postings.merge_host). ``tau_slack`` is the
    per-query prefilter slack; None disables the prefilter."""
    lib = library()
    b, kh = head_s.shape
    head_s = np.ascontiguousarray(head_s, dtype=np.float32)
    head_r = np.ascontiguousarray(head_r, dtype=np.int32)
    c_rows = np.ascontiguousarray(c_rows[:total], dtype=np.int32)
    c_tot = np.ascontiguousarray(c_tot[:total], dtype=np.float32)
    c_ptr = np.ascontiguousarray(c_ptr, dtype=np.int64)
    if tau_slack is None:
        tau_slack = np.full(b, np.inf, dtype=np.float32)
    else:
        tau_slack = np.ascontiguousarray(tau_slack, dtype=np.float32)
        if tau_slack.shape != (b,):
            raise ValueError(f"tau_slack shape {tau_slack.shape} != ({b},)")
    out_s = np.empty((b, k), dtype=np.float32)
    out_r = np.empty((b, k), dtype=np.int32)
    lib.merge_topk(
        _f32(head_s), _i32(head_r), b, kh, _i32(c_rows), _f32(c_tot),
        _i64(c_ptr), k, _f32(tau_slack), _f32(out_s), _i32(out_r),
    )
    return out_s, out_r


def _u64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def blake2b64(data: bytes) -> int:
    """The runtime's blake2b with an 8-byte digest, as a little-endian
    uint64: ``int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
    "little")``."""
    return int(library().henc_hash(data, len(data)))


class NativeHashingBackend:
    """Native core of :class:`osr_tpu_torch.encoders.HashingEncoder`.

    Documents arrive as '\\0'-joined utf-8 token buffers (tokenization
    stays in Python, so ``re.findall(r"\\b\\w+\\b", text.lower())``'s
    unicode semantics are exact); featurization (unigrams to n-grams),
    blake2b hashing, TF counting, IDF weighting and the scatter-add run in
    C++, threaded over documents. Rows come back unnormalized: the caller
    normalizes them as its NumPy path does. Raises ImportError when the
    runtime cannot be loaded."""

    def __init__(self, dim: int, ngrams: int, use_idf: bool):
        self._lib = library()
        self.dim = int(dim)
        self._h = self._lib.henc_create(
            self.dim, int(ngrams), int(bool(use_idf))
        )
        if not self._h:
            raise ValueError(f"henc_create({dim}, {ngrams}) failed")

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.henc_free(h)

    @staticmethod
    def _doc_array(token_docs):
        n = len(token_docs)
        arr = (ctypes.c_char_p * n)(*token_docs)  # keeps refs for the call
        lens = np.fromiter((len(d) for d in token_docs), np.int64, count=n)
        return arr, lens, n

    def fit(self, token_docs) -> None:
        arr, lens, n = self._doc_array(token_docs)
        self._lib.henc_fit(self._h, arr, _i64(lens), n)

    def encode(self, token_docs) -> np.ndarray:
        """(n_docs, dim) float32, unnormalized."""
        arr, lens, n = self._doc_array(token_docs)
        out = np.zeros((n, self.dim), dtype=np.float32)
        if n:
            self._lib.henc_encode(self._h, arr, _i64(lens), n, _f32(out))
        return out

    def idf(self, feat_hash: int) -> float:
        return float(self._lib.henc_idf(self._h, feat_hash))

    def export_df(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys uint64, vals int32) of the fitted df table, sorted by key
        so the saved file is deterministic."""
        n = int(self._lib.henc_df_size(self._h))
        keys = np.empty(n, dtype=np.uint64)
        vals = np.empty(n, dtype=np.int32)
        if n:
            self._lib.henc_export_df(self._h, _u64(keys), _i32(vals))
            order = np.argsort(keys, kind="stable")
            keys, vals = keys[order], vals[order]
        return keys, vals

    def import_df(self, keys: np.ndarray, vals: np.ndarray, n_docs: int) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        vals = np.ascontiguousarray(vals, dtype=np.int32)
        if keys.shape != vals.shape or keys.ndim != 1:
            raise ValueError(
                f"df keys/vals shape mismatch: {keys.shape} vs {vals.shape}"
            )
        self._lib.henc_import_df(
            self._h, _u64(keys), _i32(vals), len(keys), int(n_docs)
        )
