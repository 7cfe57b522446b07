"""On-disk index cache (counterpart of ``osr_tpu/index/cache.py``).

The file format, its versions (v3 zlib, v4 zstd) and the file name are
``osr_tpu``'s, so a cache written by either package loads in the other:
the registries of both default to the same ``.rag_cache`` directory. A
bf16 head travels as its raw bytes either way (``osr_tpu`` holds bfloat16
values, this package their uint16 bit patterns).

The analogue of the reference's ``.rag_cache/{method}_index_{hash}.npz``
checkpointing (reference evaluate_rag_pipeline.py:189-201,280-312), extended
with a fast-load path: both representations are stored —

- the raw term matrix (flat term ids / tfs / indptr), which survives changes
  to BM25 parameters and layout heuristics (re-weight + re-pack on load), and
- the packed device layout (quantized head + postings), loaded directly —
  no re-tokenization, no re-packing — when the builder parameters match the
  ones the cache was written with.

Everything loads with ``allow_pickle=False``: strings (vocabulary, doc ids)
are stored as JSON-encoded scalars, and the head matrix as raw bytes plus a
dtype tag — a tampered cache file cannot execute code on load.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Mapping, Union

import numpy as np

from osr_tpu_torch.index.builder import (
    SparseIndex,
    SparseIndexBuilder,
    corpus_fingerprint,
)
from osr_tpu_torch.index.layout import HybridLayout

logger = logging.getLogger(__name__)

_FORMAT_VERSION = 3  # zlib container (np.savez_compressed)
_FORMAT_VERSION_ZSTD = 4  # uncompressed container + zstd-1 per big array

# Per-array zstd-1 instead of the npz container's zlib-6: at FiQA scale
# the zlib save cost 7.6 s — 6x a full index REBUILD — while zstd-1
# compresses the same bytes ~20x faster at essentially the same ratio
# (the int8 head dominates and barely compresses beyond its zero runs).
# At 1M+ docs (multi-GB heads, 70-340 s builds) this is what makes the
# cache actually cheaper than rebuilding.
_ZSTD_MIN_BYTES = 1 << 20

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - environment dependent
    _zstd = None

_HEAD_NP_DTYPE = {
    "int8": np.int8, "int4": np.uint8, "bf16": np.uint16, "f32": np.float32,
}


def cache_path(
    cache_dir: Union[str, Path], method: str, fingerprint: str
) -> Path:
    return Path(cache_dir) / f"{method}_index_{fingerprint}.npz"


def _builder_params(builder: SparseIndexBuilder) -> str:
    return json.dumps(
        {
            "method": builder.method,
            "k1": builder.k1,
            "b": builder.b,
            "head_terms": builder.head_terms,
            "head_budget_bytes": builder.head_budget_bytes,
            "head_cap": builder.head_cap,
            "head_dtype": builder.head_dtype,
        },
        sort_keys=True,
    )


def save_index(
    index: SparseIndex, path: Union[str, Path], builder: SparseIndexBuilder
) -> None:
    if index.raw_indptr is None:
        raise ValueError(
            "Index was built without keep_raw_rows=True; cannot cache"
        )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    layout = index.layout
    head_scales = (
        layout.head_scales
        if layout.head_scales is not None
        else np.zeros(0, np.float32)
    )
    arrays = dict(
        builder_params=_builder_params(builder),
        method=index.method,
        k1=index.k1,
        b=index.b,
        avgdl=index.avgdl,
        idf=index.idf,
        doc_lengths=index.doc_lengths,
        df=np.zeros(0, np.int64),  # reserved
        vocabulary_json=json.dumps(list(index.vocabulary.keys())),
        doc_ids_json=json.dumps(index.doc_ids),
        indptr=index.raw_indptr,
        term_ids=index.raw_term_ids,
        tfs=index.raw_tfs,
        head_terms=layout.head_terms,
        head_dtype=layout.head_dtype,
        packed_head=np.frombuffer(
            np.ascontiguousarray(layout.head).tobytes(), dtype=np.uint8
        ),
        packed_head_rows=layout.head.shape[0],
        packed_scales=head_scales,
        packed_post_ptr=layout.post_ptr,
        packed_post_rows=layout.post_rows,
        packed_post_weights=layout.post_weights,
        packed_valid=layout.valid,
    )
    if _zstd is None:  # pragma: no cover - environment dependent
        np.savez_compressed(path, format_version=_FORMAT_VERSION, **arrays)
    else:
        c = _zstd.ZstdCompressor(level=1)
        packed = {}
        for k, v in arrays.items():
            # JSON strings become utf-8 buffers so they compress too
            # (np.savez would store str scalars 4 bytes/char, raw).
            if k.endswith("_json"):
                v = np.frombuffer(v.encode("utf-8"), dtype=np.uint8)
            a = np.asarray(v)
            if a.dtype.kind in "iuf" and a.nbytes >= _ZSTD_MIN_BYTES:
                blob = c.compress(np.ascontiguousarray(a).tobytes())
                packed[f"zst_{k}"] = np.frombuffer(blob, dtype=np.uint8)
                packed[f"zstmeta_{k}"] = json.dumps(
                    {"dtype": a.dtype.str, "shape": list(a.shape)}
                )
            else:
                packed[k] = v
        np.savez(path, format_version=_FORMAT_VERSION_ZSTD, **packed)
    logger.info("Index cached to %s", path)


class _CacheReader:
    """Npz accessor that transparently restores zstd-packed (v4) arrays
    and utf-8-buffered JSON strings; v3 files pass straight through."""

    def __init__(self, z, version: int):
        self._z = z
        self._version = version

    def __getitem__(self, key: str):
        z = self._z
        if key in z.files:
            v = z[key]
            if (
                self._version >= _FORMAT_VERSION_ZSTD
                and key.endswith("_json")
                and v.dtype == np.uint8
            ):
                return v.tobytes().decode("utf-8")
            return v
        zk = f"zst_{key}"
        if zk in z.files:
            if _zstd is None:  # pragma: no cover - environment dependent
                raise ValueError(
                    "index cache is zstd-packed (v4) but the zstandard "
                    "module is unavailable; rebuild the index or install "
                    "zstandard"
                )
            meta = json.loads(str(z[f"zstmeta_{key}"]))
            raw = _zstd.ZstdDecompressor().decompress(
                z[zk].tobytes(),
                max_output_size=int(
                    np.dtype(meta["dtype"]).itemsize
                    * max(1, int(np.prod(meta["shape"])))
                ),
            )
            arr = np.frombuffer(raw, dtype=np.dtype(meta["dtype"]))
            arr = arr.reshape(meta["shape"])
            if key.endswith("_json"):
                return arr.tobytes().decode("utf-8")
            return arr
        raise KeyError(key)


def _load_packed_layout(z, num_docs: int, vocab_size: int) -> HybridLayout:
    head_terms = int(z["head_terms"])
    head_dtype = str(z["head_dtype"])
    rows = int(z["packed_head_rows"])
    dt = _HEAD_NP_DTYPE[head_dtype]
    head = np.frombuffer(z["packed_head"].tobytes(), dtype=dt)
    # int4 stores two elements per byte, so the stored width is the
    # PACKED width, not head_terms — recover it from the element count.
    head = head.reshape(rows, -1) if head.size else head.reshape(rows, 0)
    scales = z["packed_scales"]
    return HybridLayout(
        head_terms=head_terms,
        head=head,
        head_scales=scales if scales.size else None,
        post_ptr=z["packed_post_ptr"],
        post_rows=z["packed_post_rows"],
        post_weights=z["packed_post_weights"],
        valid=z["packed_valid"],
        num_docs=num_docs,
        vocab_size=vocab_size,
        head_dtype=head_dtype,
    )


def load_index(
    path: Union[str, Path], builder: SparseIndexBuilder
) -> SparseIndex:
    t0 = time.perf_counter()
    with np.load(path, allow_pickle=False) as znpz:
        version = int(znpz["format_version"])
        if version not in (_FORMAT_VERSION, _FORMAT_VERSION_ZSTD):
            raise ValueError("Incompatible index cache version")
        z = _CacheReader(znpz, version)
        if str(z["method"]) != builder.method:
            # The stored idf belongs to the stored method's formula; silently
            # re-weighting with it under another method would be wrong.
            raise ValueError(
                f"Cache holds a {z['method']} index; builder wants "
                f"{builder.method}"
            )
        vocabulary = {
            t: i for i, t in enumerate(json.loads(str(z["vocabulary_json"])))
        }
        doc_ids = [str(d) for d in json.loads(str(z["doc_ids_json"]))]
        idf = z["idf"]
        doc_lengths = z["doc_lengths"]
        avgdl = float(z["avgdl"])
        params_match = str(z["builder_params"]) == _builder_params(builder)

        indptr = z["indptr"]
        flat_tids = z["term_ids"]
        flat_tfs = z["tfs"]

        if params_match:
            layout = _load_packed_layout(z, len(doc_ids), len(vocabulary))
            index = SparseIndex(
                method=builder.method,
                vocabulary=vocabulary,
                doc_ids=doc_ids,
                layout=layout,
                idf=idf,
                doc_lengths=doc_lengths,
                avgdl=avgdl,
                k1=builder.k1,
                b=builder.b,
                raw_indptr=indptr if builder.keep_raw_rows else None,
                raw_term_ids=flat_tids if builder.keep_raw_rows else None,
                raw_tfs=flat_tfs if builder.keep_raw_rows else None,
            )
            how = "packed"
        else:
            # Re-weight + re-pack under the new builder parameters; df is
            # recoverable from the stored IDF-free term matrix by counting.
            df = np.bincount(
                flat_tids, minlength=len(vocabulary)
            ).astype(np.int64)
            keep = builder.keep_raw_rows
            builder.keep_raw_rows = True
            try:
                index = builder.build_from_term_matrix(
                    vocabulary,
                    df,
                    doc_lengths,
                    indptr,
                    flat_tids,
                    flat_tfs,
                    doc_ids,
                )
            finally:
                builder.keep_raw_rows = keep
            if not keep:
                index.raw_indptr = None
                index.raw_term_ids = None
                index.raw_tfs = None
            how = "re-packed"

    logger.info(
        "Loaded cached index (%d docs, %s) in %.2fs",
        len(doc_ids),
        how,
        time.perf_counter() - t0,
    )
    return index


def load_or_build(
    builder: SparseIndexBuilder,
    corpus: Mapping[str, object],
    cache_dir: Union[str, Path] = ".rag_cache",
) -> SparseIndex:
    """Probe the cache; on miss, build and store (reference
    evaluate_rag_pipeline.py:181-208 flow)."""
    fp = corpus_fingerprint(corpus)
    path = cache_path(cache_dir, builder.method, fp)
    if path.exists():
        try:
            return load_index(path, builder)
        except Exception as e:  # corrupt/stale cache -> rebuild
            logger.warning("Index cache load failed (%s); rebuilding", e)
    keep = builder.keep_raw_rows
    builder.keep_raw_rows = True
    try:
        index = builder.build(corpus)
        try:
            save_index(index, path, builder)
        except Exception as e:
            logger.warning("Failed to cache index: %s", e)
    finally:
        builder.keep_raw_rows = keep
    if not keep:
        index.raw_indptr = None
        index.raw_term_ids = None
        index.raw_tfs = None
    return index
