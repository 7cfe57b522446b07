"""Carry a built index across from ``osr_tpu``: its arrays become the
port's :class:`SparseIndex` (or a dense engine's quantized rows)
unchanged, so both packages can serve one index; and carry BERT weights
across (``FlaxBertModel``'s parameters or ``transformers``' state dict
into :class:`osr_tpu_torch.bert.BertModel`). Inputs are plain NumPy
arrays, tensors and scalars, so this module needs neither JAX, nor
``osr_tpu``, nor ``transformers``.

A bf16 head may arrive as ml_dtypes' bfloat16 array (osr_tpu's host
representation) or as uint16 bit patterns; the port keeps the bits.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from osr_tpu_torch.bert import BertConfig, BertModel
from osr_tpu_torch.index.builder import SparseIndex
from osr_tpu_torch.index.layout import HEAD_DTYPES, HybridLayout
from osr_tpu_torch.retrieval.engine import DenseSearchEngine

_HEAD_NP = {"int8": np.int8, "int4": np.uint8, "bf16": np.uint16,
            "f32": np.float32}


def layout_from_arrays(
    *,
    head: np.ndarray,
    head_scales: Optional[np.ndarray],
    post_ptr: np.ndarray,
    post_rows: np.ndarray,
    post_weights: np.ndarray,
    valid: np.ndarray,
    num_docs: int,
    vocab_size: int,
    head_terms: int,
    head_dtype: str,
) -> HybridLayout:
    """A :class:`HybridLayout` from an ``osr_tpu`` layout's arrays."""
    if head_dtype not in HEAD_DTYPES:
        raise ValueError(f"Unknown head_dtype: {head_dtype}")
    head = np.asarray(head)
    if head_dtype == "bf16" and head.dtype != np.uint16:
        if head.dtype.itemsize != 2:
            raise ValueError(f"bf16 head has {head.dtype} entries")
        head = head.view(np.uint16)
    want = _HEAD_NP[head_dtype]
    if head.dtype != want:
        raise ValueError(f"{head_dtype} head must be {np.dtype(want)}")
    width = (head_terms + 1) // 2 if head_dtype == "int4" else head_terms
    if head.ndim != 2 or head.shape[1] != width:
        raise ValueError(
            f"head shape {head.shape} does not fit head_terms={head_terms}"
        )
    if head_dtype in ("int8", "int4"):
        if head_scales is None or np.shape(head_scales) != (head_terms,):
            raise ValueError(f"{head_dtype} head needs ({head_terms},) scales")
        head_scales = np.ascontiguousarray(head_scales, dtype=np.float32)
    else:
        head_scales = None
    valid = np.ascontiguousarray(valid, dtype=bool)
    if valid.shape != (head.shape[0],):
        raise ValueError("valid must have one entry per head row")
    post_ptr = np.ascontiguousarray(post_ptr, dtype=np.int64)
    if post_ptr.shape != (vocab_size - head_terms + 1,):
        raise ValueError("post_ptr must have one entry per tail term + 1")
    return HybridLayout(
        head_terms=int(head_terms),
        head=np.ascontiguousarray(head),
        head_scales=head_scales,
        post_ptr=post_ptr,
        post_rows=np.ascontiguousarray(post_rows, dtype=np.int32),
        post_weights=np.ascontiguousarray(post_weights, dtype=np.float32),
        valid=valid,
        num_docs=int(num_docs),
        vocab_size=int(vocab_size),
        head_dtype=head_dtype,
    )


def index_from_arrays(
    *,
    head: np.ndarray,
    head_scales: Optional[np.ndarray],
    post_ptr: np.ndarray,
    post_rows: np.ndarray,
    post_weights: np.ndarray,
    valid: np.ndarray,
    num_docs: int,
    vocab_size: int,
    head_terms: int,
    head_dtype: str,
    vocabulary: Dict[str, int],
    doc_ids: List[str],
    method: str = "bm25",
    idf: Optional[np.ndarray] = None,
    doc_lengths: Optional[np.ndarray] = None,
    avgdl: float = 0.0,
    k1: float = 1.2,
    b: float = 0.75,
) -> SparseIndex:
    """A searchable :class:`SparseIndex` from an ``osr_tpu`` index's state.
    ``idf``/``doc_lengths``/``avgdl``/``k1``/``b`` are metadata that search
    does not read; they default to empty values."""
    layout = layout_from_arrays(
        head=head, head_scales=head_scales, post_ptr=post_ptr,
        post_rows=post_rows, post_weights=post_weights, valid=valid,
        num_docs=num_docs, vocab_size=vocab_size, head_terms=head_terms,
        head_dtype=head_dtype,
    )
    if len(doc_ids) != num_docs or len(vocabulary) != vocab_size:
        raise ValueError("doc_ids/vocabulary sizes disagree with the layout")
    return SparseIndex(
        method=method,
        vocabulary=dict(vocabulary),
        doc_ids=list(doc_ids),
        layout=layout,
        idf=(
            np.asarray(idf, np.float32)
            if idf is not None
            else np.zeros(vocab_size, np.float32)
        ),
        doc_lengths=(
            np.asarray(doc_lengths, np.float32)
            if doc_lengths is not None
            else np.zeros(num_docs, np.float32)
        ),
        avgdl=float(avgdl),
        k1=float(k1),
        b=float(b),
    )


_DENSE_NP = {"symmetric": np.int8, "int4": np.uint8, "int4_grouped": np.uint8,
             "asymmetric": np.uint8, "none": np.float32}


def dense_engine_from_arrays(
    *,
    doc_ids: Sequence[str],
    docs: np.ndarray,
    scales: Optional[np.ndarray],
    quantization: str,
    mins: Optional[np.ndarray] = None,
    score_chunk_rows: Optional[int] = None,
    device=None,
    backend: str = "auto",
) -> DenseSearchEngine:
    """The port's :class:`DenseSearchEngine` from an ``osr_tpu``
    ``DenseSearchEngine``'s state: its ``_docs``, ``_scales`` and ``_mins``
    (or, for a chunked engine, the real rows of its ``_chunks`` in order,
    with ``score_chunk_rows`` its ``_chunk_rows``), its doc ids and its
    quantization. Rows past ``len(doc_ids)`` are the zero-scale padding of
    ``osr_tpu``'s Pallas backend and are dropped."""
    want = _DENSE_NP.get(quantization)
    if want is None:
        raise ValueError(f"Unknown quantization: {quantization}")
    docs = np.asarray(docs)
    if docs.dtype != want or docs.ndim != 2:
        raise ValueError(
            f"{quantization} rows must be 2-D {np.dtype(want)}, got "
            f"{docs.dtype} {docs.shape}"
        )
    n = len(doc_ids)
    if docs.shape[0] < n:
        raise ValueError(f"{docs.shape[0]} rows for {n} doc ids")
    if (scales is None) != (quantization == "none"):
        raise ValueError(f"{quantization} rows need scales (and 'none' none)")
    if (mins is None) != (quantization != "asymmetric"):
        raise ValueError("asymmetric rows need mins (and only they)")

    def rows(a):
        if a is None:
            return None
        a = np.asarray(a, dtype=np.float32)
        if a.shape[0] < n:
            raise ValueError(f"{a.shape[0]} scales or mins for {n} rows")
        return torch.from_numpy(np.ascontiguousarray(a[:n]))

    dim = docs.shape[1] * (2 if quantization.startswith("int4") else 1)
    return DenseSearchEngine._from_state(
        doc_ids, torch.from_numpy(np.ascontiguousarray(docs[:n])),
        rows(scales), rows(mins), quantization, dim,
        device=device, backend=backend, score_chunk_rows=score_chunk_rows,
    )


# Flax leaf names -> nn.Module parameter names (a Dense kernel is (in, out),
# nn.Linear's weight (out, in)).
_FLAX_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
                "bias": "bias"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def bert_from_torch_state_dict(
    config: Mapping, state_dict: Mapping[str, Any]
) -> BertModel:
    """This package's :class:`BertModel` from ``transformers``' BERT
    config dict and state dict (a ``bert.`` prefix is dropped; the pooler
    and the position-id buffers are not used)."""
    model = BertModel(BertConfig.from_dict(config))
    own = model.state_dict()
    tensors = {}
    for name, value in state_dict.items():
        name = name.removeprefix("bert.")
        if name in own:
            tensors[name] = (
                value if isinstance(value, torch.Tensor)
                else torch.from_numpy(np.array(value))
            )
    model.load_state_dict(tensors, strict=True)
    return model


def bert_from_flax_params(config: Mapping, params: Mapping) -> BertModel:
    """This package's :class:`BertModel` from ``FlaxBertModel.params`` (a
    nested mapping of arrays; convert with ``jax.device_get`` or
    ``np.asarray`` first) and its config dict. Each Dense ``kernel`` is
    transposed; LayerNorm ``scale`` and Embed ``embedding`` become
    ``weight``; the pooler is not used."""
    state = {}
    for name, value in _flatten(params).items():
        if name.startswith("pooler."):
            continue
        path, leaf = name.rsplit(".", 1)
        value = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            value = value.T
        state[f"{path}.{_FLAX_LEAVES[leaf]}"] = value
    return bert_from_torch_state_dict(config, state)
