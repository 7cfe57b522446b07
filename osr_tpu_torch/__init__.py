"""osr_tpu_torch — the PyTorch + CUDA port of ``osr_tpu`` for NVIDIA Hopper.

Batched, exact top-k BM25/TF-IDF search over the hybrid dense-head /
postings-tail index, with the head scored on the GPU by hand-written CUDA
kernels (``csrc/``) and the postings tail and exact merge on the host
(``index/postings.py`` and the shared C++ runtime in ``native/``); and
quantized dense retrieval (``DenseSearchEngine``), whose query
quantization and int8/int4 similarity are hand-written CUDA kernels too.
Above the engines: the config-driven ``RetrieverRegistry`` (sparse, dense,
learned-sparse and hybrid retrievers, weighted or RRF fusion), the
``HashingEncoder``, the index cache, the ``DocumentStore`` and the
``RetrievalService`` facade; the neural ``HFEncoder`` over this package's
own BERT (``bert.py``); and the experiment pipeline above them all
(``load_config`` -> ``run_all_experiments``: registry, engine,
``ReaderRegistry`` reader, IR metrics, summary files), also reached through
``python -m osr_tpu_torch run --config ...``.

Module names follow ``osr_tpu`` so each part has an obvious counterpart.
This package imports neither JAX nor ``osr_tpu``. Exports are lazy: ``import
osr_tpu_torch`` loads no submodule, builds nothing and touches no device.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "DenseSearchEngine": "osr_tpu_torch.retrieval.engine",
    "Document": "osr_tpu_torch.storage.documents",
    "DocumentStore": "osr_tpu_torch.storage.doc_store",
    "HFEncoder": "osr_tpu_torch.encoders",
    "HashingEncoder": "osr_tpu_torch.encoders",
    "HybridRetriever": "osr_tpu_torch.retrieval.registry",
    "ReaderRegistry": "osr_tpu_torch.readers.registry",
    "RetrievalService": "osr_tpu_torch.retrieval.service",
    "RetrieverRegistry": "osr_tpu_torch.retrieval.registry",
    "SparseIndex": "osr_tpu_torch.index.builder",
    "SparseIndexBuilder": "osr_tpu_torch.index.builder",
    "SparseSearchEngine": "osr_tpu_torch.retrieval.engine",
    "SyntheticDataGenerator": "osr_tpu_torch.testing",
    "Tokenizer": "osr_tpu_torch.index.tokenizer",
    "dense_engine_from_arrays": "osr_tpu_torch.convert",
    "index_from_arrays": "osr_tpu_torch.convert",
    "layout_from_arrays": "osr_tpu_torch.convert",
    "load_config": "osr_tpu_torch.pipeline.config",
    "run_all_experiments": "osr_tpu_torch.pipeline.experiment",
    "tokenize": "osr_tpu_torch.index.tokenizer",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'osr_tpu_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)
