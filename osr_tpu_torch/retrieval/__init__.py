"""Query encoding, the search engines, the retriever registry and the
retrieval service.

Exports are lazy, as the package's are: importing
``osr_tpu_torch.retrieval`` loads no submodule.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "DenseSearchEngine": "osr_tpu_torch.retrieval.engine",
    "RetrievalService": "osr_tpu_torch.retrieval.service",
    "RetrieverRegistry": "osr_tpu_torch.retrieval.registry",
    "SparseSearchEngine": "osr_tpu_torch.retrieval.engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'osr_tpu_torch.retrieval' has no attribute {name!r}"
        )
    return getattr(importlib.import_module(module), name)
