"""Host index stack: tokenizer, hybrid layout, builder and postings tail.

Exports are lazy, as the package's are: importing ``osr_tpu_torch.index``
loads no submodule.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "HybridLayout": "osr_tpu_torch.index.layout",
    "SparseIndex": "osr_tpu_torch.index.builder",
    "SparseIndexBuilder": "osr_tpu_torch.index.builder",
    "Tokenizer": "osr_tpu_torch.index.tokenizer",
    "choose_head_terms": "osr_tpu_torch.index.layout",
    "dense_tail_scores": "osr_tpu_torch.index.postings",
    "merge_host": "osr_tpu_torch.index.postings",
    "pack_flat": "osr_tpu_torch.index.layout",
    "tail_candidates_flat": "osr_tpu_torch.index.postings",
    "tokenize": "osr_tpu_torch.index.tokenizer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'osr_tpu_torch.index' has no attribute {name!r}"
        )
    return getattr(importlib.import_module(module), name)
