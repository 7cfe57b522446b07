"""Device operations of the search step: query scatter, head scoring
(plain PyTorch and the CUDA kernels of ``csrc/``), exact top-k and the
selections built on it (block-pruned, extracted per block, and the merge
of row chunks).

Exports are lazy, as the package's are: importing ``osr_tpu_torch.ops``
loads no submodule and builds nothing. No export shares a submodule's
name, so ``from osr_tpu_torch.ops import topk`` is the module.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "approx_topk_threshold": "osr_tpu_torch.ops.topk",
    "block_topk": "osr_tpu_torch.ops.topk",
    "block_topk_from_max": "osr_tpu_torch.ops.topk",
    "blocktopm_topk": "osr_tpu_torch.ops.topk",
    "dense_head_scores": "osr_tpu_torch.ops.bm25",
    "fast_topk": "osr_tpu_torch.ops.topk",
    "fused_search": "osr_tpu_torch.ops.bm25",
    "fused_search_extract": "osr_tpu_torch.ops.bm25",
    "head_scores": "osr_tpu_torch.ops.bm25",
    "masked_head_blocktopm": "osr_tpu_torch.ops.head",
    "merge_chunks": "osr_tpu_torch.ops.bm25",
    "merge_topk": "osr_tpu_torch.ops.topk",
    "scatter_query_head": "osr_tpu_torch.ops.bm25",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'osr_tpu_torch.ops' has no attribute {name!r}"
        )
    return getattr(importlib.import_module(module), name)
