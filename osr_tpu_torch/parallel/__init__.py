"""Document-sharded, query-parallel search over a ``torch.distributed``
world (counterpart of ``osr_tpu/parallel/``): the (q, d) mesh
(``mesh.py``) and the sharded sparse, dense and hybrid engines
(``sharded.py``).

Exports are lazy, as the package's are: importing
``osr_tpu_torch.parallel`` loads no submodule and starts no process
group.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "make_mesh": "osr_tpu_torch.parallel.mesh",
    "pick_mesh_shape": "osr_tpu_torch.parallel.mesh",
    "ShardedSparseSearchEngine": "osr_tpu_torch.parallel.sharded",
    "ShardedDenseSearchEngine": "osr_tpu_torch.parallel.sharded",
    "ShardedHybridEngine": "osr_tpu_torch.parallel.sharded",
    "sharded_search": "osr_tpu_torch.parallel.sharded",
    "sharded_search_extract": "osr_tpu_torch.parallel.sharded",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'osr_tpu_torch.parallel' has no attribute {name!r}"
        )
    return getattr(importlib.import_module(module), name)
