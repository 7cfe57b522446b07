"""The (q, d) device mesh over a ``torch.distributed`` world (counterpart
of ``osr_tpu/parallel/mesh.py``).

Two axes:

- ``q``: query-batch data parallelism (each rank scores a slice of every
  batch; the merged results are gathered over ``q`` at the end);
- ``d``: document sharding (each rank holds one row shard of the index;
  per-shard top-k lists are merged with one all-gather over ``d``).

``osr_tpu`` is one program that drives every chip; here every rank runs
the same program on its own shard (SPMD). The caller initializes the
default process group (``torchrun`` does, from its environment), as for
any ``torch.distributed`` program; :func:`make_mesh` lays the world out
row-major, so rank r sits at (r // n_d, r % n_d), as ``osr_tpu``'s
``np.asarray(devices).reshape(n_q, n_d)`` lays out its devices.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

QUERY_AXIS = "q"
DOC_AXIS = "d"


def pick_mesh_shape(
    n_devices: int, query_parallel: Optional[int] = None
) -> Tuple[int, int]:
    """Choose (n_q, n_d) for ``n_devices``.

    Document sharding is the capacity axis (it divides the device memory
    the index takes), so by default every device goes to ``d``; callers opt
    into query parallelism when query volume, not index size, is the
    bottleneck."""
    if query_parallel is None:
        return (1, n_devices)
    if n_devices % query_parallel:
        raise ValueError(
            f"query_parallel={query_parallel} must divide n_devices={n_devices}"
        )
    return (query_parallel, n_devices // query_parallel)


def make_mesh(
    n_devices: Optional[int] = None,
    query_parallel: Optional[int] = None,
    device_type: str = "cuda",
):
    """A ``DeviceMesh`` of shape (n_q, n_d), dimensions named ("q", "d"),
    over the default process group, which the caller has initialized.

    ``n_devices`` (None: the world size) must equal the world size. On
    ``cuda`` each rank first selects its card, ``LOCAL_RANK`` (else its
    rank) modulo the cards it sees."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group first (torchrun sets its "
            "address, rank and world size)"
        )
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(
            f"n_devices={n_devices} but the process group has {world} ranks"
        )
    n_q, n_d = pick_mesh_shape(n_devices, query_parallel)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device_type='cpu'")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    layout = torch.arange(world, dtype=torch.int64).reshape(n_q, n_d)
    return DeviceMesh(
        device_type, layout, mesh_dim_names=(QUERY_AXIS, DOC_AXIS)
    )
