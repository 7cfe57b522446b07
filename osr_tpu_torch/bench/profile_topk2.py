"""Exact top-k variants over a seeded score matrix on the CUDA card, with
their full outputs kept (counterpart of ``tools/profile_topk2.py``).

A (``--batch``, ``--rows``) f32 matrix of NumPy ``default_rng(0)``
normals x 5 + 3 (the script's 6,656 x 57,640: 1.53 GB) on the card.
Each variant keeps its whole (B, k) output, is run once to warm, then 4
times enqueued with one synchronize after the last; milliseconds a call,
under the script's labels:

- ``top_k f32 full output``: the exact top-k (``ops/topk.py:topk``, the
  select kernel on the card; ties to the lower column, as ``lax.top_k``);
- ``top_k int32-bitcast``: the same over the scores' bits as int32,
  mapped so that signed integer order is float order (b >= 0 ? b :
  b ^ 0x7fffffff), and mapped back; ``int_trick_exact`` says whether its
  values equal the f32 top-k's (the mode exits 1 unless they do);
- ``top_k bf16 (2k out)``: the top 2k of a bf16 copy (not exact; the
  first stage of a coarse-then-rerank selection).

Dropped, null keys named in ``dropped``: ``approx_max_k recall=1.0`` and
``recall=0.95`` (``lax.approx_max_k`` has no CUDA counterpart). On the
card only the select kernel runs (``kernel_launches`` holds
``topk_select`` alone); ``device`` as every mode.

Usage: python -m osr_tpu_torch.bench profile-topk2 [--batch 6656]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from osr_tpu_torch.bench.common import (
    device_name,
    enqueued_ms,
    fetch,
    launched,
    log,
    no_card,
    reset_all_launches,
    rounded,
    sync,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "topk_variant_ms"
BATCH, ROWS, TOP_K = 6656, 57_640, 50  # the script's B, R, K
LABELS = {
    "top_k_f32_full_output_ms": "top_k f32 full output",
    "approx_max_k_recall_1_ms": "approx_max_k recall=1.0",
    "approx_max_k_recall_0_95_ms": "approx_max_k recall=0.95",
    "top_k_int32_bitcast_ms": "top_k int32-bitcast",
    "top_k_bf16_2k_out_ms": "top_k bf16 (2k out)",
}
_NO_APPROX = ("lax.approx_max_k has no CUDA counterpart; the port's "
              "topk_mode='approx' is the exact selection")
DROPPED = {"approx_max_k_recall_1_ms": _NO_APPROX,
           "approx_max_k_recall_0_95_ms": _NO_APPROX}
KEYS = ("metric", "batch", "rows", "top_k", *LABELS, "int_trick_exact",
        "dropped", "kernel_launches", "device")


def _order_bits(b: torch.Tensor) -> torch.Tensor:
    """IEEE float bits (as int32) to integers whose signed order is the
    floats' order, and back (the map is its own inverse)."""
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF)


def int_bitcast_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """The exact top-k of f32 ``x`` selected on ordered int32 bits:
    (values, int32 columns)."""
    from osr_tpu_torch.ops.topk import topk

    s, r = topk(_order_bits(x.view(torch.int32)), k=k)
    return _order_bits(s).view(torch.float32), r


def run(
    *,
    batch: int = BATCH,
    rows: int = ROWS,
    topk: int = TOP_K,
    device=None,
) -> Tuple[Dict[str, object], Dict[str, np.ndarray]]:
    """The row, and the matrix and the exact selections on the host. The
    tests pass ``device="cpu"`` and small sizes."""
    from osr_tpu_torch.ops.topk import topk as exact_topk

    dev = resolve_device(device)
    b, r, k = batch, rows, topk
    log(f"device: {device_name(dev)} B={b} R={r}")
    rng = np.random.default_rng(0)
    hs_np = rng.standard_normal((b, r), dtype=np.float32) * 5.0 + 3.0
    hs = torch.from_numpy(hs_np).to(dev)
    sync(dev)
    reset_all_launches()

    ms: Dict[str, Optional[float]] = dict.fromkeys(LABELS)
    ms["top_k_f32_full_output_ms"] = enqueued_ms(
        lambda: exact_topk(hs, k=k), dev)
    ms["top_k_int32_bitcast_ms"] = enqueued_ms(
        lambda: int_bitcast_topk(hs, k), dev)
    ms["top_k_bf16_2k_out_ms"] = enqueued_ms(
        lambda: exact_topk(hs.to(torch.bfloat16), k=2 * k), dev)
    launches = launched()
    for key, label in LABELS.items():
        v = ms[key]
        log(f"{label}: " + ("dropped" if v is None else f"{v:9.4f} ms"))
    a_s, a_r = fetch(exact_topk(hs, k=k))
    i_s, i_r = fetch(int_bitcast_topk(hs, k))
    exact = bool(np.array_equal(a_s, i_s))
    log(f"int trick exact: {exact}")
    row = {
        "metric": METRIC,
        "batch": b,
        "rows": r,
        "top_k": k,
        **{key: rounded(v) for key, v in ms.items()},
        "int_trick_exact": exact,
        "dropped": DROPPED,
        "kernel_launches": launches,
        "device": device_name(dev),
    }
    return row, {"scores": hs_np, "f32_top": a_s, "f32_rows": a_r,
                 "int_top": i_s, "int_rows": i_r}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench profile-topk2",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--topk", type=int, default=TOP_K)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    row, _ = run(batch=args.batch, rows=args.rows, topk=args.topk)
    print(json.dumps(row), flush=True)
    return 0 if row["int_trick_exact"] else 1
