"""The exact block-pruned top-k against the plain one, over a seeded score
matrix on the CUDA card (counterpart of ``tools/profile_blocksel.py``).

A (``--batch``, ``--rows`` rounded up to 128) f32 matrix of NumPy
``default_rng(0)`` normals x 5, -inf past ``--rows`` (the script's B,
R = 6,656, 57,640: 1.53 GB), on the card. The block-pruned selection of
the script: each 128-column block's maximum, the top ``--w`` blocks by
it (W >= k keeps it exact up to score ties), the gather of those blocks
and the top ``--topk`` of their W x 128 candidates, with the port's
stable sorts (``ops/topk.py:topk``), so ties go to the lower block rank,
then lane, as ``lax.top_k`` orders them. Each is run once to warm, then
4 times enqueued with one synchronize after the last; milliseconds a
call, under the script's labels: ``block-pruned exact top-k``, ``plain
top_k`` (the exact top-k of the whole matrix), ``block max reduce``.
Then the script's check between the two selections, and the mode exits
1 unless both hold: ``scores_equal``, the same scores in the same
places, and ``rows_equal``, the same rows up to the order of tied scores
(``common.equal_up_to_ties``): the plain top-k orders equal scores by
row, the block-pruned one by block rank, and at the script's shape 9 of
the 6,656 rows hold a tie in their top 50, where a strict comparison of
rows, the script's, fails. On the card only the select kernel runs
(``kernel_launches`` holds ``topk_select`` alone); ``device`` as every
mode.

Usage: python -m osr_tpu_torch.bench profile-blocksel [--batch 6656]
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
    equal_up_to_ties,
    fetch,
    launched,
    log,
    no_card,
    reset_all_launches,
    rounded,
    sync,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "block_pruned_topk_ms"
# The script's B, R, K, W (tools/profile_blocksel.py:35).
BATCH, ROWS, TOP_K, W = 6656, 57_640, 50, 64
KEYS = (
    "metric", "batch", "rows", "blocks", "top_k", "w",
    "block_pruned_exact_top_k_ms", "plain_top_k_ms", "block_max_reduce_ms",
    "scores_equal", "rows_equal", "kernel_launches", "device",
)


def blocksel(x: torch.Tensor, k: int, w: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """The script's block-pruned exact top-k of a (B, T x 128) matrix:
    (values, int32 rows)."""
    from osr_tpu_torch.ops.topk import topk

    b, rp = x.shape
    xr = x.reshape(b, rp // 128, 128)
    _, bi = topk(xr.amax(dim=2), k=w)
    cand = torch.gather(xr, 1, bi.long()[:, :, None].expand(-1, -1, 128))
    s, li = topk(cand.reshape(b, -1), k=k)
    li = li.long()
    blk = torch.gather(bi.long(), 1, li // 128)
    return s, (blk * 128 + li % 128).int()


def run(
    *,
    batch: int = BATCH,
    rows: int = ROWS,
    topk: int = TOP_K,
    w: int = W,
    device=None,
) -> Tuple[Dict[str, object], Dict[str, np.ndarray]]:
    """The row, and the matrix and both selections on the host. The tests
    pass ``device="cpu"`` and small sizes."""
    from osr_tpu_torch.ops.topk import topk as exact_topk

    dev = resolve_device(device)
    b, r, k = batch, rows, topk
    t = -(-r // 128)
    log(f"device: {device_name(dev)} B={b} R={r} T={t} W={w}")
    rng = np.random.default_rng(0)
    hs_np = rng.standard_normal((b, t * 128), dtype=np.float32) * 5.0
    hs_np[:, r:] = -np.inf
    hs = torch.from_numpy(hs_np).to(dev)
    sync(dev)
    reset_all_launches()

    ms = {
        "block_pruned_exact_top_k_ms": enqueued_ms(
            lambda: blocksel(hs, k, w), dev),
        "plain_top_k_ms": enqueued_ms(lambda: exact_topk(hs, k=k), dev),
        "block_max_reduce_ms": enqueued_ms(
            lambda: hs.reshape(b, t, 128).amax(dim=2).sum(), dev),
    }
    launches = launched()
    log(f"block-pruned exact top-k: "
        f"{ms['block_pruned_exact_top_k_ms']:9.4f} ms")
    log(f"plain top_k: {ms['plain_top_k_ms']:9.4f} ms")
    log(f"block max reduce: {ms['block_max_reduce_ms']:9.4f} ms")
    a_s, a_r = fetch(exact_topk(hs, k=k))
    b_s, b_r = fetch(blocksel(hs, k, w))
    row = {
        "metric": METRIC,
        "batch": b,
        "rows": r,
        "blocks": t,
        "top_k": k,
        "w": w,
        **{key: rounded(v) for key, v in ms.items()},
        "scores_equal": bool(np.array_equal(a_s, b_s)),
        "rows_equal": equal_up_to_ties(a_s, a_r, b_s, b_r),
        "kernel_launches": launches,
        "device": device_name(dev),
    }
    log(f"scores equal: {row['scores_equal']} rows equal: "
        f"{row['rows_equal']}")
    return row, {"scores": hs_np, "plain_top": a_s, "plain_rows": a_r,
                 "block_top": b_s, "block_rows": b_r}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench profile-blocksel",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--topk", type=int, default=TOP_K)
    ap.add_argument("--w", type=int, default=W)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    row, _ = run(batch=args.batch, rows=args.rows, topk=args.topk, w=args.w)
    print(json.dumps(row), flush=True)
    return 0 if row["scores_equal"] and row["rows_equal"] else 1
