"""The exact device step's stages on the CUDA card: K2 with its block
maxima, the block top-W, the block gather, the final top-k
(counterpart of ``tools/profile_fused.py``).

A seeded int8 head of ``--docs`` rows rounded up to 128 (NumPy
``RandomState(0)``: codes in [-127, 127]) by ``--f`` columns, unit
column scales, every row valid, and ``--batch`` queries rounded up to
128, each with 11 head terms of weight in [0, 4) rounded to bf16, as the
script draws them. Each stage is cumulative, as in the script, and is run
once to warm, then ``--reps`` times enqueued with one synchronize after
the last; milliseconds a call, under the script's labels:

- ``A matmul+blockmax (scores written)``: K2
  (``ops/head.py:masked_head_scores_blockmax``): the (B, R) scores and the
  (B, R/128) block maxima;
- ``B + topk(bmax)``: the top-k blocks by their maxima;
- ``C + block gather``: the k blocks' 128 scores each;
- ``D + final topk (current path)``: the top-k of those candidates
  (``ops/topk.py:block_topk_from_max``, the selection the engine runs);
- ``E matmul + plain lax.top_k``: K2, then the exact top-k of the whole
  matrix (the port's stable sort).

The row adds two checks, and the mode exits 1 unless both hold: stage D's
(scores, rows) equal the engine's device-step function
(``ops/bm25.py:fused_search``: scatter, K2, the block-pruned selection)
on the same queries bit for bit, and stage E's equal it up to the order
of tied scores (``common.equal_up_to_ties``: a plain top-k orders ties by
row, the block-pruned one by block rank). ``kernel_launches`` (K2) and
``device`` as every mode.

Usage: python -m osr_tpu_torch.bench profile-fused [--batch 6656]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from osr_tpu_torch.bench.common import (
    NUM_DOCS,
    TOP_K,
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

METRIC = "fused_step_stage_ms"
BLOCK = 128  # the script's TILE_R_BM and BLOCK_COLS
QUERY_TERMS = 11
STAGES = {
    "a_matmul_blockmax_ms": "A matmul+blockmax (scores written)",
    "b_topk_bmax_ms": "B + topk(bmax)",
    "c_block_gather_ms": "C + block gather",
    "d_final_topk_ms": "D + final topk (current path)",
    "e_matmul_plain_top_k_ms": "E matmul + plain lax.top_k",
}
KEYS = (
    "metric", "rows", "head_terms", "batch", "top_k", "reps", *STAGES,
    "stage_d_equals_device_step", "stage_e_equals_device_step",
    "kernel_launches", "device",
)


def run(
    *,
    docs: int = NUM_DOCS,
    batch: int = 6656,
    topk: int = TOP_K,
    f: int = 2048,
    reps: int = 4,
    device=None,
) -> Tuple[Dict[str, object], Dict[str, np.ndarray]]:
    """The row, and on the host stages D's and E's outputs, the device
    step's and the inputs (head, query ids and weights). The tests pass
    ``device="cpu"`` and small sizes."""
    from osr_tpu_torch.ops.bm25 import fused_search, scatter_query_head
    from osr_tpu_torch.ops.head import masked_head_scores_blockmax
    from osr_tpu_torch.ops.topk import topk as exact_topk

    dev = resolve_device(device)
    log(f"device: {device_name(dev)}")
    rng = np.random.RandomState(0)
    r = -(-docs // BLOCK) * BLOCK
    b = -(-batch // 128) * 128
    k = topk
    g = r // BLOCK
    head_np = rng.randint(-127, 128, size=(r, f), dtype=np.int8)
    head = torch.from_numpy(head_np).to(dev)
    ids_np = np.zeros((b, QUERY_TERMS), dtype=np.int32)
    w_np = np.zeros((b, QUERY_TERMS), dtype=np.float32)
    for i in range(b):
        ids_np[i] = rng.choice(f, size=QUERY_TERMS, replace=False)
        w_np[i] = rng.rand(QUERY_TERMS) * 4
    w_np = torch.from_numpy(w_np).to(torch.bfloat16).float().numpy()
    ids, w = torch.from_numpy(ids_np).to(dev), torch.from_numpy(w_np).to(dev)
    scales = torch.ones(f, dtype=torch.float32, device=dev)
    valid = torch.ones(r, dtype=torch.bool, device=dev)
    q = scatter_query_head(ids, w, head_terms=f)
    lanes = torch.arange(BLOCK, device=dev)
    nb = min(k, g)
    sync(dev)
    reset_all_launches()

    def stage_a():
        return masked_head_scores_blockmax(head, scales, q, valid)

    def stage_b():
        hs, bmax = stage_a()
        return hs, exact_topk(bmax, k=nb)[1]

    def stage_c():
        hs, top_blocks = stage_b()
        cols = (top_blocks.long()[:, :, None] * BLOCK + lanes).reshape(b, -1)
        return torch.gather(hs, 1, cols), cols

    def stage_d():
        cand, cols = stage_c()
        vals, pos = exact_topk(cand, k=k)
        return vals, torch.gather(cols, 1, pos.long()).int()

    def stage_e():
        return exact_topk(stage_a()[0], k=k)

    fns = dict(zip(STAGES, (stage_a, stage_b, stage_c, stage_d, stage_e)))
    ms = {key: enqueued_ms(fn, dev, reps) for key, fn in fns.items()}
    launches = launched()
    for key, label in STAGES.items():
        log(f"{label:44s} {ms[key]:9.4f} ms")

    d_top, d_rows = fetch(stage_d())
    e_top, e_rows = fetch(stage_e())
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    s_top, s_rows = fetch(fused_search(
        ids, w, empty, empty, head, scales, valid, head_terms=f, k=k,
        head_backend="cuda" if dev.type == "cuda" else "torch",
    )[:2])
    d_same = bool(np.array_equal(d_top, s_top)
                  and np.array_equal(d_rows, s_rows))
    e_same = equal_up_to_ties(e_top, e_rows, s_top, s_rows)
    row = {
        "metric": METRIC,
        "rows": r,
        "head_terms": f,
        "batch": b,
        "top_k": k,
        "reps": reps,
        **{key: rounded(v) for key, v in ms.items()},
        "stage_d_equals_device_step": d_same,
        "stage_e_equals_device_step": e_same,
        "kernel_launches": launches,
        "device": device_name(dev),
    }
    outs = {"d_top": d_top, "d_rows": d_rows, "e_top": e_top,
            "e_rows": e_rows, "step_top": s_top, "step_rows": s_rows,
            "head": head_np, "ids": ids_np, "weights": w_np}
    return row, outs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench profile-fused",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, default=NUM_DOCS)
    ap.add_argument("--batch", type=int, default=6656)
    ap.add_argument("--topk", type=int, default=TOP_K)
    ap.add_argument("--f", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    row, _ = run(docs=args.docs, batch=args.batch, topk=args.topk, f=args.f,
                 reps=args.reps)
    print(json.dumps(row), flush=True)
    ok = row["stage_d_equals_device_step"] and row["stage_e_equals_device_step"]
    return 0 if ok else 1
