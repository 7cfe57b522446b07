"""The sparse device step taken apart on the CUDA card: scatter, head
kernel, selection, transfers (counterpart of ``tools/profile_device.py``).

One ``SparseSearchEngine`` over ``bench.py``'s corpus (``--docs``,
``--vocab``; seed 42) holds the head on the card. A seeded batch of
``--batch`` queries with 16 head terms each (NumPy ``default_rng(0)``:
ids with repeats, as the script draws them, and weights in [0, 1)) is
uploaded once. Each stage is run once to warm, then 4 times enqueued
back to back with one synchronize after the last (the script's
fetch-forced timing); its milliseconds a call, under the script's labels:

- ``fused exact total``: the engine's device step (``ops/bm25.py:
  fused_search``: scatter, K2, the block-pruned selection);
- ``fused approx total``: the step of ``topk_mode='approx'``, which in
  the port is the same exact step;
- ``scatter+mm+mask+topk (scalar out)``: scatter and K2
  (``head_step_scores``), then the exact top-k of the whole (B, R)
  matrix (the port's stable sort, ``ops/topk.py:topk``) reduced to a
  scalar;
- ``+ packed (B,2k) output``: the same keeping the (B, k) scores and the
  (B, k) int32 rows;
- ``scatter+matmul+mask(+reduce)``: scatter and K2, reduced to a scalar;
- ``top_k alone`` and ``top_k bf16``: the exact top-k of a seeded
  (B, R) normal matrix, in f32 and cast to bf16;
- ``query upload`` and ``result download``: the head ids and weights to
  the card, the step's (top, rows) back, each through pinned memory (3
  times, the mean).

Dropped: ``approx_max_k`` (``lax.approx_max_k`` has no CUDA counterpart;
the port's approx mode is the exact step), a null key named in
``dropped``. The row adds ``fused_equals_engine_step`` (the fused total's
output equals ``SparseSearchEngine.device_step`` on the same batch, as
it must: the mode exits 1 otherwise), ``kernel_launches`` (K2) and
``device``. Prints the script's lines on stderr and the row as JSON last.

Usage: python -m osr_tpu_torch.bench profile-device [--batch 6656]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from osr_tpu_torch.bench.common import (
    NUM_DOCS,
    TOP_K,
    VOCAB,
    device_name,
    enqueued_ms,
    fetch,
    launched,
    log,
    make_corpus,
    no_card,
    reset_all_launches,
    rounded,
    sync,
)
from osr_tpu_torch.retrieval.engine import _upload, resolve_device

METRIC = "sparse_device_stage_ms"
QUERY_TERMS = 16  # the script's Q
LABELS = {
    "fused_exact_total_ms": "fused exact total",
    "fused_approx_total_ms": "fused approx total",
    "scatter_mm_mask_topk_scalar_out_ms":
        "scatter+mm+mask+topk (scalar out)",
    "packed_b2k_output_ms": "  + packed (B,2k) output",
    "scatter_matmul_mask_reduce_ms": "scatter+matmul+mask(+reduce)",
    "top_k_alone_ms": "top_k alone",
    "top_k_bf16_ms": "top_k bf16",
    "approx_max_k_ms": "approx_max_k",
    "query_upload_ms": "query upload",
    "result_download_ms": "result download",
}
DROPPED = {
    "approx_max_k_ms": "lax.approx_max_k has no CUDA counterpart; the "
    "port's topk_mode='approx' is the exact step",
}
KEYS = (
    "metric", "num_docs", "rows", "head_terms", "head_dtype", "batch",
    "top_k", *LABELS, "query_upload_mb", "result_download_mb",
    "fused_equals_engine_step", "dropped", "kernel_launches", "device",
)


def run(
    *,
    docs: int = NUM_DOCS,
    vocab: int = VOCAB,
    batch: int = 6656,
    topk: int = TOP_K,
    device=None,
) -> Tuple[Dict[str, object], Dict[str, np.ndarray]]:
    """The row, and on the host the fused total's (top, rows) and the
    query ids and weights. The tests pass ``device="cpu"`` and small
    sizes."""
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.ops.bm25 import fused_search, head_step_scores
    from osr_tpu_torch.ops.topk import topk as exact_topk
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    dev = resolve_device(device)
    b = batch
    log(f"device: {device_name(dev)}  B={b}")
    index = SparseIndexBuilder(method="bm25").build(make_corpus(docs, vocab))
    engine = SparseSearchEngine(index, device=dev, batch_sizes=(b,),
                                cache_queries=False)
    if dev.type == "cuda" and engine.head_backend != "cuda":
        raise RuntimeError(f"the engine's head step is "
                           f"{engine.head_backend!r}, not the kernel")
    d = engine._dev
    head, scales, valid = d.head, d.head_scales, d.valid
    f = index.layout.head_terms
    r = head.shape[0]
    backend = engine.head_backend
    log(f"R={r} F={f} head_dtype={index.layout.head_dtype}")

    rng = np.random.default_rng(0)
    ids_np = rng.integers(0, f, size=(b, QUERY_TERMS)).astype(np.int32)
    w_np = rng.random((b, QUERY_TERMS)).astype(np.float32)
    ids, w = _upload(ids_np, dev), _upload(w_np, dev)
    hs_mat = torch.from_numpy(
        rng.standard_normal((b, r), dtype=np.float32)).to(dev)
    sync(dev)
    reset_all_launches()

    def full():
        return fused_search(ids, w, d.empty_i32, d.empty_i32, head, scales,
                            valid, head_terms=f, k=topk,
                            head_backend=backend)[:2]

    def scores():
        return head_step_scores(ids, w, head, scales, valid, head_terms=f,
                                head_backend=backend, with_block_max=True)[0]

    def fused_scalar():
        s, rows = exact_topk(scores(), k=topk)
        return s[:, 0].sum() + rows[:, 0].sum()

    def fused_out():
        return exact_topk(scores(), k=topk)

    def mm_only():
        hs = scores()
        return torch.where(torch.isfinite(hs), hs, 0.0).sum()

    def tk(x):
        s, rows = exact_topk(x, k=topk)
        return s[:, 0].float().sum() + rows[:, 0].sum()

    ms: Dict[str, Optional[float]] = {
        "fused_exact_total_ms": enqueued_ms(full, dev),
        "fused_approx_total_ms": enqueued_ms(
            lambda: engine.device_step(ids, w, topk), dev),
        "scatter_mm_mask_topk_scalar_out_ms": enqueued_ms(fused_scalar, dev),
        "packed_b2k_output_ms": enqueued_ms(fused_out, dev),
        "scatter_matmul_mask_reduce_ms": enqueued_ms(mm_only, dev),
        "top_k_alone_ms": enqueued_ms(lambda: tk(hs_mat), dev),
        "top_k_bf16_ms": enqueued_ms(
            lambda: tk(hs_mat.to(torch.bfloat16)), dev),
        "approx_max_k_ms": None,
    }
    del hs_mat

    t0 = time.perf_counter()
    for _ in range(3):
        _upload(ids_np, dev), _upload(w_np, dev)
        sync(dev)
    ms["query_upload_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    out = full()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        top, rows = fetch(out)
    ms["result_download_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    launches = launched()

    want = fetch(engine.device_step(ids, w, topk)[:2])
    same = bool(np.array_equal(top, want[0])
                and np.array_equal(rows, want[1]))
    up_mb = (ids_np.nbytes + w_np.nbytes) / 2**20
    down_mb = (top.nbytes + rows.nbytes) / 2**20
    for key, label in LABELS.items():
        v = ms[key]
        log(f"{label}: " + ("dropped" if v is None else f"{v:9.4f} ms"))
    row = {
        "metric": METRIC,
        "num_docs": docs,
        "rows": r,
        "head_terms": f,
        "head_dtype": index.layout.head_dtype,
        "batch": b,
        "top_k": topk,
        **{k: rounded(v) for k, v in ms.items()},
        "query_upload_mb": rounded(up_mb),
        "result_download_mb": rounded(down_mb),
        "fused_equals_engine_step": same,
        "dropped": DROPPED,
        "kernel_launches": launches,
        "device": device_name(dev),
    }
    return row, {"top": top, "rows": rows, "ids": ids_np, "weights": w_np}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench profile-device",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, default=NUM_DOCS)
    ap.add_argument("--vocab", type=int, default=VOCAB)
    ap.add_argument("--batch", type=int, default=6656)
    ap.add_argument("--topk", type=int, default=TOP_K)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    row, _ = run(docs=args.docs, vocab=args.vocab, batch=args.batch,
                 topk=args.topk)
    print(json.dumps(row), flush=True)
    return 0 if row["fused_equals_engine_step"] else 1
