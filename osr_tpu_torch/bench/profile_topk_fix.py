"""The head product and its exact top-k in one pass against a chunked scan
with a running merge, on the CUDA card (counterpart of
``tools/profile_topk_fix.py``).

A seeded int8 head (NumPy ``default_rng(0)``: ``--rows`` x ``--f``
codes in [-127, 127]), ``--batch`` dense queries in [0, 0.01), column
scales in [0.5, 1.5) / 127 and every row valid, as the script draws
them. Each variant is run once to warm, then 4 times enqueued with one
synchronize after the last; milliseconds a call, under the script's
labels:

- ``one-program (baseline)``: K1 (``ops/head.py:masked_head_scores``:
  the bf16-rounded scaled queries times the codes, f32 sums, masked),
  then the exact top-k of the (B, R) scores (the port's stable sort);
- ``chunked scan (C=8192)``: the head padded to whole 8,192-row chunks
  (padding rows invalid), K1 on each chunk, the chunk's top-k with rows
  offset by its base, and a running ``ops/topk.py:merge_topk`` with the
  carried (B, k), carry first, so ties go to the lower row as in the
  baseline.

``scan_equals_baseline_scores`` is the script's check (the sorted top-k
scores within 1e-5); ``scan_equals_baseline`` is the stricter one the
mode exits 1 without: the same scores and rows. Dropped, null keys named
in ``dropped``: ``two-program split`` and ``optimization_barrier``, and
the matmul-to-top-k relayout stall they target: an XLA layout effect
between two fused operations, where the port's K1 writes the (B, R)
scores the selection reads. ``kernel_launches`` (K1) and ``device`` as
every mode.

Usage: python -m osr_tpu_torch.bench profile-topk-fix [--batch 6656]
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

METRIC = "topk_fix_variant_ms"
BATCH, ROWS, F, TOP_K = 6656, 57_640, 2048, 50  # the script's B, R, F, K
CHUNK = 8192
LABELS = {
    "one_program_baseline_ms": "one-program (baseline)",
    "two_program_split_ms": "two-program split",
    "optimization_barrier_ms": "optimization_barrier",
    "chunked_scan_c8192_ms": f"chunked scan (C={CHUNK})",
}
_XLA = ("the matmul-to-top_k relayout stall it targets is an XLA layout "
        "effect between two fused operations; the port's K1 writes the "
        "(B, R) scores the selection reads, so there is nothing to split")
DROPPED = {"two_program_split_ms": _XLA, "optimization_barrier_ms": _XLA}
KEYS = ("metric", "batch", "rows", "head_terms", "top_k", "chunk", *LABELS,
        "scan_equals_baseline_scores", "scan_equals_baseline", "dropped",
        "kernel_launches", "device")


def run(
    *,
    batch: int = BATCH,
    rows: int = ROWS,
    f: int = F,
    topk: int = TOP_K,
    chunk: int = CHUNK,
    with_scores: bool = False,
    device=None,
) -> Tuple[Dict[str, object], Dict[str, np.ndarray]]:
    """The row, and both variants' (top, rows) on the host, with the
    baseline's (B, R) scores if ``with_scores``. The tests pass
    ``device="cpu"`` and small sizes."""
    from osr_tpu_torch.ops.head import masked_head_scores
    from osr_tpu_torch.ops.topk import merge_topk
    from osr_tpu_torch.ops.topk import topk as exact_topk

    dev = resolve_device(device)
    b, r, k = batch, rows, topk
    log(f"device: {device_name(dev)} B={b} R={r} F={f}")
    rng = np.random.default_rng(0)
    head_np = rng.integers(-127, 128, (r, f)).astype(np.int8)
    q = torch.from_numpy(
        (rng.random((b, f)) * 0.01).astype(np.float32)).to(dev)
    scales = torch.from_numpy(
        (rng.random(f).astype(np.float32) + 0.5) / 127.0).to(dev)
    nc = -(-r // chunk)
    rp = nc * chunk
    headp = torch.zeros((rp, f), dtype=torch.int8, device=dev)
    headp[:r] = torch.from_numpy(head_np).to(dev)
    del head_np
    validp = torch.zeros(rp, dtype=torch.bool, device=dev)
    validp[:r] = True
    head, valid = headp[:r], validp[:r]
    bases = [c * chunk for c in range(nc)]
    sync(dev)
    reset_all_launches()

    def one():
        return exact_topk(masked_head_scores(head, scales, q, valid), k=k)

    def scanned():
        cs = torch.full((b, k), float("-inf"), device=dev)
        cr = torch.zeros((b, k), dtype=torch.int32, device=dev)
        for base in bases:
            hs = masked_head_scores(headp[base : base + chunk], scales, q,
                                    validp[base : base + chunk])
            s, rr = exact_topk(hs, k=k)
            cs, cr = merge_topk([cs, s], [cr, rr + base], k)
        return cs, cr

    ms: Dict[str, Optional[float]] = dict.fromkeys(LABELS)
    ms["one_program_baseline_ms"] = enqueued_ms(one, dev)
    ms["chunked_scan_c8192_ms"] = enqueued_ms(scanned, dev)
    launches = launched()
    for key, label in LABELS.items():
        v = ms[key]
        log(f"{label}: " + ("dropped" if v is None else f"{v:9.4f} ms"))
    a_s, a_r = fetch(one())
    c_s, c_r = fetch(scanned())
    close = bool(np.allclose(np.sort(a_s), np.sort(c_s), atol=1e-5))
    same = bool(np.array_equal(a_s, c_s) and np.array_equal(a_r, c_r))
    log(f"scan == baseline scores: {close}; scores and rows: {same}")
    row = {
        "metric": METRIC,
        "batch": b,
        "rows": r,
        "head_terms": f,
        "top_k": k,
        "chunk": chunk,
        **{key: rounded(v) for key, v in ms.items()},
        "scan_equals_baseline_scores": close,
        "scan_equals_baseline": same,
        "dropped": DROPPED,
        "kernel_launches": launches,
        "device": device_name(dev),
    }
    outs = {"base_top": a_s, "base_rows": a_r, "scan_top": c_s,
            "scan_rows": c_r}
    if with_scores:
        outs["scores"] = fetch([masked_head_scores(head, scales, q, valid)])[0]
    return row, outs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench profile-topk-fix",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--f", type=int, default=F)
    ap.add_argument("--topk", type=int, default=TOP_K)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    row, _ = run(batch=args.batch, rows=args.rows, f=args.f, topk=args.topk)
    print(json.dumps(row), flush=True)
    return 0 if row["scan_equals_baseline"] else 1
