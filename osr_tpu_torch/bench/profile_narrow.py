"""The narrowed exact selection (per-block top-m) on the CUDA card, alone
and inside the device step (counterpart of ``tools/profile_narrow.py``).

Three parts at the FiQA bench shape (``--docs`` rows, ``--batch``
queries, top ``--topk``), each run once to warm, then 6 times enqueued
with one synchronize after the last; milliseconds a call, under the
script's labels:

1. Selection alone over a seeded (B, R) matrix (NumPy
   ``default_rng(0)`` normals x 5, -inf past R in the last block) and
   its block maxima: ``selection full-width (k*128 cand)``,
   ``ops/topk.py:block_topk_from_max``, against ``selection narrow
   m=4|8|16 (k*m cand)``, the port's narrowed selection: each block's
   top m (``block_topm``) and the top-k of the k best blocks' k x m
   candidates (``blocktopm_topk``); where its tie-safety flag is set
   (read on the host, one synchronize a call) the full-width selection
   runs instead (``..._fallback``), as
   ``osr_tpu``'s ``block_topk_narrow`` falls back. Each must equal the
   full width bit for bit (``..._bit_identical``).
2. The whole device step over ``bench.py``'s corpus (seed 42; rows
   padded to 128) for a seeded batch with 16 distinct head terms a query
   (``default_rng(1)``): ``fused exact step narrow_m=0|4|8|16``. The
   port's ``narrow_m`` without extraction runs the standard step (scatter,
   K2, the block-pruned selection), so the rows at 4, 8 and 16 run
   the same program as m=0 and equal it by construction; they are
   reported all the same.
3. ``fused EXTRACT step m=4|8|16``: the extraction step
   (``ops/bm25.py:fused_search_extract``, K4-i8, m <= 16), with its
   tie-safety flag (``..._flag``); a flagged batch re-runs the standard
   step, as the engine does. Its positive (score, row) set must equal the
   m=0 step's, with rows compared above the k-th score
   (``..._positive_set_identical``, the script's rule).

``outputs_equal_across_m`` is every check at once; the mode exits 1
unless it holds. The row adds ``kernel_launches`` (K2 in part 2, K4-i8 in
part 3) and ``device``.

Usage: python -m osr_tpu_torch.bench profile-narrow [--batch 6656]
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
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "narrowed_selection_ms"
MS = (4, 8, 16)
QUERY_TERMS = 16
REPS = 6
KEYS = (
    "metric", "num_docs", "rows", "head_terms", "batch", "top_k",
    "selection_full_width_ms",
    *[f"selection_narrow_m{m}_{s}" for m in MS
      for s in ("ms", "bit_identical", "fallback")],
    *[f"fused_exact_step_narrow_m{m}_{s}" for m in (0,) + MS
      for s in ("ms", "bit_identical")],
    *[f"fused_extract_step_m{m}_{s}" for m in MS
      for s in ("ms", "flag", "positive_set_identical")],
    "outputs_equal_across_m", "kernel_launches", "device",
)


def narrowed(hs, bmax, k: int, m: int):
    """The narrowed exact selection over (B, R) scores: (values, rows,
    fell back). Each block's top m, then the top-k of the k best blocks'
    candidates; where that is unsafe (or too few candidates), the
    full-width selection."""
    from osr_tpu_torch.ops.topk import (
        block_topk_from_max,
        block_topm,
        blocktopm_topk,
    )

    kk = min(k, hs.shape[1])
    if min(kk, bmax.shape[1]) * m < kk:
        return (*block_topk_from_max(hs, bmax, k=k), True)
    top, rows, unsafe = blocktopm_topk(*block_topm(hs, m), k=k)
    if bool(unsafe):
        return (*block_topk_from_max(hs, bmax, k=k), True)
    return top, rows, False


def positive_set_identical(base_s, base_r, s, r) -> bool:
    """The script's rule: after sorting each query by (-score, row), the
    positive scores are equal, and the rows strictly above the k-th
    score (a tie at the k-th place may keep either row)."""
    def canon(s, r):
        order = np.lexsort((r, -s), axis=1)
        return (np.take_along_axis(s, order, axis=1),
                np.take_along_axis(r, order, axis=1))

    bs, br = canon(base_s, base_r)
    xs, xr = canon(s, r)
    kk = bs.shape[1]
    pos = bs > 0
    above = pos & (bs > bs[:, kk - 1 : kk])
    return bool(np.array_equal(xs[pos], bs[pos])
                and np.array_equal(xr[above], br[above]))


def run(
    *,
    docs: int = NUM_DOCS,
    vocab: int = VOCAB,
    batch: int = 6656,
    topk: int = TOP_K,
    device=None,
) -> Tuple[Dict[str, object], Dict[str, np.ndarray]]:
    """The row, and part 1's outputs (the matrix, the full-width and the
    narrowed selections) on the host. The tests pass ``device="cpu"`` and
    small sizes."""
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.ops.bm25 import fused_search, fused_search_extract
    from osr_tpu_torch.ops.topk import block_topk_from_max
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    dev = resolve_device(device)
    b, k = batch, topk
    log(f"device: {device_name(dev)}  B={b} k={k}")
    row: Dict[str, object] = {"metric": METRIC, "num_docs": docs,
                              "rows": None, "head_terms": None,
                              "batch": b, "top_k": k}
    ok = True

    # ---- 1. selection alone ------------------------------------------
    r = docs
    t = -(-r // 128)
    rng = np.random.default_rng(0)
    hs_np = rng.standard_normal((b, t * 128), dtype=np.float32) * 5.0
    hs_np[:, r:] = -np.inf
    bmax = torch.from_numpy(hs_np.reshape(b, t, 128).max(axis=2)).to(dev)
    hs = torch.from_numpy(np.ascontiguousarray(hs_np[:, :r])).to(dev)
    outs = {"scores": hs_np[:, :r]}
    sync(dev)
    row["selection_full_width_ms"] = rounded(enqueued_ms(
        lambda: block_topk_from_max(hs, bmax, k=k), dev, REPS))
    full = fetch(block_topk_from_max(hs, bmax, k=k))
    outs["full_top"], outs["full_rows"] = full
    log(f"selection full-width (k*128 cand): "
        f"{row['selection_full_width_ms']:9.4f} ms")
    for m in MS:
        ms = enqueued_ms(lambda: narrowed(hs, bmax, k, m), dev, REPS)
        top, rows, fell = narrowed(hs, bmax, k, m)
        top, rows = fetch((top, rows))
        ident = bool(np.array_equal(top, full[0])
                     and np.array_equal(rows, full[1]))
        ok &= ident
        outs[f"narrow_top_m{m}"], outs[f"narrow_rows_m{m}"] = top, rows
        row.update({f"selection_narrow_m{m}_ms": rounded(ms),
                    f"selection_narrow_m{m}_bit_identical": ident,
                    f"selection_narrow_m{m}_fallback": fell})
        log(f"selection narrow m={m:2d} (k*{m} cand): {ms:9.4f} ms  "
            f"bit-identical={ident} fallback={fell}")
    del hs, bmax

    # ---- 2. the device step (K2) -------------------------------------
    index = SparseIndexBuilder(method="bm25").build(make_corpus(docs, vocab))
    engine = SparseSearchEngine(index, device=dev, batch_sizes=(b,),
                                cache_queries=False)
    if dev.type == "cuda" and engine.head_backend != "cuda":
        raise RuntimeError(f"the engine's head step is "
                           f"{engine.head_backend!r}, not the kernel")
    d = engine._dev
    f = index.layout.head_terms
    backend = engine.head_backend
    rngq = np.random.default_rng(1)
    # Distinct ids a query: the scatter's contract, so every program sees
    # the same scattered query.
    ids = torch.from_numpy(np.stack(
        [rngq.choice(f, size=QUERY_TERMS, replace=False) for _ in range(b)]
    ).astype(np.int32)).to(dev)
    w = torch.from_numpy(
        rngq.random((b, QUERY_TERMS)).astype(np.float32)).to(dev)
    row.update(rows=d.num_rows, head_terms=f)
    log(f"R={d.num_rows} F={f} head={index.layout.head_dtype} "
        f"backend={backend}")
    sync(dev)
    reset_all_launches()

    def step():
        return fused_search(ids, w, d.empty_i32, d.empty_i32, d.head,
                            d.head_scales, d.valid, head_terms=f, k=k,
                            head_backend=backend)[:2]

    base = None
    for m in (0,) + MS:
        # narrow_m without extraction: the standard program.
        ms = enqueued_ms(step, dev, REPS)
        out = fetch(step())
        base = out if base is None else base
        ident = bool(np.array_equal(out[0], base[0])
                     and np.array_equal(out[1], base[1]))
        ok &= ident
        row.update({f"fused_exact_step_narrow_m{m}_ms": rounded(ms),
                    f"fused_exact_step_narrow_m{m}_bit_identical": ident})
        log(f"fused exact step narrow_m={m:2d}: {ms:9.4f} ms  "
            f"bit-identical={ident}")

    # ---- 3. the extraction step (K4-i8) ------------------------------
    for m in MS:
        def stepx(m=m):
            return fused_search_extract(
                ids, w, d.head, d.head_scales, d.valid, head_terms=f, k=k,
                narrow_m=m, head_backend=backend,
            )

        ms = enqueued_ms(stepx, dev, REPS)
        top, rows, unsafe = stepx()
        flag = bool(unsafe)
        top, rows = fetch(step() if flag else (top, rows))
        ident = positive_set_identical(base[0], base[1], top, rows)
        ok &= ident
        row.update({f"fused_extract_step_m{m}_ms": rounded(ms),
                    f"fused_extract_step_m{m}_flag": flag,
                    f"fused_extract_step_m{m}_positive_set_identical": ident})
        log(f"fused EXTRACT step m={m:2d}: {ms:9.4f} ms  flag={int(flag)}  "
            f"positive-set-identical={ident}")
    row.update(outputs_equal_across_m=ok, kernel_launches=launched(),
               device=device_name(dev))
    return row, outs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench profile-narrow",
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
    return 0 if row["outputs_equal_across_m"] else 1
