"""Per-batch stage costs of the sparse search on the CUDA card (counterpart
of ``tools/profile_search.py``).

One ``SparseSearchEngine`` at ``batch_sizes=(--batch,)``, no query
cache, over ``bench.py``'s corpus (seed 42) and ``6 × batch`` of its
queries (seed 6), after one warm batch. Stages, with the script's names,
in milliseconds per batch over n = 5 batches:

- ``host encode``, ``host tail candidates``, ``host cand head-dot``: run
  one after another on the host for each batch (the head dots of every
  candidate, as the script computes them);
- ``device fused (scatter+mm+mask+topk)``: the five batches' head ids and
  weights are uploaded first; ``device_step`` is enqueued 4 × 5 times and
  the last result fetched, once, and the time divided as the script
  divides it; ``device_step_event_ms`` beside it is the median of one
  step timed with CUDA events (on the card only);
- ``host merge``: ``merge_host`` over the five fetched results.

The row also holds ``batch_stages_ms``, ``common.batch_stages`` for one
batch of the same B (median of 3: the self time of each ``osr.sparse.*``
span of one ``engine.search``), the split ``chip_smoke.py``'s phase 5
prints at B = 3,328, and ``kernel_launches`` (K2 at FiQA scale). Prints
the script's table on stderr and the row as its last line.

Usage: python -m osr_tpu_torch.bench profile-search [--batch 1024]
"""

from __future__ import annotations

import argparse
import collections
import json
import time
from typing import Dict, List, Optional, Tuple

import torch

from osr_tpu_torch.bench.common import (
    NUM_DOCS,
    TOP_K,
    VOCAB,
    device_name,
    launched,
    log,
    make_corpus,
    make_queries,
    median_ms,
    median_stages,
    no_card,
    reset_all_launches,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "search_stage_ms_per_batch"
BATCHES = 5  # the script's n
REPS = 4  # the script's device repetitions
DEVICE_STAGE = "device fused (scatter+mm+mask+topk)"


def run(
    *,
    docs: int = NUM_DOCS,
    vocab: int = VOCAB,
    batch: int = 1024,
    topk: int = TOP_K,
    device=None,
) -> Tuple[Dict[str, object], Dict[str, Dict[str, float]]]:
    """The row and, by query id, the results of the five batches
    assembled from the stages. The tests pass ``device="cpu"`` and small
    sizes."""
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.index.postings import merge_host, merge_tau_slack
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    log(f"device: {device_name(dev)}")
    b = batch
    corpus = make_corpus(docs, vocab)
    queries = make_queries(6 * b, vocab)
    t0 = time.perf_counter()
    index = SparseIndexBuilder(method="bm25").build(corpus)
    log(f"build: {time.perf_counter() - t0:.2f}s")
    log(f"stats: {index.stats()}")
    del corpus
    engine = SparseSearchEngine(
        index, device=dev, batch_sizes=(b,), cache_queries=False
    )
    log(f"merge_backend: {engine.merge_backend}")
    if on_card and engine.head_backend != "cuda":
        raise RuntimeError(f"the engine's head step is "
                           f"{engine.head_backend!r}, not the kernel")
    qids, texts = list(queries), list(queries.values())
    num_rows = engine._dev.num_rows

    enc0 = engine.encode_queries(texts[:b])  # first calls + warm
    engine.finish_batch(engine.search_encoded_device(enc0, topk), topk)
    reset_all_launches()

    # --- serial host stages -------------------------------------------
    t = collections.defaultdict(float)
    handles = []
    for i in range(BATCHES):
        lo = i * b
        t0 = time.perf_counter()
        enc = engine.encode_queries(texts[lo : lo + b])
        t["host encode"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        cand = engine._tail_candidates(enc, b)
        t["host tail candidates"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        ch = engine._cand_head_host(cand, enc)
        t["host cand head-dot"] += time.perf_counter() - t0
        handles.append((enc, cand, ch))

    # --- device steady state (enqueued, one fetch at the end) ----------
    ups = [(engine._upload(e.head_ids), engine._upload(e.head_weights))
           for e, _, _ in handles]
    for ids, w in ups:
        engine.device_step(ids, w, topk)[0].cpu()
    t0 = time.perf_counter()
    for _ in range(REPS):
        for ids, w in ups:
            last = engine.device_step(ids, w, topk)
    last[0].cpu()
    t[DEVICE_STAGE] = (time.perf_counter() - t0) / REPS
    step_event_ms = (
        median_ms(lambda: engine.device_step(*ups[0], topk), reps=10)
        if on_card else None
    )

    # --- host merge -----------------------------------------------------
    fetched = []
    for ids, w in ups:
        top, rows, _ = engine.device_step(ids, w, topk)
        fetched.append((top.cpu().numpy(), rows.cpu().numpy()))
    merged = []
    t0 = time.perf_counter()
    for (hs, hr), (enc, cand, ch) in zip(fetched, handles):
        merged.append(merge_host(
            hs, hr, cand, ch, num_rows, topk,
            tau_slack=merge_tau_slack(
                engine._slack_per_term, enc.head_flat_ids,
                enc.head_flat_counts, enc.head_ptr,
            ),
        ))
    t["host merge"] = time.perf_counter() - t0

    results = {}
    for i, (scores, found) in enumerate(merged):
        dicts = engine._result_dicts(scores, found)
        results.update(zip(qids[i * b : (i + 1) * b], dicts))
    stages = median_stages(engine, texts[:b], topk)
    launches = launched()

    per_batch = {name: secs / BATCHES * 1e3 for name, secs in t.items()}
    log(f"per-batch stage costs (B={b}, n={BATCHES}):")
    for name, ms in per_batch.items():
        log(f"  {name:<38}{ms:8.2f} ms")
    if step_event_ms is not None:
        log(f"  {'device step, CUDA events (median)':<38}"
            f"{step_event_ms:8.4f} ms")
    log("one batch's spans (common.batch_stages, self ms, median of 3): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    row = {
        "metric": METRIC,
        "num_docs": docs,
        "batch": b,
        "batches": BATCHES,
        "top_k": topk,
        "merge_backend": engine.merge_backend,
        "stages_ms": {k: round(v, 4) for k, v in per_batch.items()},
        "device_step_event_ms": (
            round(step_event_ms, 4) if step_event_ms is not None else None
        ),
        "batch_stages_ms": {k: round(v, 4) for k, v in stages.items()},
        "kernel_launches": launches,
        "device": device_name(dev),
    }
    return row, results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench profile-search",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, default=NUM_DOCS)
    ap.add_argument("--vocab", type=int, default=VOCAB)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--topk", type=int, default=TOP_K)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    row, _ = run(docs=args.docs, vocab=args.vocab, batch=args.batch,
                 topk=args.topk)
    print(json.dumps(row), flush=True)
    return 0
