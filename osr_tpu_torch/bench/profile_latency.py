"""One small search split into its stages on the CUDA card (counterpart of
``tools/profile_latency.py``).

One ``SparseSearchEngine`` at ``batch_sizes=(--batch,)``, exact top-k, no
query cache, over the script's corpus and 200 queries (one seed-42
generator, corpus first), after one warm search. Each of ``--iters``
iterations takes the next query through the engine's own stages, one
after another, each timed on the host clock:

- ``encode_ms``: ``encode_queries``;
- ``tail_ms``: the tail postings walk (``_tail_candidates``);
- ``upload_ms``: the head ids and weights to the card, then a stream
  synchronize;
- ``execute+download_ms``: ``device_step`` (scatter, K2, selection),
  then its (top, rows) to the host;
- ``download_only_ms``: the same two tensors to the host again;
- ``merge_ms``: what ``finish_batch`` does for the batch: the tau filter
  where it applies, the candidates' head dots, ``merge_tau_slack`` and
  ``merge_host``;
- ``result_dicts_ms`` (not in the script): the result dicts, which the
  port's ``search()`` pays and which lead a batch's host time;
- ``end_to_end_ms``: all of them.

Then ``--iters`` calls of ``engine.search`` (``engine search() e2e``).
Prints the script's table (p50 / p95) on stderr and, as its last line,
the same numbers as JSON with ``kernel_launches`` over both loops (K2:
one launch an iteration in each, at FiQA scale R/128 = 451 blocks > 2 ×
top_k).

Usage: python -m osr_tpu_torch.bench profile-latency [--batch 1]
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
    launched,
    log,
    no_card,
    reset_all_launches,
    workload,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "search_latency_stage_ms"
STAGES = (
    "encode_ms", "tail_ms", "upload_ms", "execute+download_ms",
    "download_only_ms", "merge_ms", "result_dicts_ms", "end_to_end_ms",
)
NUM_TEXTS = 200  # the script's query pool


def pct(xs, p) -> float:
    return float(np.percentile(xs, p))


def merge(engine, enc, cand, top: np.ndarray, rows: np.ndarray,
          top_k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The host merge of one batch whose device (top, rows) are on the
    host, as ``SparseSearchEngine.finish_batch`` runs it on the host
    merge: (scores, rows) of the final top-k."""
    from osr_tpu_torch.index import postings as P

    num_rows = engine._dev.num_rows
    slack = P.merge_tau_slack(
        engine._slack_per_term, enc.head_flat_ids, enc.head_flat_counts,
        enc.head_ptr,
    )
    nq = max(1, len(enc.head_ptr) - 1)
    if (engine.cand_filter_per_query
            and cand.total >= engine.cand_filter_per_query * nq):
        cand = P.filter_candidates_by_tau(
            cand, top, rows, top_k, slack, num_rows
        )
    cand_head = engine._cand_head_host(cand, enc)
    return P.merge_host(top, rows, cand, cand_head, num_rows, top_k,
                        tau_slack=slack)


def run(
    *,
    docs: int = NUM_DOCS,
    vocab: int = VOCAB,
    batch: int = 1,
    topk: int = TOP_K,
    iters: int = 40,
    device=None,
) -> Tuple[Dict[str, object], Dict[str, Dict[str, float]]]:
    """The summary and, by query id, the results the stage-by-stage path
    assembled. The tests pass ``device="cpu"`` and small sizes."""
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    log(f"device: {device_name(dev)}")
    corpus, pool = workload(docs, vocab, NUM_TEXTS)
    qids, texts = list(pool), list(pool.values())
    index = SparseIndexBuilder(method="bm25").build(corpus)
    del corpus
    engine = SparseSearchEngine(
        index, device=dev, batch_sizes=(batch,), cache_queries=False,
        topk_mode="exact",
    )
    if engine.merge_backend != "host":
        raise RuntimeError("the stage split needs the host merge")
    if on_card and engine.head_backend != "cuda":
        raise RuntimeError(f"the engine's head step is "
                           f"{engine.head_backend!r}, not the kernel")
    engine.search({"warm": texts[0]}, top_k=topk)  # first calls

    stages: Dict[str, List[float]] = {name: [] for name in STAGES}
    results: Dict[str, Dict[str, float]] = {}
    reset_all_launches()
    for i in range(iters):
        j = i % len(texts)
        t_all = t = time.perf_counter()

        def lap(name):
            nonlocal t
            now = time.perf_counter()
            stages[name].append((now - t) * 1e3)
            t = now

        enc = engine.encode_queries([texts[j]])
        lap("encode_ms")
        cand = engine._tail_candidates(enc, enc.head_ids.shape[0])
        lap("tail_ms")
        ids = engine._upload(enc.head_ids)
        w = engine._upload(enc.head_weights)
        if on_card:
            torch.cuda.current_stream(dev).synchronize()
        lap("upload_ms")
        top_d, rows_d, _ = engine.device_step(ids, w, topk)
        top, rows = top_d.cpu().numpy(), rows_d.cpu().numpy()
        lap("execute+download_ms")
        top_d.cpu(), rows_d.cpu()
        lap("download_only_ms")
        scores, found = merge(engine, enc, cand, top, rows, topk)
        lap("merge_ms")
        results[qids[j]] = engine._result_dicts(scores, found)[0]
        lap("result_dicts_ms")
        stages["end_to_end_ms"].append((time.perf_counter() - t_all) * 1e3)

    lats = []
    for i in range(iters):
        t0 = time.perf_counter()
        engine.search({"q": texts[i % len(texts)]}, top_k=topk)
        lats.append((time.perf_counter() - t0) * 1e3)
    launches = launched()

    log(f"B={batch} stage decomposition (p50 / p95 over {iters} iters):")
    for name, xs in stages.items():
        log(f"{name:22s} {pct(xs, 50):7.2f} / {pct(xs, 95):7.2f} ms")
    log(f"{'engine search() e2e':22s} {pct(lats, 50):7.2f} / "
        f"{pct(lats, 95):7.2f} ms")
    summary = {
        "metric": METRIC,
        "num_docs": docs,
        "batch": batch,
        "top_k": topk,
        "iters": iters,
        "stages": {
            name: {"p50": round(pct(xs, 50), 4), "p95": round(pct(xs, 95), 4)}
            for name, xs in stages.items()
        },
        "engine_search_e2e_ms": {"p50": round(pct(lats, 50), 4),
                                 "p95": round(pct(lats, 95), 4)},
        "kernel_launches": launches,
        "device": device_name(dev),
    }
    return summary, results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench profile-latency",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, default=NUM_DOCS)
    ap.add_argument("--vocab", type=int, default=VOCAB)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--topk", type=int, default=TOP_K)
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    summary, _ = run(docs=args.docs, vocab=args.vocab, batch=args.batch,
                     topk=args.topk, iters=args.iters)
    print(json.dumps(summary), flush=True)
    return 0
