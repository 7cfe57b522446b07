"""Sparse throughput against batch size at FiQA scale on the CUDA card
(counterpart of ``tools/bench_batch_curve.py``).

The headline times one batch of half the query set; a server picks its
batch from a latency budget. This measures the curve: for each batch
size one ``SparseSearchEngine`` at ``batch_sizes=(b,)``, exact top-k,
one warm pass, then ``--passes`` timed passes over about 2,000 queries,
and the QPS and per-query time at that batch. At the default size every
batch takes K2 (the FiQA head has 57,728 rows, 451 blocks of 128 against
2 x top_k); on the card each must launch K2 or K1. Prints
one JSON row per batch size; ``--out PATH`` also appends each row to
PATH.

The workload is the script's: corpus and queries from one seed-42
``SyntheticDataGenerator`` (the queries are not ``bench.py``'s seed-6
set). ``queries_timed`` counts the queries searched: at B = 6,656 all
6,648 (the script divided by 6,656).

Usage: python -m osr_tpu_torch.bench batch-curve [--batches 8,128,2048]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from osr_tpu_torch.bench.common import (
    INT8_HEAD_KERNELS,
    NUM_DOCS,
    NUM_QUERIES,
    TOP_K,
    VOCAB,
    device_name,
    launched,
    log,
    no_card,
    reset_all_launches,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "sparse_qps_batch_curve"
BATCHES = (8, 128, 512, 2048, 6656)
PASS_QUERIES = 2_000  # a few batches a pass


def workload(docs: int = NUM_DOCS, vocab: int = VOCAB,
             num_queries: int = NUM_QUERIES):
    """The script's corpus and queries: one seed-42 generator."""
    from osr_tpu_torch.testing import SyntheticDataGenerator

    gen = SyntheticDataGenerator(seed=42)
    corpus = gen.zipf_corpus(
        docs, vocab, avg_len=130, word_prefix="t", min_len=5
    )
    queries = gen.queries(
        num_queries, vocab, avg_terms=11, word_prefix="t", min_terms=2
    )
    return corpus, queries


def timed_count(batch: int, available: int) -> int:
    """The queries a pass at ``batch`` searches: max((2000 // b) * b, b),
    as many as exist."""
    return min(max((PASS_QUERIES // batch) * batch, batch), available)


def run(
    *,
    docs: int = NUM_DOCS,
    vocab: int = VOCAB,
    batches: Sequence[int] = BATCHES,
    topk: int = TOP_K,
    passes: int = 3,
    num_queries: int = NUM_QUERIES,
    device=None,
    out: Optional[str] = None,
) -> Tuple[List[Dict[str, object]], Dict[int, Dict[str, Dict[str, float]]]]:
    """One row per batch size, each printed (and appended to ``out``) as
    it is measured; returns the rows and each batch's last-pass results.
    The tests pass ``device="cpu"`` and small sizes."""
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    dev = resolve_device(device)
    corpus, queries = workload(docs, vocab, num_queries)
    t0 = time.perf_counter()
    index = SparseIndexBuilder(method="bm25").build(corpus)
    log(f"index built in {time.perf_counter() - t0:.1f} s: "
        f"{index.stats()['num_rows']} rows")
    del corpus
    rows, results = [], {}
    for b in batches:
        engine = SparseSearchEngine(
            index, device=dev, batch_sizes=(b,), cache_queries=False,
            topk_mode="exact",
        )
        if dev.type == "cuda" and engine.head_backend != "cuda":
            raise RuntimeError(f"batch {b}: the engine's head step is "
                               f"{engine.head_backend!r}, not the kernel")
        sub = dict(list(queries.items())[:timed_count(b, len(queries))])
        engine.search(sub, top_k=topk)  # first calls + warm
        qps = []
        reset_all_launches()
        for _ in range(passes):
            t0 = time.perf_counter()
            res = engine.search(sub, top_k=topk)
            qps.append(round(len(sub) / (time.perf_counter() - t0), 1))
        launches = launched()
        if dev.type == "cuda" and not any(
            launches.get(k) for k in INT8_HEAD_KERNELS
        ):
            raise RuntimeError(f"batch {b}: launched no head kernel "
                               f"({launches})")
        results[b] = res
        row = {
            "batch": b,
            "num_docs": docs,
            "qps_median": float(np.median(qps)),
            "qps_passes": qps,
            "ms_per_query": round(1000.0 / float(np.median(qps)), 3),
            "queries_timed": len(sub),
            "top_k": topk,
            "kernel_launches": launches,
            "device": device_name(dev),
        }
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        rows.append(row)
        del engine
    return rows, results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench batch-curve",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, default=NUM_DOCS)
    ap.add_argument("--vocab", type=int, default=VOCAB)
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    ap.add_argument("--topk", type=int, default=TOP_K)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="also append the rows to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    run(
        docs=args.docs, vocab=args.vocab,
        batches=[int(x) for x in args.batches.split(",")],
        topk=args.topk, passes=args.passes, out=args.out,
    )
    return 0
