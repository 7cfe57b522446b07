"""Hybrid fusion operating points from one build, on the CUDA card
(counterpart of ``tools/bench_fusion_sweep.py``).

Fusion is applied at search time, so one hybrid build (BM25 and a
hashing-encoder dense leg, ``RetrieverRegistry.create``) serves every
point through ``HybridRetriever.set_fusion``: each leg alone, weighted
fusion at sparse weights 0.3, 0.5, 0.7 and 0.9, and RRF at seven
(sparse weight, dense weight, k) points. The dataset is quality-at-scale's
prose harvest (``--roots``, default this interpreter's stdlib and
site-packages) with its graded qrels. Each point's quality comes from a
first pass and ``qps_warm`` from a second. The sparse leg runs a head
kernel (K2, or K1 below the block-prune floor), the dense leg K7 + K5.
Prints the run object as one JSON line; writes no file.

Usage: python -m osr_tpu_torch.bench fusion-sweep [--query-mode noisy]
       [--encoder hashing_idf] [--max-chunks N] [--roots DIR ...]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from osr_tpu_torch.bench import quality_at_scale as bqas
from osr_tpu_torch.bench.common import (
    INT8_HEAD_KERNELS,
    device_name,
    launched,
    log,
    no_card,
    prose_roots,
    reset_all_launches,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "hybrid_fusion_sweep"
WEIGHTED = (0.3, 0.5, 0.7, 0.9)
RRF_POINTS = ((1.0, 1.0, 20.0), (1.0, 1.0, 60.0), (1.0, 1.0, 100.0),
              (2.0, 1.0, 20.0), (2.0, 1.0, 60.0), (2.0, 1.0, 100.0),
              (3.0, 1.0, 60.0))


def sweep(retr, queries, qrels, top_k: int) -> List[Dict[str, object]]:
    """The script's 13 rows, in its order, through ``set_fusion``."""
    from osr_tpu_torch.metrics.ir import evaluate_retrieval

    def graded_search(searcher, label, extra):
        results = searcher(queries, top_k=top_k)
        retr.clear_cache()
        t0 = time.perf_counter()
        searcher(queries, top_k=top_k)
        qps = len(queries) / (time.perf_counter() - t0)
        retr.clear_cache()
        m = evaluate_retrieval(results, qrels, k_values=(10, 100))
        row = {"config": label, **extra, "qps_warm": round(qps, 1),
               **{k: round(v, 4) for k, v in m.items()}}
        log(json.dumps(row))
        return row

    rows = [graded_search(retr.sparse.search, "sparse_only", {}),
            graded_search(retr.dense.search, "dense_only", {})]
    for sw in WEIGHTED:
        retr.set_fusion(sparse_weight=sw, dense_weight=1.0 - sw,
                        fusion="weighted")
        rows.append(graded_search(retr.search, "weighted", {
            "sparse_weight": sw, "dense_weight": round(1.0 - sw, 2)}))
    for sw, dw, rk in RRF_POINTS:
        retr.set_fusion(sparse_weight=sw, dense_weight=dw, fusion="rrf",
                        rrf_k=rk)
        rows.append(graded_search(retr.search, "rrf", {
            "sparse_weight": sw, "dense_weight": dw, "rrf_k": rk}))
    return rows


def run(
    chunks: Sequence[str],
    *,
    num_queries: int = 512,
    query_mode: str = "noisy",
    top_k: int = 100,
    encoder: str = "hashing_idf",
    device=None,
) -> Dict[str, object]:
    """One build, the 13 points; the run object printed as one JSON line
    and returned. On the card the sweep must launch a head kernel, K7 and
    K5. The tests pass ``device="cpu"``."""
    from osr_tpu_torch.retrieval.registry import RetrieverRegistry
    from osr_tpu_torch.storage.loaders import (
        extract_query_text,
        load_corpus,
        load_qrels,
        load_queries,
    )
    from osr_tpu_torch.testing import build_dataset

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as td:
        ds = Path(td) / "prose_sweep"
        n_queries, _ = build_dataset(ds, chunks, num_queries, mode=query_mode)
        corpus = load_corpus(ds)
        qrels = load_qrels(ds)
        queries = {
            qid: extract_query_text(q)
            for qid, q in load_queries(ds).items()
            if not qrels or qid in qrels
        }
    retr = RetrieverRegistry.create({
        "type": "hybrid",
        "params": {"encoder": encoder, "cache_matrices": False,
                   "cache_dir": None, "device": dev},
    })
    t0 = time.perf_counter()
    retr.build_index_from_corpus(corpus)
    build_s = time.perf_counter() - t0
    del corpus
    if dev.type == "cuda" and (retr.sparse.engine.head_backend != "cuda"
                               or retr.dense.engine.backend != "cuda"):
        raise RuntimeError("the hybrid's legs do not take the CUDA kernels")
    reset_all_launches()
    rows = sweep(retr, queries, qrels, top_k)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = launched()
    if dev.type == "cuda":
        bqas.require("fusion sweep", launches, any_of=INT8_HEAD_KERNELS,
                     all_of=bqas.DENSE_KERNELS)
    out = {
        "dataset": "at-scale real-prose harvest (see "
        "python -m osr_tpu_torch.bench quality-at-scale)",
        "encoder": encoder,
        "query_mode": query_mode,
        "num_docs": len(chunks),
        "num_queries": n_queries,
        "top_k": top_k,
        "build_s": round(build_s, 2),
        "device": device_name(dev),
        "sweep": rows,
        "kernel_launches": launches,
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench fusion-sweep",
        description=__doc__.splitlines()[0],
    )
    bqas.add_harvest_options(ap)
    ap.add_argument("--query-mode", default="noisy",
                    choices=bqas.QUERY_MODES)
    ap.add_argument("--top-k", type=int, default=100)
    ap.add_argument("--encoder", default="hashing_idf",
                    choices=("hashing", "hashing_idf"),
                    help="the dense leg's encoder")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        return no_card(METRIC)
    roots = args.roots or prose_roots()
    chunks = bqas.harvest(args.max_chunks, roots)
    refused = bqas.below_floor(chunks, METRIC)
    if refused:
        return refused
    run(chunks, num_queries=args.num_queries, query_mode=args.query_mode,
        top_k=args.top_k, encoder=args.encoder,
        device="cpu" if args.cpu else None)
    return 0
