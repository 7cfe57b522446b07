"""Ranking quality of the int8 and int4 heads against an f32 head at corpus
scale, on the CUDA card (counterpart of ``tools/bench_int4_quality.py``).

The scaling corpus shape (250,000 docs, 400,000 terms, the Zipf recipe of
``tools/bench_scaling.py``) is built three times at one pinned head width
(2,048 terms), with an f32, an int8 and an int4 head, so only the head's
quantization changes. Each build is searched by one engine at B = 2,048,
exact top-50: the int8 head through K2, the int4 head through K3, the f32
head through the plain product (f32, TF32 off). Per quantized head, query
by query against the f32 head: overlap@10 and @50 (the mean share of the
f32 top-k retrieved) and the score MAE on the f32 top-50, absolute and
relative to the top-1 score. On the card each quantized engine is also
held to an engine on the same build whose head step is the plain version
(``common.merge_check``, 256 queries). Prints one JSON row per quantized
head.

Usage: python -m osr_tpu_torch.bench int4-quality [--docs 250000]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from osr_tpu_torch.bench.common import (
    device_name,
    launched,
    log,
    merge_check,
    no_card,
    reset_all_launches,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "head_dtype_ranking_quality"
NUM_DOCS = 250_000
VOCAB = 400_000
NUM_QUERIES = 2_048
HEAD_TERMS = 2_048
TOP_K = 50
DTYPES = ("f32", "int8", "int4")
# The kernel each quantized head's search takes on the card.
KERNEL = {"int8": "head_blockmax_i8", "int4": "head_blockmax_i4"}

Ranked = Dict[str, List[Tuple[str, float]]]


def ranking_quality(truth: Ranked, got: Ranked) -> Dict[str, float]:
    """The script's comparison of one head's results with the f32 head's,
    over the queries whose f32 result is not empty."""
    o10, o50, maes, rel = [], [], [], []
    for qid, t_items in truth.items():
        if not t_items:
            continue
        t_ids = [d for d, _ in t_items]
        t_scores = dict(t_items)
        g = dict(got.get(qid, []))
        o10.append(len(set(t_ids[:10]) & set(list(g)[:10])) / 10.0)
        o50.append(len(set(t_ids) & set(g)) / float(len(t_ids)))
        common = [d for d in t_ids if d in g]
        if common:
            err = np.mean([abs(g[d] - t_scores[d]) for d in common])
            maes.append(err)
            top1 = abs(t_items[0][1]) or 1.0
            rel.append(err / top1)
    return {
        "num_queries": len(o10),
        "overlap_at_10": round(float(np.mean(o10)), 4),
        "overlap_at_50": round(float(np.mean(o50)), 4),
        "score_mae_on_f32_top50": round(float(np.mean(maes)), 5),
        "score_mae_rel_top1": round(float(np.mean(rel)), 5),
    }


def run(
    *,
    num_docs: int = NUM_DOCS,
    vocab: int = VOCAB,
    num_queries: int = NUM_QUERIES,
    head_terms: int = HEAD_TERMS,
    device=None,
) -> Tuple[List[Dict[str, object]], Dict[str, Ranked]]:
    """Build, search and compare; prints one row per quantized head and
    returns the rows and each head's ranked results. The tests pass
    ``device="cpu"`` and small sizes."""
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine
    from osr_tpu_torch.testing import SyntheticDataGenerator

    dev = resolve_device(device)
    gen = SyntheticDataGenerator(seed=42)
    corpus = gen.zipf_corpus(
        num_docs, vocab, avg_len=130, word_prefix="t", min_len=5
    )
    queries = gen.queries(
        num_queries, vocab, avg_terms=11, word_prefix="t", min_terms=2
    )
    results: Dict[str, Ranked] = {}
    launches: Dict[str, Dict[str, int]] = {}
    checked: Dict[str, Optional[int]] = {}
    for dtype in DTYPES:
        t0 = time.perf_counter()
        index = SparseIndexBuilder(
            method="bm25", head_terms=head_terms, head_dtype=dtype
        ).build(corpus)
        build_s = time.perf_counter() - t0

        def engine(head_backend="auto"):
            return SparseSearchEngine(
                index, device=dev, batch_sizes=(num_queries,),
                cache_queries=False, topk_mode="exact",
                head_backend=head_backend,
            )

        eng = engine()
        want = "cuda" if dtype in KERNEL and dev.type == "cuda" else "torch"
        if eng.head_backend != want:
            raise RuntimeError(f"{dtype} head: head step "
                               f"{eng.head_backend!r}, not {want!r}")
        reset_all_launches()
        res = eng.search(queries, top_k=TOP_K)
        launches[dtype] = launched()
        if want == "cuda" and not launches[dtype].get(KERNEL[dtype]):
            raise RuntimeError(
                f"{dtype} head: launched no {KERNEL[dtype]} "
                f"({launches[dtype]})"
            )
        results[dtype] = {qid: list(r.items()) for qid, r in res.items()}
        checked[dtype] = (
            merge_check(eng, engine("torch"), queries)
            if want == "cuda" else None
        )
        del eng, index
        log(f"{dtype}: built {build_s:.1f}s, searched"
            + (f", {checked[dtype]} candidates within the merge slack"
               if checked[dtype] else ""))

    rows = []
    for dtype in DTYPES[1:]:
        quality = ranking_quality(results["f32"], results[dtype])
        row = {
            "metric": METRIC,
            "head_dtype": dtype,
            "vs": "f32 exact head (same corpus, same head width)",
            "num_docs": num_docs,
            "vocab_size": vocab,
            "head_terms": head_terms,
            "num_queries": quality.pop("num_queries"),
            "top_k": TOP_K,
            **quality,
            "merge_checked_candidates": checked[dtype],
            "kernel_launches": launches[dtype],
            "device": device_name(dev),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows, results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench int4-quality",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, default=NUM_DOCS,
                    help="corpus size (default the script's 250,000)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    run(num_docs=args.docs)
    return 0
