"""Graded retrieval quality on a prose corpus at scale, on the CUDA card
(counterpart of ``tools/bench_quality_at_scale.py``).

The corpus is every .md/.rst/.txt file of at least 2 KiB under
``--roots`` (default: the running interpreter's stdlib and site-packages,
``common.prose_roots()``), cut into 48-word windows with stride 24, exact
duplicates removed (``testing.harvest_chunks``). The queries and graded
qrels come from ``testing.build_dataset`` (seed 42): ``quote`` 6 verbatim
words, ``sample`` 6 content words across the chunk, ``noisy`` 4 source
words and 2 words of another chunk; grade 2 is the source chunk, grade 1
every other chunk holding all the query's tokens. ``run_quality_benchmark``
runs ``bm25_custom`` at top_k 100, with ``--dense-hashing`` the
hashing-encoder dense and hybrid legs, with ``--f32-control`` the engine
on an f32 head. ``main`` refuses fewer than 20,000 chunks, as the script
does: below that the corpus makes no at-scale claim.

The script's reference leg runs the reference project's code from outside
the repository and is not ported: ``reference`` is null and
``--skip-reference`` does nothing. Prints the ``at_scale`` object as one
JSON line; writes no file.

Usage: python -m osr_tpu_torch.bench quality-at-scale [--query-mode noisy]
       [--dense-hashing] [--f32-control] [--max-chunks N] [--roots DIR ...]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

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

METRIC = "graded_quality_at_scale"
MIN_CHUNKS = 20_000  # below this the harvest makes no at-scale claim
TOP_K = 100
QUERY_MODES = ("quote", "sample", "noisy")
DENSE_METHODS = ("dpr", "dpr_idf", "hybrid", "hybrid_rrf", "hybrid_rrf_idf")
DENSE_PARAMS = {
    "dpr": {"encoder": "hashing"},
    "dpr_idf": {"type": "dpr", "encoder": "hashing_idf"},
    "hybrid": {"encoder": "hashing"},
    "hybrid_rrf": {"type": "hybrid", "encoder": "hashing", "fusion": "rrf",
                   "sparse_weight": 1.0, "dense_weight": 1.0},
    "hybrid_rrf_idf": {"type": "hybrid", "encoder": "hashing_idf",
                       "fusion": "rrf", "sparse_weight": 1.0,
                       "dense_weight": 1.0},
}
F32_PARAMS = {"bm25_custom": {"head_dtype": "f32", "cache_matrices": False}}
# The kernels the dense legs must launch on the card, beside a head kernel.
DENSE_KERNELS = ("quantize_symmetric", "int8_similarity")
QUERY_DESC = {
    "quote": "6-word verbatim quote queries",
    "sample": "6 content words (>=4 chars) sampled across the chunk "
    "(second lexical regime: no phrase adjacency, rarer terms)",
    "noisy": "4 consecutive source words + 2 content words from a "
    "different random chunk (hard regime: source lacks a third of "
    "the query; ranking lands well off the ceiling)",
}


def keep(summary: Dict[str, object]) -> Dict[str, object]:
    """The IR metrics, QPS, build seconds and method of one summary."""
    return {
        k: v for k, v in summary.items()
        if k.split("@")[0] in ("ndcg", "map", "recall", "p")
        or k in ("qps", "build_s", "method")
    }


def benchmark(ds: Path, out_dir: Path, methods: Sequence[str], dev,
              method_params: Optional[Dict] = None):
    """``run_quality_benchmark`` on ``dev``; returns its summaries and the
    kernels launched, raising if a method failed."""
    from osr_tpu_torch.benchmarks.quality import run_quality_benchmark

    reset_all_launches()
    res = run_quality_benchmark(
        ds, methods=methods, out_dir=out_dir, top_k=TOP_K,
        method_params=method_params, device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for m, r in res.items():
        if "error" in r:
            raise RuntimeError(f"{m}: {r['error']}")
    return res, launched()


def require(label: str, launches: Dict[str, int], any_of=(), all_of=()):
    if any_of and not any(launches.get(k) for k in any_of):
        raise RuntimeError(f"{label}: launched none of {any_of} ({launches})")
    missing = [k for k in all_of if not launches.get(k)]
    if missing:
        raise RuntimeError(f"{label}: launched no {missing} ({launches})")


def run(
    chunks: Sequence[str],
    *,
    num_queries: int = 512,
    query_mode: str = "quote",
    dense_hashing: bool = False,
    f32_control: bool = False,
    roots: Sequence[str] = (),
    device=None,
) -> Dict[str, object]:
    """The at-scale object over ``chunks`` (any number: the floor is
    ``main``'s); printed as one JSON line and returned. On the card every
    section must launch its kernels. The tests pass ``device="cpu"``."""
    from osr_tpu_torch.testing import build_dataset

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    total: Dict[str, int] = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory() as td:
        ds = Path(td) / "prose_at_scale"
        t0 = time.perf_counter()
        n_queries, grade1_total = build_dataset(
            ds, chunks, num_queries, mode=query_mode
        )
        log(f"dataset: {len(chunks)} docs, {n_queries} queries, "
            f"{grade1_total} grade-1 qrels ({time.perf_counter() - t0:.1f}s)")
        ours, launches = benchmark(
            ds, Path(td) / "reports", ("bm25_custom",), dev
        )
        if on_card:
            require("bm25_custom", launches, any_of=INT8_HEAD_KERNELS)
        add(launches)
        ours_dense = None
        if dense_hashing:
            ours_dense, launches = benchmark(
                ds, Path(td) / "reports_dense", DENSE_METHODS, dev,
                DENSE_PARAMS,
            )
            if on_card:
                require("dense hashing", launches, any_of=INT8_HEAD_KERNELS,
                        all_of=DENSE_KERNELS)
            add(launches)
        ours_f32 = None
        if f32_control:
            ours_f32, launches = benchmark(
                ds, Path(td) / "reports_f32", ("bm25_custom",), dev,
                F32_PARAMS,
            )
            add(launches)

    where = ", ".join(roots) if roots else "the caller's roots"
    at_scale = {
        "dataset": "48-word/stride-24 chunks of all .md/.rst/.txt prose "
        f"under {where}; "
        f"{QUERY_DESC[query_mode]}; graded qrels (2=source, 1=all-token "
        "near-dups); queries matching >200 chunks rejected",
        "query_mode": query_mode,
        "num_docs": len(chunks),
        "num_queries": n_queries,
        "grade1_qrels": grade1_total,
        "osr_tpu": {m: keep(s) for m, s in ours.items()},
        "reference": None,
    }
    if ours_f32:
        at_scale["osr_tpu_f32head"] = {m: keep(s) for m, s in ours_f32.items()}
    if ours_dense:
        at_scale["osr_tpu_dense_hashing"] = {
            m: keep(s) for m, s in ours_dense.items()
        }
    at_scale["kernel_launches"] = total
    at_scale["device"] = device_name(dev)
    print(json.dumps(at_scale), flush=True)
    return at_scale


def harvest(max_chunks: int, roots: Sequence[str]) -> List[str]:
    from osr_tpu_torch.testing import harvest_chunks

    t0 = time.perf_counter()
    chunks = harvest_chunks(roots, max_chunks)
    log(f"harvested {len(chunks)} chunks from {list(roots)} in "
        f"{time.perf_counter() - t0:.1f}s")
    return chunks


def below_floor(chunks: Sequence[str], metric: str = METRIC) -> Optional[int]:
    """The refusal below MIN_CHUNKS: prints the JSON line with no value
    and the reason and returns 1; None at or above the floor."""
    if len(chunks) >= MIN_CHUNKS:
        return None
    print(json.dumps({
        "metric": metric, "value": None, "num_docs": len(chunks),
        "error": f"only {len(chunks)} chunks harvested; need >="
        f"{MIN_CHUNKS} for the at-scale claim",
    }), flush=True)
    return 1


def add_harvest_options(ap: argparse.ArgumentParser) -> None:
    """The harvest's options, shared with fusion-sweep."""
    ap.add_argument("--max-chunks", type=int, default=100_000)
    ap.add_argument("--num-queries", type=int, default=512)
    ap.add_argument(
        "--roots", nargs="+", default=None,
        help="directories harvested for prose (default: this "
        "interpreter's stdlib and site-packages)",
    )
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain head step; smoke runs)")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench quality-at-scale",
        description=__doc__.splitlines()[0],
    )
    add_harvest_options(ap)
    ap.add_argument("--skip-reference", action="store_true",
                    help="accepted; the reference leg is not ported")
    ap.add_argument(
        "--f32-control", action="store_true",
        help="also run the engine with an f32 (unquantized) head",
    )
    ap.add_argument(
        "--dense-hashing", action="store_true",
        help="also run the HashingEncoder dense and hybrid legs",
    )
    ap.add_argument("--query-mode", default="quote", choices=QUERY_MODES)
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        return no_card(METRIC)
    roots = args.roots or prose_roots()
    chunks = harvest(args.max_chunks, roots)
    refused = below_floor(chunks)
    if refused:
        return refused
    run(
        chunks, num_queries=args.num_queries, query_mode=args.query_mode,
        dense_hashing=args.dense_hashing, f32_control=args.f32_control,
        roots=roots, device="cpu" if args.cpu else None,
    )
    return 0
