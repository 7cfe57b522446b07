"""Corpus-size scaling on the CUDA card (counterpart of
``tools/bench_scaling.py``): one corpus size per run.

Builds (or loads) a BM25 index over ``--docs`` Zipf documents, uploads it
to one engine at ``--batch`` and prints one JSON row: build time, index
memory, head sizing, upload and warmup seconds, QPS (best of 2 passes)
and per-query latency, plus the kernels launched in one pass (K2, K3 or
K4: the plan the engine took) and the device memory peak above the
uploaded index. ``--out PATH`` also appends the row to PATH.

Usage: python -m osr_tpu_torch.bench scaling --docs 1000000
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from osr_tpu_torch.bench.common import (
    device_name,
    launched,
    log,
    no_card,
    reset_all_launches,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "bm25_qps_at_scale"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench scaling",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, required=True)
    ap.add_argument("--vocab", type=int, default=None,
                    help="vocabulary size (default min(4 x docs, 400,000))")
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--topk", type=int, default=50)
    ap.add_argument("--out", default=None,
                    help="also append the row to this file")
    ap.add_argument("--save-index",
                    help="build, write the index arrays to DIR, exit")
    ap.add_argument("--load-index",
                    help="skip generation and build; load the index from DIR")
    ap.add_argument("--head-cap", type=int, default=None,
                    help="head-width cap (with --head-budget-gib): trades "
                    "device memory for host tail work")
    ap.add_argument("--head-dtype", default="int8",
                    choices=("int8", "int4", "bf16", "f32"),
                    help="head quantization (int4 halves the head's bytes)")
    ap.add_argument("--note", default=None,
                    help="free-text label recorded in the row")
    ap.add_argument("--head-budget-gib", type=float, default=8.0,
                    help="head byte budget used with --head-cap")
    ap.add_argument("--score-chunk-rows", type=int, default=None,
                    help="rows a score chunk (default: sized from the "
                    "card's free memory; 0 = one sweep)")
    ap.add_argument("--narrow-m", type=int, default=0,
                    help="per-block top-m of the extraction plan (0 = off)")
    ap.add_argument("--narrow-backend", default="torch",
                    choices=("torch", "extract"),
                    help="'extract' = the per-block top-m kernel K4")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain head step; smoke runs)")
    return ap


def build_index(docs: int, vocab: int, head_dtype: str = "int8",
                head_cap: Optional[int] = None,
                head_budget_gib: float = 8.0):
    """(index, build seconds) over ``tools/bench_scaling.py``'s corpus:
    Zipf documents from the seed-42 generator."""
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.testing import SyntheticDataGenerator

    gen = SyntheticDataGenerator(seed=42)
    t0 = time.perf_counter()
    corpus = gen.zipf_corpus(docs, vocab, avg_len=130, word_prefix="t",
                             min_len=5)
    log(f"generated in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    kw = {"head_dtype": head_dtype}
    if head_cap:
        kw.update(head_cap=head_cap,
                  head_budget_bytes=int(head_budget_gib * (1 << 30)))
    index = SparseIndexBuilder(method="bm25", **kw).build(corpus)
    build_s = time.perf_counter() - t0
    log(f"built in {build_s:.1f}s")
    return index, build_s


def save_index(index, build_s: float, path) -> None:
    """The index's arrays as .npy files, its vocabulary and metadata as
    JSON, in ``tools/bench_scaling.py``'s layout."""
    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    lay = index.layout
    arrays = {
        "head": lay.head, "head_scales": lay.head_scales,
        "post_ptr": lay.post_ptr, "post_rows": lay.post_rows,
        "post_weights": lay.post_weights, "valid": lay.valid,
        "idf": index.idf, "doc_lengths": index.doc_lengths,
    }
    for name, arr in arrays.items():
        if arr is not None:
            np.save(d / f"{name}.npy", arr, allow_pickle=False)
    terms = [""] * index.vocab_size
    for t, i in index.vocabulary.items():
        terms[i] = t
    (d / "vocab.json").write_text(json.dumps(terms))
    (d / "meta.json").write_text(json.dumps({
        "head_terms": lay.head_terms, "head_dtype": lay.head_dtype,
        "num_docs": lay.num_docs, "vocab_size": lay.vocab_size,
        "avgdl": index.avgdl, "build_s": build_s,
    }))


def load_index(path) -> Tuple[object, float]:
    """(index, the build seconds recorded beside it) from
    :func:`save_index`'s files."""
    from osr_tpu_torch.index.builder import SparseIndex
    from osr_tpu_torch.index.layout import HybridLayout

    d = Path(path)
    meta = json.loads((d / "meta.json").read_text())
    terms = json.loads((d / "vocab.json").read_text())

    def ld(name):
        return np.load(d / f"{name}.npy", allow_pickle=False)

    layout = HybridLayout(
        head_terms=meta["head_terms"],
        head=ld("head"),
        head_scales=(
            ld("head_scales") if meta["head_dtype"] in ("int8", "int4")
            else None
        ),
        post_ptr=ld("post_ptr"),
        post_rows=ld("post_rows"),
        post_weights=ld("post_weights"),
        valid=ld("valid"),
        num_docs=meta["num_docs"],
        vocab_size=meta["vocab_size"],
        head_dtype=meta["head_dtype"],
    )
    index = SparseIndex(
        method="bm25",
        vocabulary={t: i for i, t in enumerate(terms)},
        doc_ids=[str(i) for i in range(meta["num_docs"])],
        layout=layout,
        idf=ld("idf"),
        doc_lengths=ld("doc_lengths"),
        avgdl=meta["avgdl"],
        k1=1.2,
        b=0.75,
    )
    return index, meta["build_s"]


def measure(
    index,
    build_s: float,
    queries: Dict[str, str],
    *,
    device=None,
    batch: int = 2048,
    topk: int = 50,
    score_chunk_rows: Optional[int] = None,
    narrow_m: int = 0,
    narrow_backend: str = "torch",
    note: Optional[str] = None,
) -> Dict[str, object]:
    """Upload ``index`` to one engine, warm it, time 2 passes of
    ``queries`` and return the row."""
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    stats = index.stats()
    log(f"stats: {stats}")

    t0 = time.perf_counter()
    engine = SparseSearchEngine(
        index, device=dev, batch_sizes=(batch,), cache_queries=False,
        topk_mode="exact", score_chunk_rows=score_chunk_rows,
        narrow_m=narrow_m, narrow_backend=narrow_backend,
    )
    if on_card:
        torch.cuda.synchronize(dev)
        if engine.head_backend != "cuda" and stats["head_dtype"] in (
            "int8", "int4"
        ):
            raise RuntimeError(
                f"the engine takes head_backend={engine.head_backend!r}, "
                "not the CUDA kernels"
            )
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    upload_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = engine.search(queries, top_k=topk)
    warm_s = time.perf_counter() - t0
    qps = 0.0
    for _ in range(2):
        reset_all_launches()
        t0 = time.perf_counter()
        res = engine.search(queries, top_k=topk)
        qps = max(qps, len(queries) / (time.perf_counter() - t0))
    launches = launched()  # the last pass's
    peak_mb = (
        round((torch.cuda.max_memory_allocated(dev) - base) / 2**20, 1)
        if on_card else None
    )

    row = {
        "metric": METRIC,
        "num_docs": index.num_docs,
        "vocab_size": stats["vocab_size"],
        "head_terms": stats["head_terms"],
        "head_dtype": stats["head_dtype"],
        "head_mb": round(stats["head_mb"], 1),
        "postings_mb": round(stats["postings_mb"], 1),
        "index_memory_mb": round(stats["memory_mb"], 1),
        "max_tail_df": stats["max_tail_df"],
        "tail_nnz": stats["tail_nnz"],
        "build_s": round(build_s, 2),
        "upload_s": round(upload_s, 2),
        "warmup_s": round(warm_s, 2),
        "qps_exact": round(qps, 1),
        "ms_per_query": round(1000.0 / qps, 4) if qps else None,
        "num_queries": len(queries),
        "batch": batch,
        "top_k": topk,
        "nonempty": sum(1 for r in res.values() if r),
        "score_chunks": engine.stats().get("score_chunks", 0),
        "kernel_launches": launches,
        "device_peak_above_index_mb": peak_mb,
        "device": device_name(dev),
    }
    if note:
        row["note"] = note
    if narrow_m:
        row["narrow_m"] = narrow_m
        row["narrow_backend"] = narrow_backend
    return row


def main(argv: Optional[List[str]] = None) -> int:
    from osr_tpu_torch.testing import SyntheticDataGenerator

    args = parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        return no_card(METRIC)
    device = "cpu" if args.cpu else None
    vocab = args.vocab or min(4 * args.docs, 400_000)
    log(f"device: {device_name(resolve_device(device))}")
    queries = SyntheticDataGenerator(seed=42).queries(
        args.queries, vocab, avg_terms=11, word_prefix="t", min_terms=2
    )
    if args.load_index:
        index, build_s = load_index(args.load_index)
        log(f"loaded index from {args.load_index}")
    else:
        index, build_s = build_index(
            args.docs, vocab, args.head_dtype, args.head_cap,
            args.head_budget_gib,
        )
    if args.save_index:
        save_index(index, build_s, args.save_index)
        log(f"index saved to {args.save_index}")
        return 0
    row = measure(
        index, build_s, queries, device=device, batch=args.batch,
        topk=args.topk, score_chunk_rows=args.score_chunk_rows,
        narrow_m=args.narrow_m, narrow_backend=args.narrow_backend,
        note=args.note,
    )
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    return 0
