"""Dense retrieval at corpus scale on the CUDA card, int8 against int4
(counterpart of ``tools/bench_dense_scale.py``).

Clustered unit-norm embeddings (seeded, drawn in chunks of 250,000
rows) are quantized on the host (``ops/quantize.py``'s NumPy twins) and
handed to ``DenseSearchEngine.from_quantized``, so only packed bytes
travel to the card. Each search quantizes its query batch with K7 and
scores it with K5 (symmetric) or K6 (int4). The (B, N) f32 similarity
lives on the card, so the batch bounds device memory: B=1,024 at 1M docs
is 4 GiB of scores. Prints one JSON row per mode.

Usage: python -m osr_tpu_torch.bench dense-scale [--docs 1000000]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

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

METRIC = "dense_qps_at_scale"
GEN_CHUNK = 250_000


def corpus_embeddings(docs: int, dim: int) -> np.ndarray:
    """``tools/bench_dense_scale.py``'s corpus: chunk i of 250,000 rows
    drawn with seed 42 + i."""
    from osr_tpu_torch.index.dense import synthetic_corpus_embeddings

    parts = [
        synthetic_corpus_embeddings(
            min(GEN_CHUNK, docs - i), dim=dim, seed=42 + i // GEN_CHUNK
        )
        for i in range(0, docs, GEN_CHUNK)
    ]
    return np.concatenate(parts) if len(parts) > 1 else parts[0]


def run(
    *,
    docs: int = 1_000_000,
    dim: int = 768,
    batch: int = 1024,
    topk: int = 50,
    passes: int = 5,
    modes: Sequence[str] = ("symmetric", "int4"),
    backend: str = "cuda",
    score_chunk_rows: Optional[int] = None,
    device=None,
    out: Optional[str] = None,
) -> List[Dict[str, object]]:
    """One row per quantization mode, each printed (and appended to
    ``out``) as it is measured. The tests pass ``device="cpu"``,
    ``backend="torch"`` and small sizes."""
    from osr_tpu_torch.ops import quantize as qz
    from osr_tpu_torch.retrieval.engine import DenseSearchEngine

    dev = resolve_device(device)
    t0 = time.perf_counter()
    emb = corpus_embeddings(docs, dim)
    log(f"generated {emb.shape} in {time.perf_counter() - t0:.1f}s")
    queries = emb[:batch].copy()
    doc_ids = [str(i) for i in range(docs)]
    quantizers = {
        "symmetric": qz.quantize_symmetric_np,
        "int4": qz.quantize_symmetric_int4_np,
    }
    rows = []
    for mode in modes:
        if mode not in quantizers:
            raise ValueError(f"unsupported mode {mode!r}")
        t0 = time.perf_counter()
        packed, scales = quantizers[mode](emb)
        quant_s = time.perf_counter() - t0
        packed_mb = (packed.nbytes + scales.nbytes) / 2**20

        t0 = time.perf_counter()
        eng = DenseSearchEngine.from_quantized(
            doc_ids, packed, scales, quantization=mode, device=dev,
            backend=backend, score_chunk_rows=score_chunk_rows,
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        upload_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        s, _ = eng.search_vectors(queries, top_k=topk)
        warmup_s = time.perf_counter() - t0
        if s.shape != (min(batch, docs), min(topk, docs)):
            raise RuntimeError(f"{mode}: scores of shape {s.shape}")
        qps_passes = []
        reset_all_launches()
        for _ in range(passes):
            t0 = time.perf_counter()
            eng.search_vectors(queries, top_k=topk)
            qps_passes.append(
                round(len(queries) / (time.perf_counter() - t0), 1)
            )
        row = {
            "metric": METRIC,
            "num_docs": docs,
            "dim": dim,
            "quantization": mode,
            "backend": backend,
            "batch": batch,
            "score_chunk_rows": score_chunk_rows,
            "top_k": topk,
            "packed_corpus_mb": round(packed_mb, 1),
            "host_quantize_s": round(quant_s, 2),
            "upload_s": round(upload_s, 2),
            "warmup_s": round(warmup_s, 2),
            "qps": float(np.median(qps_passes)),
            "qps_passes": qps_passes,
            "kernel_launches": launched(),
            "device": device_name(dev),
        }
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        rows.append(row)
        del eng, packed
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench dense-scale",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--topk", type=int, default=50)
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--modes", default="symmetric,int4",
                    help="comma list of quantization modes to measure")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"),
                    help="'cuda' = K7 + K5/K6; 'torch' = the plain products")
    ap.add_argument("--score-chunk-rows", type=int, default=None,
                    help="row-chunked scoring: bounds the (B, N) f32 "
                    "similarity on the card")
    ap.add_argument("--out", default=None,
                    help="also append the rows to this file")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (with --backend torch; smoke runs)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        return no_card(METRIC)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    run(
        docs=args.docs, dim=args.dim, batch=args.batch, topk=args.topk,
        passes=args.passes, modes=args.modes.split(","),
        backend=args.backend, score_chunk_rows=args.score_chunk_rows,
        device="cpu" if args.cpu else None, out=args.out,
    )
    return 0
