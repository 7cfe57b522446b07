"""Dense retrieval through a real transformer forward, on the CUDA card
(counterpart of ``tools/bench_dense_encoder.py``).

``HFEncoder`` over a seeded stand-in BERT (``testing.build_standin_encoder``:
4 layers, hidden 256, 4 heads, weights drawn from a ``torch.Generator``
seeded with 0, a WordPiece vocabulary of the five specials and the sorted
corpus terms; max_length 128, batches of 128) encodes a seeded Zipf
corpus and self-retrieval queries (about 8 words of one source document
each, ``RandomState(7)``; the source is the one relevant document). The
embeddings then go through five ``DenseSearchEngine`` legs: f32,
symmetric int8, asymmetric uint8, int4 and int4 with 128-column groups,
each scored with ``metrics/ir.py``, plus the int8 leg's agreement with
f32 (P@k overlap and Spearman over shared results).

The symmetric leg takes K7 + K5 and the int4 leg K7 + K6 on the card (the
script ran every leg on XLA); the other three run plain torch products,
as ``osr_tpu`` computes them in XLA. ``dense_backends`` says which leg
took which. On the card the two kernel legs must equal engines on
``backend="torch"`` bit for bit. No pretrained weights are involved: the
weights are the port's own seeded draw, not Flax's initialisation, so the
quality numbers are the stand-in's, not the JAX script's. Prints one JSON
object; ``--out PATH`` also writes it to PATH.

Usage: python -m osr_tpu_torch.bench dense-encoder [--docs 4000]
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

METRIC = "dense_encoder_quality"
# The legs: (output key, quantization, the kernels it takes on the card).
LEGS = (
    ("fp32", "none", ()),
    ("int8_symmetric", "symmetric", ("quantize_symmetric", "int8_similarity")),
    ("uint8_asymmetric", "asymmetric", ()),
    ("int4_symmetric", "int4", ("quantize_symmetric", "int4_similarity")),
    ("int4_grouped128", "int4_grouped", ()),
)
QPS_KEYS = {
    "fp32": "qps_fp32", "int8_symmetric": "qps_int8",
    "int4_symmetric": "qps_int4", "int4_grouped128": "qps_int4_grouped",
}
NOTE = (
    "DETERMINISTIC STAND-IN encoder (random-weight tiny BERT; the port's "
    "own draw from a torch.Generator seeded with 0, not Flax's init): no "
    "pretrained weights are obtainable offline. Self-retrieval qrels make "
    "recall a real signal; swap in a real checkpoint via "
    "HFEncoder('facebook/contriever') for semantic quality."
)


def workload(docs: int, vocab: int, num_queries: int):
    """The script's corpus (seed 42, about 60 words a document) and its
    self-retrieval queries and qrels (RandomState(7))."""
    from osr_tpu_torch.testing import SyntheticDataGenerator

    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(
        docs, vocab, avg_len=60, word_prefix="t", min_len=10
    )
    doc_ids = list(corpus.keys())
    texts = [corpus[d]["text"] for d in doc_ids]
    rng = np.random.RandomState(7)
    queries, qrels = {}, {}
    for qi in range(num_queries):
        src = int(rng.randint(len(doc_ids)))
        words = texts[src].split()
        picks = rng.choice(len(words), size=min(8, len(words)), replace=False)
        queries[f"q{qi}"] = " ".join(words[p] for p in sorted(picks))
        qrels[f"q{qi}"] = {doc_ids[src]: 1}
    return doc_ids, texts, queries, qrels


def agreement(fp32_res, int8_res) -> Tuple[float, float]:
    """The int8 leg against f32: mean P@k overlap, and mean Spearman over
    the shared documents of queries sharing at least 3."""
    from osr_tpu_torch.testing import spearman_correlation

    overlaps, spearmans = [], []
    for qid, a in fp32_res.items():
        b = int8_res[qid]
        if not a or not b:
            continue
        overlaps.append(len(set(a) & set(b)) / max(len(a), len(b)))
        shared = [d for d in a if d in b]
        if len(shared) >= 3:
            spearmans.append(spearman_correlation(
                [a[d] for d in shared], [b[d] for d in shared]
            ))
    return float(np.mean(overlaps)), float(np.mean(spearmans))


def run_legs(doc_ids, doc_emb, qvecs, top_k: int, dev):
    """Each leg's results, warm QPS, backend and launches. On the card the
    kernel legs must take the kernels and equal ``backend='torch'``
    engines bit for bit."""
    from osr_tpu_torch.retrieval.engine import DenseSearchEngine

    out = {}
    for key, quantization, kernels in LEGS:
        reset_all_launches()
        eng = DenseSearchEngine(doc_ids, doc_emb, quantization=quantization,
                                device=dev)
        res = eng.search(qvecs, top_k=top_k, min_score=-1e30)
        t0 = time.perf_counter()
        eng.search(qvecs, top_k=top_k, min_score=-1e30)
        qps = len(qvecs) / (time.perf_counter() - t0)
        launches = launched()
        if dev.type == "cuda" and kernels:
            missing = [k for k in kernels if not launches.get(k)]
            if eng.backend != "cuda" or missing:
                raise RuntimeError(f"{key}: backend {eng.backend!r}, "
                                   f"launched no {missing} ({launches})")
            plain = DenseSearchEngine(doc_ids, doc_emb,
                                      quantization=quantization, device=dev,
                                      backend="torch")
            want = plain.search(qvecs, top_k=top_k, min_score=-1e30)
            if [list(r.items()) for r in res.values()] != [
                list(r.items()) for r in want.values()
            ]:
                raise RuntimeError(f"{key}: the kernel route's results "
                                   "differ from backend='torch'")
            del plain
        out[key] = (res, qps, eng.backend, launches)
        del eng
    return out


def run(
    *,
    docs: int = 4000,
    vocab: int = 8000,
    num_queries: int = 256,
    top_k: int = 10,
    dtype: str = "bfloat16",
    device=None,
    encoder=None,
    out: Optional[str] = None,
) -> Dict[str, object]:
    """Encode, search each leg, score; the object is printed (and written
    to ``out``) and returned. ``encoder`` replaces the stand-in (the tests
    pass one over converted Flax weights); the tests pass
    ``device="cpu"`` and small sizes."""
    from osr_tpu_torch.metrics.ir import evaluate_retrieval
    from osr_tpu_torch.testing import build_standin_encoder

    dev = resolve_device(device)
    doc_ids, texts, queries, qrels = workload(docs, vocab, num_queries)
    if encoder is None:
        terms = sorted({w for t in texts for w in t.split()})
        encoder = build_standin_encoder(terms, dtype=dtype, device=dev)
    t0 = time.perf_counter()
    encoder.encode(texts[: encoder.batch_size])  # first calls
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    doc_emb = encoder.encode(texts)
    encode_s = time.perf_counter() - t0
    q_emb = encoder.encode(list(queries.values()))
    log(f"encoded {len(texts)} docs ({doc_emb.shape}) in {encode_s:.1f}s "
        f"(+{warmup_s:.1f}s first calls) via {encoder.backend} on {dev}")
    qvecs = {qid: q_emb[i] for i, qid in enumerate(queries)}
    legs = run_legs(doc_ids, doc_emb, qvecs, top_k, dev)

    def quality(res):
        m = evaluate_retrieval(res, qrels, k_values=(top_k,))
        return {k: round(v, 4) for k, v in m.items()}

    overlap, spearman = agreement(legs["fp32"][0], legs["int8_symmetric"][0])
    total: Dict[str, int] = {}
    for _, _, _, launches in legs.values():
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    result = {
        "encoder": encoder.model_name,
        "encoder_backend": encoder.backend,
        "note": NOTE,
        "num_docs": len(doc_ids),
        "num_queries": len(qvecs),
        "dim": int(doc_emb.shape[1]),
        "compute_dtype": dtype,
        "encode_warmup_s": round(warmup_s, 1),
        "encode_docs_s": round(encode_s, 1),
        "encode_docs_per_s": round(len(texts) / encode_s, 1),
        **{key: quality(legs[key][0]) for key, _, _ in LEGS},
        "int8_vs_fp32_p_at_k_overlap": round(overlap, 4),
        "int8_vs_fp32_spearman": round(spearman, 4),
        **{q: round(legs[key][1], 1) for key, q in QPS_KEYS.items()},
        "top_k": top_k,
        "dense_backends": {key: legs[key][2] for key, _, _ in LEGS},
        "kernel_route_equals_plain": True if dev.type == "cuda" else None,
        "kernel_launches": total,
        "device": device_name(dev),
    }
    print(json.dumps(result), flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(result, indent=1))
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench dense-encoder",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, default=4000)
    ap.add_argument("--vocab", type=int, default=8000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"),
                    help="the encoder's compute dtype")
    ap.add_argument("--out", default=None,
                    help="also write the object to this file")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain products; smoke runs)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        return no_card(METRIC)
    run(docs=args.docs, vocab=args.vocab, num_queries=args.queries,
        top_k=args.topk, dtype=args.dtype,
        device="cpu" if args.cpu else None, out=args.out)
    return 0
