"""One hybrid (sparse + dense) search batch stage by stage on the CUDA card
(counterpart of ``tools/profile_hybrid.py``).

The hybrid retriever of ``RetrieverRegistry`` (sparse 0.3, dense 0.7,
``--fusion``, fusion depth ``--depth``) over ``bench.py``'s corpus
(seed 42) and the first 512 of its queries (seed 6), warmed once. Each of
8 repetitions takes the batch through the stages of
``HybridRetriever.search`` one after another, with the script's names:

- ``embed``: the dense query embedding (host);
- ``d_dispatch``: the dense step's launch (K7, K5, selection) and the
  start of its result copy;
- ``s_encode``: the sparse tokenize and pad (host);
- ``s_dispatch``: ``search_encoded_device``: the tail walk, the upload,
  the sparse step's launch (K2, selection) and the candidates' head dots
  (unless the candidate filter defers them);
- ``s_fetch``: the wait for the sparse result in pinned host memory. The
  script split ``osr_tpu``'s handle around its packed f32 transfer; the
  port's handle carries int32 rows and f32 scores, and this splits it;
- ``s_merge``: ``finish_batch`` on the fetched result: the exact host
  merge, with the deferred tau filter and head dots where they apply;
- ``d_collect``: the wait for the dense result;
- ``fuse``: ``fuse_topk_arrays``; ``assemble``: the result dicts.

Then ``sparse_dev_total`` and ``dense_dev_total``, as the script took
them: each leg's launch and wait again (host wall; the sparse one
includes its encode and host prework). ``ms_per_batch`` holds those
eleven, ``host_serial_ms`` the sum of the first nine, ``serial_wall_ms``
the wall around them (their sum is at most it). ``device_step_event_ms``
is new: ``sparse_dev``, ``SparseSearchEngine.device_step`` alone, and
``dense_dev``, the dense engine's kernel step alone, each the median of
10 timed with CUDA events (null on the CPU). The row adds
``kernel_launches`` (K2, K7, K5 over the repetitions) and ``device``.
The script appended its row to ``bench_results/hybrid_stages.jsonl``;
this writes a file only with ``--out PATH`` (it appends the row there).

Usage: python -m osr_tpu_torch.bench profile-hybrid [--fusion rrf]
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
    NUM_DOCS,
    TOP_K,
    VOCAB,
    device_name,
    launched,
    log,
    make_corpus,
    make_queries,
    median_ms,
    no_card,
    reset_all_launches,
    rounded,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "hybrid_stage_decomposition"
DEPTH = 100
BATCH = 512
REPS = 8
HOST_STAGES = (
    "embed", "d_dispatch", "s_encode", "s_dispatch", "s_fetch", "s_merge",
    "d_collect", "fuse", "assemble",
)
DEVICE_WALLS = ("sparse_dev_total", "dense_dev_total")
KEYS = (
    "metric", "fusion", "batch", "depth", "top_k", "num_docs",
    "ms_per_batch", "host_serial_ms", "serial_wall_ms",
    "device_step_event_ms", "kernel_launches", "device",
)


def run(
    fusion: str = "rrf",
    *,
    depth: int = DEPTH,
    num_docs: int = NUM_DOCS,
    vocab: int = VOCAB,
    batch: int = BATCH,
    reps: int = REPS,
    device=None,
) -> Tuple[Dict[str, object], Dict[str, Dict[str, float]]]:
    """The row and, by query id, the results the composed stages gave in
    the last repetition. The tests pass ``device="cpu"`` and small
    sizes."""
    from osr_tpu_torch.retrieval.fusion import (
        fuse_topk_arrays,
        fused_rows_to_results,
    )
    from osr_tpu_torch.retrieval.registry import RetrieverRegistry

    dev = resolve_device(device)
    log(f"device: {device_name(dev)}")
    corpus = make_corpus(num_docs, vocab)
    queries = make_queries(batch * 2, vocab)
    retr = RetrieverRegistry.create({
        "type": "hybrid",
        "params": {
            "sparse_weight": 0.3,
            "dense_weight": 0.7,
            "fusion_depth": depth,
            "fusion": fusion,
            "cache_dir": None,
            "device": dev,
        },
    })
    retr.build_index_from_corpus(corpus)
    del corpus
    sp, de = retr.sparse.engine, retr.dense.engine
    if dev.type == "cuda" and (sp.head_backend != "cuda"
                               or de.backend != "cuda"):
        raise RuntimeError("the hybrid's legs do not take the CUDA kernels")
    qitems = list(queries.items())[:batch]
    texts = [t for _, t in qitems]
    qids = [q for q, _ in qitems]
    retr.search(dict(qitems), top_k=TOP_K)  # first calls
    reset_all_launches()

    acc = dict.fromkeys(HOST_STAGES + DEVICE_WALLS, 0.0)
    wall = 0.0
    doc_ids = sp._doc_names
    results: Dict[str, Dict[str, float]] = {}
    for _ in range(reps):
        t_all = t = time.perf_counter()

        def tick(name):
            nonlocal t
            now = time.perf_counter()
            acc[name] += now - t
            t = now

        vecs = retr.dense.embed_queries(texts)
        tick("embed")
        d_handle = de.dispatch_vectors(vecs, depth)
        tick("d_dispatch")
        enc = sp.encode_queries(texts)
        tick("s_encode")
        s_handle = sp.search_encoded_device(enc, depth)
        tick("s_dispatch")
        s_handle[1].wait()
        tick("s_fetch")
        # finish_batch waits again, on a result already in host memory.
        s_scores, s_ids = sp.finish_batch(s_handle, depth)
        tick("s_merge")
        d_scores, d_ids = de.collect_vectors(d_handle)
        tick("d_collect")
        n = len(texts)
        f_sc, f_ids = fuse_topk_arrays(
            s_scores[:n], s_ids[:n], d_scores, d_ids, retr.sparse_weight,
            retr.dense_weight, TOP_K, mode=retr.fusion, rrf_k=retr.rrf_k,
        )
        tick("fuse")
        results = fused_rows_to_results(qids, f_sc, f_ids, doc_ids)
        tick("assemble")
        wall += time.perf_counter() - t_all

    for _ in range(reps):
        t0 = time.perf_counter()
        h = sp.search_encoded_device(sp.encode_queries(texts), depth)
        h[1].wait()
        acc["sparse_dev_total"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        de.dispatch_vectors(vecs, depth)[0].wait()
        acc["dense_dev_total"] += time.perf_counter() - t0
    launches = launched()

    # Each leg's device step alone, CUDA events around it.
    ids, w = sp._upload(enc.head_ids), sp._upload(enc.head_weights)
    q = torch.from_numpy(np.asarray(vecs, dtype=np.float32)).to(dev)
    parts = de._chunks or [(de._docs, de._scales, de._mins, 0)]
    events = dict.fromkeys(("sparse_dev", "dense_dev"))
    if dev.type == "cuda":
        events["sparse_dev"] = rounded(median_ms(
            lambda: sp.device_step(ids, w, depth), reps=10))
        events["dense_dev"] = rounded(median_ms(
            lambda: [de._step(q, d, s, m, depth) for d, s, m, _ in parts],
            reps=10))

    ms = {k: v / reps * 1e3 for k, v in acc.items()}
    log(f"hybrid batch stages (B={batch}, depth={depth}, {reps} reps), "
        "ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; device steps (CUDA events) {events}")
    row = {
        "metric": METRIC,
        "fusion": fusion,
        "batch": batch,
        "depth": depth,
        "top_k": TOP_K,
        "num_docs": num_docs,
        "ms_per_batch": {k: rounded(v) for k, v in ms.items()},
        "host_serial_ms": rounded(sum(ms[k] for k in HOST_STAGES)),
        "serial_wall_ms": rounded(wall / reps * 1e3),
        "device_step_event_ms": events,
        "kernel_launches": launches,
        "device": device_name(dev),
    }
    return row, results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench profile-hybrid",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--fusion", choices=("weighted", "rrf"), default="rrf")
    ap.add_argument("--depth", type=int, default=DEPTH)
    ap.add_argument("--out", default=None,
                    help="also append the row to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    row, _ = run(args.fusion, depth=args.depth)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    return 0
