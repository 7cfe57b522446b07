"""Each stage of one sparse batch at corpus scale on the CUDA card, from a
saved index (counterpart of ``tools/profile_stages_1m.py``).

Loads an index written by ``python -m osr_tpu_torch.bench scaling --docs
N --save-index DIR`` (``tools/bench_scaling.py``'s dump layout, so the
JAX script reads the same directory), builds one ``SparseSearchEngine``
at ``batch_sizes=(--batch,)``, exact top-k, no query cache, warms it on
the first batch of the seed-42 queries, then times each stage of that
batch once, one after another, with the script's names (milliseconds):

- ``encode_ms``: ``encode_queries``;
- ``tail_walk_ms``: the tail postings walk (``_tail_candidates``);
  ``cand_total`` and ``cand_per_query`` count its candidates;
- ``cand_head_dot_ms``: the candidates' head dots on the engine's host
  head view (int4 heads unpacked once to the codes the card multiplies);
- ``dispatch_ms``: ``search_encoded_device``. As in the script it
  includes the host prework again (the tail walk, and the head dots
  unless the candidate filter defers them), besides the upload, the
  device step and the start of its result copy;
- ``device_fetch_ms``: the wait for that result: the rest of the device
  step and the copy of its (top, rows), int32 rows and f32 scores, into
  pinned host memory. The script fetched one packed f32 array;
- ``merge_ms``: ``merge_host`` over all the walked candidates;
- ``search_e2e_ms`` and ``qps``: the better of two ``engine.search``
  calls over the batch, pipelined as a user's search runs.

Every time is rounded to 4 decimals (the script rounded to 1);
``cand_per_query`` keeps the script's one decimal. The row adds
``kernel_launches`` (K2 on an int8 head, K3 on an int4 one, over the
timed stages and the two searches), ``score_chunks`` and ``device``.
Prints JSON as its last line (the script printed a Python dict).

Usage: python -m osr_tpu_torch.bench profile-stages-1m --load-index DIR
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import torch

from osr_tpu_torch.bench.common import (
    device_name,
    launched,
    log,
    no_card,
    reset_all_launches,
    rounded,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "sparse_stage_ms_at_scale"
KEYS = (
    "metric", "num_docs", "head_dtype", "batch", "top_k", "score_chunks",
    "encode_ms", "tail_walk_ms", "cand_total", "cand_per_query",
    "cand_head_dot_ms", "dispatch_ms", "device_fetch_ms", "merge_ms",
    "search_e2e_ms", "qps", "kernel_launches", "device",
)


def run(
    load_index: str,
    *,
    batch: int = 2048,
    queries: int = 2048,
    topk: int = 50,
    vocab: int = 400_000,
    device=None,
) -> Dict[str, object]:
    """The row. The tests pass ``device="cpu"`` and a small dump."""
    from osr_tpu_torch.bench.scaling import load_index as load
    from osr_tpu_torch.index.postings import merge_host, merge_tau_slack
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine
    from osr_tpu_torch.testing import SyntheticDataGenerator

    dev = resolve_device(device)
    log(f"device: {device_name(dev)}")
    index, _ = load(load_index)
    layout = index.layout
    log(f"loaded: {index.num_docs} docs, F={layout.head_terms}, "
        f"{layout.head_dtype} head")
    pool = SyntheticDataGenerator(seed=42).queries(
        queries, vocab, avg_terms=11, word_prefix="t", min_terms=2
    )
    sub = dict(list(pool.items())[:batch])
    texts = list(sub.values())
    engine = SparseSearchEngine(
        index, device=dev, batch_sizes=(batch,), cache_queries=False,
        topk_mode="exact",
    )
    if dev.type == "cuda" and engine.head_backend != "cuda":
        raise RuntimeError(f"the engine's head step is "
                           f"{engine.head_backend!r}, not the kernel")
    chunks = engine.stats().get("score_chunks", 0)
    log(f"chunks: {chunks}")
    engine.search(sub, top_k=topk)
    reset_all_launches()

    def t(f):
        t0 = time.perf_counter()
        out = f()
        return out, (time.perf_counter() - t0) * 1e3

    stats: Dict[str, object] = {}
    enc, stats["encode_ms"] = t(lambda: engine.encode_queries(texts))
    cand, stats["tail_walk_ms"] = t(
        lambda: engine._tail_candidates(enc, enc.head_ids.shape[0])
    )
    stats["cand_total"] = int(cand.total)
    stats["cand_per_query"] = round(cand.total / len(texts), 1)
    cand_head, stats["cand_head_dot_ms"] = t(
        lambda: engine._cand_head_host(cand, enc)
    )
    handle, stats["dispatch_ms"] = t(
        lambda: engine.search_encoded_device(enc, topk)
    )
    arrays, stats["device_fetch_ms"] = t(lambda: handle[1].wait())
    hs, hr = arrays[0], arrays[1]
    _, stats["merge_ms"] = t(
        lambda: merge_host(
            hs, hr, cand, cand_head, engine._dev.num_rows, topk,
            tau_slack=merge_tau_slack(
                engine._slack_per_term, enc.head_flat_ids,
                enc.head_flat_counts, enc.head_ptr,
            ),
        )
    )
    best = float("inf")
    for _ in range(2):
        _, ms = t(lambda: engine.search(sub, top_k=topk))
        best = min(best, ms)
    stats["search_e2e_ms"] = best
    stats["qps"] = len(sub) / best * 1e3
    launches = launched()
    for k, v in stats.items():
        if isinstance(v, float) and k != "cand_per_query":
            stats[k] = rounded(v)
    log("stages: " + ", ".join(f"{k} {v}" for k, v in stats.items()))
    return {
        "metric": METRIC,
        "num_docs": index.num_docs,
        "head_dtype": layout.head_dtype,
        "batch": batch,
        "top_k": topk,
        "score_chunks": chunks,
        **stats,
        "kernel_launches": launches,
        "device": device_name(dev),
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench profile-stages-1m",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--load-index", required=True)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--topk", type=int, default=50)
    ap.add_argument("--vocab", type=int, default=400_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    row = run(args.load_index, batch=args.batch, queries=args.queries,
              topk=args.topk, vocab=args.vocab)
    print(json.dumps(row), flush=True)
    return 0
