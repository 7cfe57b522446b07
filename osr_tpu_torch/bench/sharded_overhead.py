"""What the sharded program costs end to end on one CUDA card
(counterpart of ``tools/bench_sharded_tpu.py``).

The script runs its sharded engine on a one-device TPU mesh and records
the ``shard_map`` program's QPS overhead against the flat engine at FiQA
scale. Here the mesh is a world of one rank under NCCL, mesh (1, 1),
which the mode initialises itself (a ``file://`` store in a temporary
directory) and destroys on every exit path: the sharded engine's SPMD
step runs with its collectives (degenerate, but launched), against the
flat ``SparseSearchEngine`` on the same card. Both engines do a warm
search and then ``--passes`` timed passes over the same queries;
``shard_map_overhead_pct`` keeps the script's name and formula, 100 × (1
− qps_sharded / qps_flat). The corpus and queries are the script's: one
seed-42 generator, corpus first.

Exactness, both counts must be 0: ``mismatched_queries_vs_flat`` by the
script's rule (``common.substantive_mismatches``) against the flat engine
with its default merge, and ``differing_dicts_vs_flat``, queries whose
dicts differ at all from the flat engine whose merge reads the same
candidate scores (the device merge; the host merge under extraction).
On the card both engines must launch the head kernel (K2 at int8 top_k
50, K4-i8 with ``--narrow-backend extract --narrow-m 8``); their counts
over the timed passes are summed in ``kernel_launches`` and kept apart in
``kernel_launches_by_engine``. The script's ``pallas_interpret`` is not
in the row: the port has no Pallas and no interpret mode. Exits 1 if a
count is not 0, after printing the row; ``--out PATH`` also appends the
row to PATH.

Usage: python -m osr_tpu_torch.bench sharded-overhead [--passes 5]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from osr_tpu_torch.bench.common import (
    NUM_DOCS,
    VOCAB,
    device_name,
    differing_dicts,
    launched,
    log,
    no_card,
    reset_all_launches,
    substantive_mismatches,
    workload,
)
from osr_tpu_torch.bench.sharded_scale import (
    SHARD_GROUP_TIMEOUT_S,
    engine_options,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "sharded_qps_world_of_one"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench sharded-overhead",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, default=NUM_DOCS)
    ap.add_argument("--vocab", type=int, default=VOCAB)
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--topk", type=int, default=50)
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--head-dtype", default="int8")
    ap.add_argument("--narrow-m", type=int, default=0)
    ap.add_argument("--narrow-backend", default="xla",
                    choices=("xla", "extract"),
                    help="'extract' = per-shard top-m extraction (K4) + "
                    "host-side candidate head scores; 'xla' names the "
                    "port's torch selection")
    ap.add_argument("--out", default=None,
                    help="also append the row to this file")
    return ap


def qps_of(engine, queries, top_k: int, passes: int,
           dev: torch.device) -> Tuple[float, List[float], Dict[str, int]]:
    """(median QPS, each pass's QPS, the kernels launched over the
    passes), as the script times them."""
    reset_all_launches()
    qps = []
    for _ in range(passes):
        t0 = time.perf_counter()
        engine.search(queries, top_k=top_k)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        qps.append(round(len(queries) / (time.perf_counter() - t0), 1))
    return sorted(qps)[len(qps) // 2], qps, launched()


def run(
    *,
    docs: int = NUM_DOCS,
    vocab: int = VOCAB,
    num_queries: int = 2048,
    topk: int = 50,
    passes: int = 5,
    head_dtype: str = "int8",
    narrow_m: int = 0,
    narrow_backend: str = "xla",
    device=None,
) -> Tuple[Dict[str, object], Dict[str, Dict[str, float]]]:
    """The row and the sharded engine's results. The tests pass
    ``device="cpu"`` (a gloo world of one) and small sizes."""
    import torch.distributed as dist

    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.parallel import ShardedSparseSearchEngine, make_mesh
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    corpus, queries = workload(docs, vocab, num_queries)
    t0 = time.perf_counter()
    index = SparseIndexBuilder(method="bm25", head_dtype=head_dtype).build(
        corpus
    )
    build_s = time.perf_counter() - t0
    del corpus
    log(f"built in {build_s:.1f}s: {index.stats()}")
    options = engine_options(narrow_m, narrow_backend)
    common = dict(batch_sizes=(num_queries,), cache_queries=False, **options)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if on_card else "gloo",
            init_method=f"file://{Path(tmp) / 'world1.pg'}", rank=0,
            world_size=1, timeout=timedelta(seconds=SHARD_GROUP_TIMEOUT_S),
        )
        try:
            mesh = make_mesh(1, device_type=dev.type)
            t0 = time.perf_counter()
            sharded = ShardedSparseSearchEngine(
                index, mesh, device=dev, **common
            )
            res_sharded = sharded.search(queries, top_k=topk)
            if on_card:
                torch.cuda.synchronize(dev)
            warm_sharded_s = time.perf_counter() - t0
            qps_sharded, passes_sharded, sharded_counts = qps_of(
                sharded, queries, topk, passes, dev
            )
            head_backend, mesh_shape = sharded.head_backend, (
                sharded.comm.n_q, sharded.comm.n_d)
            del sharded
        finally:
            dist.destroy_process_group()

    flat = SparseSearchEngine(index, device=dev, **common)
    if on_card and flat.head_backend != "cuda":
        raise RuntimeError(f"the flat engine's head step is "
                           f"{flat.head_backend!r}, not the kernel")
    mismatches = substantive_mismatches(
        res_sharded, flat.search(queries, top_k=topk)
    )
    qps_flat, passes_flat, flat_counts = qps_of(flat, queries, topk, passes,
                                                dev)
    del flat
    extract = options["narrow_backend"] == "extract" and narrow_m > 0
    exact_flat = SparseSearchEngine(
        index, device=dev, merge_backend="host" if extract else "device",
        **common,
    )
    differing = differing_dicts(
        res_sharded, exact_flat.search(queries, top_k=topk)
    )
    del exact_flat

    if on_card:
        if head_backend != "cuda":
            raise RuntimeError(f"the sharded engine's head step is "
                               f"{head_backend!r}, not the kernel")
        if not (sharded_counts and flat_counts):
            raise RuntimeError(f"launched no kernel: sharded "
                               f"{sharded_counts}, flat {flat_counts}")
    total = dict(sharded_counts)
    for name, n in flat_counts.items():
        total[name] = total.get(name, 0) + n
    row = {
        "num_docs": docs,
        "head_dtype": head_dtype,
        "devices": 1,
        "mesh": {"q": mesh_shape[0], "d": mesh_shape[1]},
        "head_backend": head_backend,
        "narrow_m": narrow_m,
        "narrow_backend": narrow_backend,
        "build_s": round(build_s, 2),
        "warmup_s_sharded": round(warm_sharded_s, 1),
        "qps_sharded": qps_sharded,
        "qps_sharded_passes": passes_sharded,
        "qps_flat": qps_flat,
        "qps_flat_passes": passes_flat,
        "shard_map_overhead_pct": round(
            100.0 * (1.0 - qps_sharded / qps_flat), 1
        ),
        "num_queries": num_queries,
        "top_k": topk,
        "mismatched_queries_vs_flat": mismatches,
        "differing_dicts_vs_flat": differing,
        "kernel_launches": total,
        "kernel_launches_by_engine": {"sharded": sharded_counts,
                                      "flat": flat_counts},
        "device": device_name(dev),
    }
    return row, res_sharded


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    row, _ = run(
        docs=args.docs, vocab=args.vocab, num_queries=args.queries,
        topk=args.topk, passes=args.passes, head_dtype=args.head_dtype,
        narrow_m=args.narrow_m, narrow_backend=args.narrow_backend,
    )
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    if row["mismatched_queries_vs_flat"] + row["differing_dicts_vs_flat"]:
        log(f"{row['mismatched_queries_vs_flat']} queries differ "
            f"substantively, {row['differing_dicts_vs_flat']} differ from "
            "the flat engine")
        return 1
    return 0
