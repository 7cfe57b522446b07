"""The sharded sparse engine against the flat one at a scale users run,
on the CUDA card (counterpart of ``tools/bench_sharded_cpu.py``).

The script shards a 200,000-doc index over an 8-device virtual CPU mesh
(q=2, d=4) in one JAX program and counts the queries whose results differ
substantively from the single-device engine. Here the mesh is a world of
``--devices`` spawned ranks (``torch.distributed``, one process a rank,
each holding the whole host index and its own row shard of the head), so
the mode is named for what it checks, not for the CPU: every rank joins
one gloo group on ``cuda:0`` (NCCL takes one rank per card), and
``--cpu`` runs them on the CPU. The parent builds the index once
(``build_s``), hands it to the ranks through a file in a temporary
directory, and runs the flat ``SparseSearchEngine`` on the same index and
device with the same plan. Exactness, both counts must be 0:

- ``mismatched_queries_vs_single_device``: the script's rule
  (``common.substantive_mismatches``) against the flat engine with its
  default merge;
- ``differing_dicts_vs_flat``: queries whose dicts differ at all from the
  flat engine whose merge reads the same candidate scores (the device
  merge; the host merge under extraction).

``shard_upload_s`` and ``sharded_search_s`` are the slowest rank's (the
world is done when its last rank is). ``rows_per_shard`` is the rows a
shard holds, rounded up to 128-row blocks. Each rank's peak RSS and its
peak device memory are in the row. On the card every rank must launch a
head kernel (K2 at int8 top_k 50, K4-i8 with ``--narrow-backend
extract``); an engine whose head step is not the CUDA kernel is refused.
Exits 1 if a count is not 0, after printing the row; ``--out PATH`` also
appends the row to PATH.

Usage: python -m osr_tpu_torch.bench sharded-scale [--docs 200000]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import pickle
import queue
import resource
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from osr_tpu_torch.bench.common import (
    device_name,
    differing_dicts,
    foreign_modules,
    index_state,
    launched,
    log,
    no_card,
    reset_all_launches,
    substantive_mismatches,
    workload,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "sharded_mismatched_queries_at_scale"
SHARD_GROUP_TIMEOUT_S = 60  # the ranks' collective timeout
WORLD_WAIT_S = 900  # the parent's wait for every rank's report
QUERY_PARALLEL = 2  # the script's mesh: make_mesh(devices, query_parallel=2)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench sharded-scale",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, default=200_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--topk", type=int, default=50)
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks in the world (the mesh is (2, devices/2))")
    ap.add_argument("--head-dtype", default="int8",
                    choices=["f32", "bf16", "int8", "int4"])
    ap.add_argument("--narrow-m", type=int, default=0)
    ap.add_argument("--narrow-backend", default="xla",
                    choices=("xla", "extract"),
                    help="'extract' = per-shard top-m extraction (K4) + "
                    "host-side candidate head scores; 'xla' names the "
                    "port's torch selection")
    ap.add_argument("--out", default=None,
                    help="also append the row to this file")
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks and the flat engine on the CPU")
    return ap


def engine_options(narrow_m: int, narrow_backend: str) -> Dict[str, object]:
    """The engines' plan options; the script's ``xla`` backend is the
    port's ``torch`` selection (``retrieval/registry.py``)."""
    from osr_tpu_torch.retrieval.registry import _NARROW_BACKENDS

    return dict(
        narrow_m=narrow_m,
        narrow_backend=_NARROW_BACKENDS.get(narrow_backend, narrow_backend),
    )


def _peak_rss_mb() -> float:
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1)


def rank_main(rank, world, init_file, index_file, queries, top_k, options,
              device_type, results):
    """One rank: join the gloo group, build the sharded engine on its
    shard, search once; puts (rank, True, its report) or (rank, False, a
    traceback) on ``results``. Rank 0's report holds the results."""
    import torch.distributed as dist

    try:
        from osr_tpu_torch.convert import index_from_arrays
        from osr_tpu_torch.parallel import ShardedSparseSearchEngine, make_mesh

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=timedelta(seconds=SHARD_GROUP_TIMEOUT_S),
        )
        try:
            on_card = device_type == "cuda"
            mesh = make_mesh(world, query_parallel=QUERY_PARALLEL,
                             device_type=device_type)
            with open(index_file, "rb") as f:
                index = index_from_arrays(**pickle.load(f))
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sh = ShardedSparseSearchEngine(
                index, mesh, batch_sizes=(len(queries),),
                device=device_type, **options,
            )
            if on_card:
                torch.cuda.synchronize()
                if (sh.head_backend != "cuda"
                        and index.layout.head_dtype in ("int8", "int4")):
                    raise RuntimeError(
                        f"rank {rank}: head_backend={sh.head_backend!r}, "
                        "not the CUDA kernels"
                    )
            upload_s = time.perf_counter() - t0
            reset_all_launches()
            t0 = time.perf_counter()
            res = sh.search(queries, top_k=top_k)
            if on_card:
                torch.cuda.synchronize()
            search_s = time.perf_counter() - t0
            report = dict(
                results=res if rank == 0 else None,
                launches=launched(),
                upload_s=upload_s,
                search_s=search_s,
                rows_local=sh.rows_local,
                mesh=(sh.comm.n_q, sh.comm.n_d),
                transport=str(sh.comm.device),
                foreign_modules=foreign_modules(),
                peak_rss_mb=_peak_rss_mb(),
                device_peak_mb=(
                    round(torch.cuda.max_memory_allocated() / 2**20, 1)
                    if on_card else None
                ),
            )
        finally:
            dist.destroy_process_group()
        results.put((rank, True, report))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def run_world(index, queries, top_k: int, devices: int,
              options: Dict[str, object], device_type: str) -> List[dict]:
    """Spawn ``devices`` ranks over ``index`` and return their reports in
    rank order; a rank's traceback, or no report in WORLD_WAIT_S, raises
    here after the ranks are stopped."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        index_file = Path(tmp) / "index.pkl"
        with open(index_file, "wb") as f:
            pickle.dump(index_state(index), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [
            ctx.Process(
                target=rank_main,
                args=(r, devices, str(Path(tmp) / "world.pg"),
                      str(index_file), queries, top_k, options, device_type,
                      results),
            )
            for r in range(devices)
        ]
        for p in procs:
            p.start()
        reports = {}
        try:
            deadline = time.monotonic() + WORLD_WAIT_S
            while len(reports) < devices:
                try:
                    rank, ok, payload = results.get(
                        timeout=max(1.0, deadline - time.monotonic())
                    )
                except queue.Empty:
                    missing = sorted(set(range(devices)) - set(reports))
                    raise RuntimeError(
                        f"ranks {missing} did not answer in {WORLD_WAIT_S} s"
                    ) from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                reports[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [reports[r] for r in range(devices)]


def run(
    *,
    docs: int = 200_000,
    num_queries: int = 256,
    topk: int = 50,
    devices: int = 8,
    head_dtype: str = "int8",
    narrow_m: int = 0,
    narrow_backend: str = "xla",
    device=None,
) -> Tuple[Dict[str, object], Dict[str, Dict[str, float]]]:
    """The row and rank 0's results. The tests pass ``device="cpu"`` and
    small sizes."""
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        from osr_tpu_torch.ops import _build

        _build.build_all()  # once, before the ranks load the kernels
    vocab = min(4 * docs, 400_000)
    t0 = time.perf_counter()
    corpus, queries = workload(docs, vocab, num_queries)
    log(f"generated in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    index = SparseIndexBuilder(method="bm25", head_dtype=head_dtype).build(
        corpus
    )
    build_s = time.perf_counter() - t0
    del corpus
    log(f"built in {build_s:.1f}s: {index.stats()}")

    options = engine_options(narrow_m, narrow_backend)
    reports = run_world(index, queries, topk, devices, options, dev.type)
    foreign = {r: rep["foreign_modules"] for r, rep in enumerate(reports)
               if rep["foreign_modules"]}
    if foreign:
        raise RuntimeError(f"ranks loaded modules the port must not: "
                           f"{foreign}")
    res_sharded = reports[0]["results"]
    per_rank = [r["launches"] for r in reports]
    if on_card and not all(per_rank):
        raise RuntimeError(f"a rank launched no kernel: {per_rank}")
    for rank, r in enumerate(reports):
        log(f"rank {rank}: mesh {r['mesh']}, transport {r['transport']}, "
            f"{r['rows_local']} rows, upload {r['upload_s']:.2f}s, search "
            f"{r['search_s']:.2f}s, peak RSS {r['peak_rss_mb']} MiB, device "
            f"peak {r['device_peak_mb']} MiB, launches {r['launches']}")

    common = dict(batch_sizes=(num_queries,), cache_queries=False, **options)
    single = SparseSearchEngine(index, device=dev, **common)
    mismatches = substantive_mismatches(
        res_sharded, single.search(queries, top_k=topk)
    )
    del single
    extract = options["narrow_backend"] == "extract" and narrow_m > 0
    flat = SparseSearchEngine(
        index, device=dev, merge_backend="host" if extract else "device",
        **common,
    )
    differing = differing_dicts(res_sharded, flat.search(queries, top_k=topk))
    del flat

    total: Dict[str, int] = {}
    for counts in per_rank:
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    n_q, n_d = reports[0]["mesh"]
    row = {
        "num_docs": docs,
        "vocab_size": index.vocab_size,
        "head_dtype": head_dtype,
        "narrow_m": narrow_m,
        "narrow_backend": narrow_backend,
        "devices": devices,
        "mesh": {"q": n_q, "d": n_d},
        "rows_per_shard": reports[0]["rows_local"],
        "build_s": round(build_s, 2),
        "shard_upload_s": round(max(r["upload_s"] for r in reports), 2),
        "sharded_search_s": round(max(r["search_s"] for r in reports), 2),
        "num_queries": num_queries,
        "top_k": topk,
        "mismatched_queries_vs_single_device": mismatches,
        "differing_dicts_vs_flat": differing,
        "platform": "cuda-gloo-shared" if on_card else "cpu-gloo",
        "rank_peak_rss_mb": [r["peak_rss_mb"] for r in reports],
        "rank_device_peak_mb": [r["device_peak_mb"] for r in reports],
        "kernel_launches": total,
        "kernel_launches_by_rank": per_rank,
        "device": device_name(dev),
    }
    return row, res_sharded


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        return no_card(METRIC)
    row, _ = run(
        docs=args.docs, num_queries=args.queries, topk=args.topk,
        devices=args.devices, head_dtype=args.head_dtype,
        narrow_m=args.narrow_m, narrow_backend=args.narrow_backend,
        device="cpu" if args.cpu else None,
    )
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    bad = row["mismatched_queries_vs_single_device"] + row[
        "differing_dicts_vs_flat"]
    if bad:
        log(f"{row['mismatched_queries_vs_single_device']} queries differ "
            f"substantively from the single-device engine, "
            f"{row['differing_dicts_vs_flat']} differ from the flat engine")
        return 1
    return 0
