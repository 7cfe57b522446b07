"""The whole experiment pipeline over the prose harvest, on the CUDA card
(counterpart of ``tools/run_pipeline_87k.py``).

Config, registry, engine, reader, summary: ``run_all_experiments`` over
``--config`` (default the repository's ``osr_tpu/configs/prose_87k.yaml``,
read as data: its bm25 block with the extractive reader and its hybrid
RRF-IDF block with the generative reader, top_k 100). The dataset is
quality-at-scale's: the harvest of ``--roots`` (48-word windows at stride
24, ``testing.harvest_chunks``) and ``testing.build_dataset`` in the noisy
regime (4 source words and 2 of another chunk; graded qrels) over
``--num-queries`` seed-42 queries, written to a temporary directory as
BEIR files. Below 20,000 chunks it refuses, as quality-at-scale does:
a line with no value and the reason, exit 1.

On the card each bm25 search takes a head kernel (K2, or K1 where R/128
<= 2 x top_k: at 23,801 docs, 186 blocks, K1) and the hybrid's dense leg
K7 + K5; each experiment reports its own launches. ``--cpu`` sets
``device: cpu`` in every retriever block. The summaries and preds go to
``--out DIR`` (the config's ``output_dir``); without it to a temporary
directory, removed after. The script's ``enable_persistent_cache`` has no
counterpart (no JIT compile). Prints one JSON row as its last line: per
experiment its status, quality, ``stage_times_s``, retrieval and pipeline
QPS and launches, beside ``num_docs``, ``num_queries``, ``grade1_qrels``,
``harvest_s``, ``kernel_launches`` and ``device``; exits 1 unless every
experiment is ``ok`` (``run_all_experiments`` records a failed
experiment and goes on).

Usage: python -m osr_tpu_torch.bench pipeline-87k [--num-queries 512]
       [--max-chunks 100000] [--roots DIR ...] [--config PATH]
       [--out DIR] [--cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from osr_tpu_torch.bench.common import (
    all_launches,
    device_name,
    log,
    no_card,
    prose_roots,
    reset_all_launches,
    sync,
)
from osr_tpu_torch.retrieval.engine import resolve_device

METRIC = "pipeline_ndcg_at_10"
CONFIG = Path(__file__).resolve().parents[2] / "osr_tpu/configs/prose_87k.yaml"
KEYS = ("metric", "config", "num_docs", "num_queries", "grade1_qrels",
        "harvest_s", "experiments", "output_dir", "kernel_launches",
        "device")
# What each experiment's entry keeps of its summary.
SUMMARY_KEYS = ("status", "quality", "stage_times_s", "retrieval_qps",
                "queries_per_second", "error")


@contextlib.contextmanager
def counted_experiments(dev, launches: Dict[str, Dict[str, int]]):
    """While open, each experiment ``run_all_experiments`` runs records the
    kernels it launched in ``launches[name]``."""
    from osr_tpu_torch.pipeline import experiment as pipe

    inner = pipe.run_rag_experiment

    def counted(exp_cfg, global_cfg, out_dir):
        reset_all_launches()
        try:
            return inner(exp_cfg, global_cfg, out_dir)
        finally:
            sync(dev)
            launches[exp_cfg["name"]] = {
                k: v for k, v in all_launches().items() if v}

    pipe.run_rag_experiment = counted
    try:
        yield launches
    finally:
        pipe.run_rag_experiment = inner


def run(
    chunks: Sequence[str],
    *,
    num_queries: int = 512,
    config=CONFIG,
    out: Optional[str] = None,
    harvest_s: Optional[float] = None,
    device=None,
) -> Dict[str, object]:
    """The row over ``chunks`` (any number: the floor is ``main``'s);
    printed as one JSON line and returned. The tests pass
    ``device="cpu"``."""
    from osr_tpu_torch.pipeline.config import load_config
    from osr_tpu_torch.pipeline.experiment import run_all_experiments
    from osr_tpu_torch.testing import build_dataset

    dev = resolve_device(device)
    cfg = load_config(config)
    if dev.type == "cpu":
        for exp in cfg["experiments"]:
            retriever = exp["retriever"]
            if isinstance(retriever, str):
                retriever = exp["retriever"] = {"type": retriever}
            retriever.setdefault("params", {})["device"] = "cpu"
    launches: Dict[str, Dict[str, int]] = {}
    with tempfile.TemporaryDirectory() as tmp:
        td = Path(tmp)
        made = {}
        for name in dict.fromkeys(e["dataset"] for e in cfg["experiments"]):
            t0 = time.perf_counter()
            made[name] = build_dataset(td / "datasets" / name, chunks,
                                       num_queries, mode="noisy")
            log(f"dataset {name}: {len(chunks)} docs, {made[name][0]} "
                f"queries, {made[name][1]} grade-1 qrels "
                f"({time.perf_counter() - t0:.1f}s)")
        cfg["datasets_root"] = str(td / "datasets")
        cfg["output_dir"] = str(out) if out else str(td / "results")
        t0 = time.perf_counter()
        with counted_experiments(dev, launches):
            overall = run_all_experiments(cfg)
        log(f"run_all_experiments: {len(overall)} experiments in "
            f"{time.perf_counter() - t0:.1f}s")
    experiments = {}
    total: Dict[str, int] = {}
    for name, summary in overall.items():
        entry = {k: summary[k] for k in SUMMARY_KEYS if k in summary}
        entry["kernel_launches"] = launches.get(name, {})
        for k, v in entry["kernel_launches"].items():
            total[k] = total.get(k, 0) + v
        experiments[name] = entry
        log(f"{name}: {entry['status']}"
            + (f", nDCG@10 {entry['quality'].get('ndcg@10')}, retrieval "
               f"QPS {entry['retrieval_qps']:.1f}, pipeline QPS "
               f"{entry['queries_per_second']:.1f}"
               if entry["status"] == "ok" else f": {entry.get('error')}"))
    n_queries, grade1 = next(iter(made.values()))
    row = {
        "metric": METRIC,
        "config": str(config),
        "num_docs": len(chunks),
        "num_queries": n_queries,
        "grade1_qrels": grade1,
        "harvest_s": None if harvest_s is None else round(harvest_s, 2),
        "experiments": experiments,
        "output_dir": str(out) if out else None,
        "kernel_launches": total,
        "device": device_name(dev),
    }
    print(json.dumps(row), flush=True)
    return row


def all_ok(row: Dict[str, object]) -> bool:
    return all(e["status"] == "ok" for e in row["experiments"].values())


def main(argv: Optional[List[str]] = None) -> int:
    from osr_tpu_torch.bench import quality_at_scale as qas

    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench pipeline-87k",
        description=__doc__.splitlines()[0],
    )
    qas.add_harvest_options(ap)
    ap.add_argument("--config", default=str(CONFIG),
                    help="the experiment config (default: the repository's "
                    "osr_tpu/configs/prose_87k.yaml)")
    ap.add_argument("--out", default=None,
                    help="write the summaries and preds to this directory")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        return no_card(METRIC)
    roots = args.roots or prose_roots()
    t0 = time.perf_counter()
    chunks = qas.harvest(args.max_chunks, roots)
    harvest_s = time.perf_counter() - t0
    refused = qas.below_floor(chunks, METRIC)
    if refused:
        return refused
    row = run(chunks, num_queries=args.num_queries, config=args.config,
              out=args.out, harvest_s=harvest_s,
              device="cpu" if args.cpu else None)
    return 0 if all_ok(row) else 1
