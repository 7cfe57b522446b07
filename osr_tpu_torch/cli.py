"""Command-line entry points (counterpart of ``osr_tpu/cli.py``).

``python -m osr_tpu_torch`` (console script ``osr-tpu-torch``) is the
equivalent of the reference's ``rag_research_pipeline.py`` CLI (reference
rag_system/pipeline/rag_research_pipeline.py), with subcommands covering
the other drivers:

    run       — run all experiments from a YAML config
    ablate    — ablation sweep over a base experiment
    evaluate  — generation metrics over a predictions file
    errors    — error analysis over predictions + qrels
    validate  — dataset validation / statistics
    bench     — efficiency benchmark over a dataset (``--dataset``), or the
                config-driven benchmark suites (``--config``)

``--platform cpu`` runs every retriever, and every benchmark suite, on the
CPU (the plain PyTorch versions of the kernels); ``gpu`` runs them on
``cuda``; ``default`` keeps each config block's device, ``cuda`` where
none is named (the suites run on ``cuda``). ``cuda`` raises without a
card.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path


_DEVICES = {"cpu": "cpu", "gpu": "cuda", "default": None}


def _device(args):
    return _DEVICES[args.platform]


def _pin_device(exp: dict, device) -> None:
    """Set ``device`` on an experiment's retriever block (a plain type
    string becomes ``{type, params}``); ``None`` leaves it as written."""
    if device is None:
        return
    retriever = exp["retriever"]
    if isinstance(retriever, str):
        retriever = {"type": retriever}
    params = dict(retriever.get("params") or {})
    params["device"] = device
    exp["retriever"] = {**retriever, "params": params}


def _load(args):
    from osr_tpu_torch.pipeline.config import load_config

    cfg = load_config(args.config)
    for exp in cfg["experiments"]:
        _pin_device(exp, _device(args))
    return cfg


def _cmd_run(args) -> int:
    from osr_tpu_torch.pipeline.experiment import run_all_experiments

    cfg = _load(args)
    if args.datasets_root:
        cfg["datasets_root"] = args.datasets_root
    if args.output_dir:
        cfg["output_dir"] = args.output_dir
    overall = run_all_experiments(cfg)
    ok = sum(1 for v in overall.values() if v.get("status") == "ok")
    print(f"Completed {ok}/{len(overall)} experiments -> {cfg['output_dir']}")
    return 0 if ok == len(overall) else 1


def _cmd_ablate(args) -> int:
    from osr_tpu_torch.pipeline.ablation import run_ablation

    cfg = _load(args)
    if args.datasets_root:
        cfg["datasets_root"] = args.datasets_root
    if args.experiment:
        base = next(
            (e for e in cfg["experiments"] if e["name"] == args.experiment),
            None,
        )
        if base is None:
            names = [e["name"] for e in cfg["experiments"]]
            raise SystemExit(
                f"Unknown experiment {args.experiment!r}; available: {names}"
            )
    else:
        base = cfg["experiments"][0]
    out = Path(args.output_dir or cfg["output_dir"]) / "ablations"
    results = run_ablation(base, cfg, out)
    ok = sum(1 for v in results.values() if v.get("status") == "ok")
    print(f"Completed {ok}/{len(results)} ablations -> {out}")
    return 0 if ok == len(results) else 1


def _cmd_evaluate(args) -> int:
    from osr_tpu_torch.metrics.generation import evaluate_generation

    with open(args.predictions, "r", encoding="utf-8") as f:
        predictions = json.load(f)
    with open(args.references, "r", encoding="utf-8") as f:
        references = json.load(f)
    results = evaluate_generation(predictions, references)
    summary = {k: v for k, v in results.items() if k != "individual_scores"}
    print(json.dumps(summary, indent=2))
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            json.dump(results, f, indent=2)
    return 0 if "error" not in results else 1


def _cmd_errors(args) -> int:
    from osr_tpu_torch.pipeline.errors import generate_error_report
    from osr_tpu_torch.storage.loaders import load_qrels

    with open(args.predictions, "r", encoding="utf-8") as f:
        predictions = json.load(f)
    qrels = load_qrels(Path(args.dataset))
    report = generate_error_report(predictions, qrels, args.output)
    print(json.dumps({k: v for k, v in report.items() if k != "categories"}, indent=2))
    return 0


def _cmd_validate(args) -> int:
    from osr_tpu_torch.storage.loaders import compute_dataset_stats, validate_dataset

    result = validate_dataset(args.dataset)
    print(json.dumps(result, indent=2))
    if args.stats:
        stats = compute_dataset_stats(args.dataset)
        print(json.dumps(stats.__dict__, indent=2))
    return 0 if result["ok"] else 1


def _cmd_bench(args) -> int:
    if args.config:
        # Config-driven suite runner (reference bench/core/
        # benchmark_runner.py semantics): suites, sizes, seed, threads.
        from osr_tpu_torch.benchmarks.runner import (
            load_benchmark_config,
            run_from_config,
        )

        cfg = load_benchmark_config(args.config)
        if args.output:
            cfg.output_dir = args.output
        overall = run_from_config(cfg, device=_device(args))
        print(
            json.dumps(
                {
                    "all_passed": overall["all_passed"],
                    "total_benchmarks": overall["total_benchmarks"],
                    "total_passed": overall["total_passed"],
                    "output_dir": cfg.output_dir,
                }
            )
        )
        return 0 if overall["all_passed"] else 1
    if not args.dataset:
        raise SystemExit("bench requires --dataset or --config")

    from osr_tpu_torch.pipeline.efficiency import run_comprehensive_benchmark
    from osr_tpu_torch.storage.loaders import (
        extract_query_text,
        load_corpus,
        load_queries,
    )

    corpus = load_corpus(Path(args.dataset))
    queries = {
        qid: extract_query_text(q)
        for qid, q in load_queries(Path(args.dataset)).items()
    }
    if args.max_queries:
        queries = dict(list(queries.items())[: args.max_queries])
    report = run_comprehensive_benchmark(
        corpus, queries, top_k=args.top_k, out_path=args.output,
        device=_device(args),
    )
    slim = {
        "build_time_s": report["build"]["build_time_s"],
        "throughput_qps": report["throughput_qps"],
        "latency": {
            k: {m: v[m] for m in ("mean_latency_ms", "p50_ms", "p95_ms")}
            for k, v in report["latency"].items()
            if "mean_latency_ms" in v
        },
    }
    print(json.dumps(slim, indent=2))
    return 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    parser = argparse.ArgumentParser(
        prog="osr_tpu_torch",
        description="Sparse retrieval for RAG on CUDA (PyTorch port)",
    )
    parser.add_argument(
        "--platform",
        choices=tuple(_DEVICES),
        default="default",
        help="'cpu' sets device: cpu on every retriever (no card needed); "
        "'gpu' sets device: cuda; 'default' keeps each config block's "
        "device, cuda where none is named.",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run", help="run experiments from a YAML config")
    p.add_argument("--config", required=True)
    p.add_argument("--datasets-root")
    p.add_argument("--output-dir")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("ablate", help="ablation sweep")
    p.add_argument("--config", required=True)
    p.add_argument("--experiment", help="base experiment name (default: first)")
    p.add_argument("--datasets-root")
    p.add_argument("--output-dir")
    p.set_defaults(fn=_cmd_ablate)

    p = sub.add_parser("evaluate", help="generation metrics")
    p.add_argument("--predictions", required=True)
    p.add_argument("--references", required=True)
    p.add_argument("--output")
    p.set_defaults(fn=_cmd_evaluate)

    p = sub.add_parser("errors", help="error analysis")
    p.add_argument("--predictions", required=True)
    p.add_argument("--dataset", required=True, help="dataset dir (for qrels)")
    p.add_argument("--output")
    p.set_defaults(fn=_cmd_errors)

    p = sub.add_parser("validate", help="validate a dataset directory")
    p.add_argument("dataset")
    p.add_argument("--stats", action="store_true")
    p.set_defaults(fn=_cmd_validate)

    p = sub.add_parser(
        "bench",
        help="efficiency benchmark on a dataset, or config-driven suites",
    )
    p.add_argument("--dataset")
    p.add_argument("--config", help="YAML benchmark spec (suites/seed/threads)")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--max-queries", type=int)
    p.add_argument("--output")
    p.set_defaults(fn=_cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
