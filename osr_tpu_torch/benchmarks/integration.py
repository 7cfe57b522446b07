"""Integration benchmark orchestrator (counterpart of
``osr_tpu/benchmarks/integration.py``).

Capability parity with reference bench/core/integration.py: compose the
component suites, run them with memory tracking, write per-suite JSON plus
an overall markdown report, and return an aggregate pass/fail verdict.
One ``device`` (None means ``cuda``) goes to every suite that runs on a
device; ``main``'s ``--cpu`` sets it to ``cpu``, where ``osr_tpu`` pins
JAX to its CPU platform.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

from osr_tpu_torch.benchmarks.framework import (
    generate_report,
    run_benchmark_suite,
    save_json,
)
from osr_tpu_torch.benchmarks.suites import ALL_SUITES
from osr_tpu_torch.retrieval.engine import _resolve_device

logger = logging.getLogger(__name__)


class IntegrationRunner:
    def __init__(
        self,
        out_dir: Union[str, Path] = "test_results",
        suites: Optional[Sequence[str]] = None,
        suite_kwargs: Optional[Dict[str, Dict[str, Any]]] = None,
        device=None,
    ):
        self.out_dir = Path(out_dir)
        self.suite_names = list(suites or ALL_SUITES.keys())
        self.suite_kwargs = suite_kwargs or {}
        self.device = _resolve_device(device)

    def run(self) -> Dict[str, Any]:
        outputs: List[Dict[str, Any]] = []
        for name in self.suite_names:
            suite_cls = ALL_SUITES[name]
            kwargs = dict(self.suite_kwargs.get(name, {}))
            if suite_cls.uses_device:
                kwargs.setdefault("device", self.device)
            suite = suite_cls(**kwargs)
            logger.info("Running suite: %s", name)
            result = run_benchmark_suite(suite)
            outputs.append(result)
            save_json(result, self.out_dir / f"{name}_results.json")
        from osr_tpu_torch.utils.hardware import (
            detect_hardware_capabilities,
            get_optimization_recommendations,
            validate_backend,
        )

        overall = {
            "suites": outputs,
            "all_passed": all(s["all_passed"] for s in outputs),
            "total_benchmarks": sum(s["num_benchmarks"] for s in outputs),
            "total_passed": sum(s["num_passed"] for s in outputs),
            "hardware": detect_hardware_capabilities(),
            "backend_validation": validate_backend(self.device),
            "recommendations": get_optimization_recommendations(),
        }
        save_json(
            {k: v for k, v in overall.items() if k != "suites"},
            self.out_dir / "integration_summary.json",
        )
        generate_report(
            outputs, self.out_dir / "integration_report.md"
        )
        logger.info(
            "Integration: %d/%d benchmarks passed",
            overall["total_passed"],
            overall["total_benchmarks"],
        )
        return overall


def load_benchmark_config(path: Union[str, Path]) -> Dict[str, Any]:
    """YAML-driven benchmark configuration — ONE schema with the CLI
    runner (osr_tpu_torch/benchmarks/runner.py; reference
    bench/core/benchmark_runner.py:29-40 capability):

        output_dir: test_results
        seed: 42
        suites:
          bm25: {num_docs: 2000, vocab_size: 5000}
          topk: {n: 100000, k: 100}

    This wrapper adapts the shared loader to the dict shape this module's
    CLI consumes (`out_dir` key; the legacy spelling is still accepted on
    input).
    """
    import yaml

    from osr_tpu_torch.benchmarks.runner import config_from_dict

    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}
    if "out_dir" in raw and "output_dir" not in raw:
        raw["output_dir"] = raw.pop("out_dir")
    cfg = config_from_dict(raw)
    return {
        "out_dir": cfg.output_dir,
        "seed": cfg.seed,
        "suites": cfg.suites,
    }


def main(argv=None) -> int:  # CLI: python -m osr_tpu_torch.benchmarks.integration
    import argparse

    import numpy as np

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="Run integration benchmarks")
    parser.add_argument("--out-dir", default="test_results")
    parser.add_argument(
        "--suites", nargs="*", choices=list(ALL_SUITES.keys()), default=None
    )
    parser.add_argument("--config", help="YAML benchmark config")
    parser.add_argument(
        "--cpu",
        action="store_true",
        help="run every suite on the CPU (no card required)",
    )
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.config:
        cfg = load_benchmark_config(args.config)
        np.random.seed(cfg["seed"])
        runner = IntegrationRunner(
            cfg["out_dir"],
            suites=list(cfg["suites"].keys()) or None,
            suite_kwargs=cfg["suites"],
            device=device,
        )
        overall = runner.run()
        args.out_dir = cfg["out_dir"]
    else:
        overall = IntegrationRunner(args.out_dir, args.suites, device=device).run()
    print(
        f"{overall['total_passed']}/{overall['total_benchmarks']} passed "
        f"-> {args.out_dir}/integration_report.md"
    )
    return 0 if overall["all_passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
