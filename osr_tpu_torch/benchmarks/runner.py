"""Config-driven benchmark runner (counterpart of
``osr_tpu/benchmarks/runner.py``: the same schema, so
``osr_tpu/configs/benchmarks.yaml`` loads in both packages).

The YAML-spec'd counterpart of the reference's ``BenchmarkConfig`` /
``BenchmarkRunner`` (reference bench/core/benchmark_runner.py:29-121 —
whose execution body was a TODO; this one runs). A benchmark config
selects suites, their sizes, the RNG seed, thread-count environment
control and the output directory:

    name: nightly
    seed: 42
    num_threads: 1           # OMP/MKL pinning, reference :117-119
    output_dir: test_results
    suites:
      bm25: {num_docs: 500, vocab_size: 1500}
      topk: {n: 50000, batch: 16, k: 100}
      quantization: {}
      storage: {}

``python -m osr_tpu_torch bench --config osr_tpu/configs/benchmarks.yaml``
reproduces the ``test_results/`` tree; ``--platform cpu`` runs the suites
on the CPU (``run_from_config(cfg, device="cpu")``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np

from osr_tpu_torch.benchmarks.integration import IntegrationRunner
from osr_tpu_torch.benchmarks.suites import ALL_SUITES

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BenchmarkConfig:
    """Validated benchmark specification (reference
    benchmark_runner.py:29-40 semantics)."""

    name: str = "benchmark"
    seed: int = 42
    num_threads: Optional[int] = None
    output_dir: str = "test_results"
    suites: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict
    )

    def validate(self) -> None:
        unknown = set(self.suites) - set(ALL_SUITES)
        if unknown:
            raise ValueError(
                f"Unknown benchmark suites {sorted(unknown)}; "
                f"available: {sorted(ALL_SUITES)}"
            )
        if self.seed < 0:
            raise ValueError("seed must be non-negative")


def config_from_dict(raw: Dict[str, Any]) -> BenchmarkConfig:
    """Validate a raw mapping into a BenchmarkConfig (the single schema —
    integration.py's CLI adapts to this loader too)."""
    known = {f.name for f in dataclasses.fields(BenchmarkConfig)}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"Unknown benchmark config keys: {sorted(unknown)}")
    cfg = BenchmarkConfig(**raw)
    cfg.suites = {k: dict(v or {}) for k, v in (cfg.suites or {}).items()}
    cfg.validate()
    return cfg


def load_benchmark_config(path: Union[str, Path]) -> BenchmarkConfig:
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}
    return config_from_dict(raw)


_THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")


def _limit_threads(stack, n: int) -> None:
    """Reference benchmark_runner.py:117-119 thread-count control, held
    by ``stack``: OMP/MKL_NUM_THREADS are set and restored on exit, so
    the cap doesn't persist for the rest of the process or the
    subprocesses it starts later. The env vars only bind pools not yet
    initialized (NumPy's BLAS reads them at import, which has already
    happened here); threadpoolctl re-pins live pools when available."""
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}

    def restore() -> None:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    stack.callback(restore)
    for k in _THREAD_VARS:
        os.environ[k] = str(n)
    try:
        import threadpoolctl
    except ImportError:
        logger.warning(
            "num_threads=%d: BLAS pools were initialized before this "
            "runner (threadpoolctl not installed); the limit applies only "
            "to pools created during the run",
            n,
        )
        return
    stack.enter_context(threadpoolctl.threadpool_limits(limits=n))


def run_from_config(cfg: BenchmarkConfig, device=None) -> Dict[str, Any]:
    """Seed, pin threads, run the selected suites on ``device`` (None
    means ``cuda``), write reports."""
    import contextlib

    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    runner = IntegrationRunner(
        out_dir=cfg.output_dir,
        suites=list(cfg.suites.keys()) or None,
        suite_kwargs=cfg.suites,
        device=device,
    )
    with contextlib.ExitStack() as stack:
        if cfg.num_threads is not None:
            _limit_threads(stack, cfg.num_threads)
        overall = runner.run()
    overall["config"] = dataclasses.asdict(cfg)
    return overall
