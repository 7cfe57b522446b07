"""Benchmark suites, their framework and runners (counterpart of
``osr_tpu/benchmarks/``): BM25, top-k, quantization and storage suites
(``suites.py``), the integration and YAML runners, the retrieval-quality
harness and the BEIR-shaped adapter.

Exports are lazy, as the package's are: importing
``osr_tpu_torch.benchmarks`` loads no submodule.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "BenchmarkResult": "osr_tpu_torch.benchmarks.framework",
    "BenchmarkSuite": "osr_tpu_torch.benchmarks.framework",
    "IntegrationRunner": "osr_tpu_torch.benchmarks.integration",
    "generate_report": "osr_tpu_torch.benchmarks.framework",
    "grade_performance": "osr_tpu_torch.benchmarks.framework",
    "run_benchmark_suite": "osr_tpu_torch.benchmarks.framework",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'osr_tpu_torch.benchmarks' has no attribute {name!r}"
        )
    return getattr(importlib.import_module(module), name)
