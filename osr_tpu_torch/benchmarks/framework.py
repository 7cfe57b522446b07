"""Benchmark framework: suites, timing, grading, reporting (counterpart
of ``osr_tpu/benchmarks/framework.py``, over this package's
``utils/timing.MemoryMonitor``).

Capability parity with reference bench/core/benchmark_framework.py
(BenchmarkResult :17, abstract BenchmarkSuite :30, warmup timing :75-114,
memory monitoring :116-147, suite runner :149-197, letter grading vs
targets :199-221, markdown report :223+) and bench/utils.py (size
measurement :7, results tables :91, report template :125).
"""

from __future__ import annotations

import abc
import dataclasses
import json
import sys
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from osr_tpu_torch.utils.timing import MemoryMonitor


@dataclasses.dataclass
class BenchmarkResult:
    name: str
    passed: bool
    duration_s: float
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    grade: Optional[str] = None
    error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class BenchmarkSuite(abc.ABC):
    """A named set of benchmark cases with setup/run/cleanup lifecycle.
    A suite with ``uses_device`` takes a ``device`` argument (None means
    ``cuda``) and runs its cases there."""

    name: str = "suite"
    uses_device: bool = False

    def setup(self) -> None:  # pragma: no cover - default no-op
        pass

    @abc.abstractmethod
    def run(self) -> List[BenchmarkResult]:
        ...

    def cleanup(self) -> None:  # pragma: no cover - default no-op
        pass


GRADE_THRESHOLDS = (
    (2.0, "A+"),
    (1.5, "A"),
    (1.2, "B"),
    (1.0, "C"),
    (0.5, "D"),
)


def grade_performance(achieved: float, target: float) -> str:
    """Letter grade of achieved/target ratio (higher is better)."""
    if target <= 0:
        return "A+"
    ratio = achieved / target
    for threshold, grade in GRADE_THRESHOLDS:
        if ratio >= threshold:
            return grade
    return "F"


def measure_size(obj: Any) -> int:
    """Deep-ish byte size of arrays/containers (reference bench/utils.py:7)."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, (list, tuple)):
        return sum(measure_size(x) for x in obj) + sys.getsizeof(obj)
    if isinstance(obj, dict):
        return (
            sum(measure_size(k) + measure_size(v) for k, v in obj.items())
            + sys.getsizeof(obj)
        )
    return sys.getsizeof(obj)


def run_benchmark_suite(suite: BenchmarkSuite) -> Dict[str, Any]:
    """Run one suite with lifecycle + memory tracking."""
    t0 = time.perf_counter()
    results: List[BenchmarkResult] = []
    error: Optional[str] = None
    with MemoryMonitor() as mem:
        try:
            suite.setup()
            results = suite.run()
        except Exception as e:
            error = f"{type(e).__name__}: {e}"
        finally:
            try:
                suite.cleanup()
            except Exception:
                pass
    passed = sum(1 for r in results if r.passed)
    return {
        "suite": suite.name,
        "duration_s": time.perf_counter() - t0,
        "memory_delta_mb": mem.delta_mb,
        "num_benchmarks": len(results),
        "num_passed": passed,
        "all_passed": bool(error is None and passed == len(results) and results),
        "error": error,
        "results": [r.to_dict() for r in results],
    }


def format_results_table(rows: Sequence[Dict[str, Any]], columns: Sequence[str]) -> str:
    """Plain-markdown table from result dicts."""
    header = "| " + " | ".join(columns) + " |"
    sep = "|" + "|".join("---" for _ in columns) + "|"
    lines = [header, sep]
    for row in rows:
        cells = []
        for c in columns:
            v = row.get(c, "")
            cells.append(f"{v:.4f}" if isinstance(v, float) else str(v))
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def generate_report(
    suite_outputs: Sequence[Dict[str, Any]],
    out_path: Optional[Union[str, Path]] = None,
    title: str = "osr_tpu_torch benchmark report",
) -> str:
    """Markdown report over suite outputs; optionally written to disk."""
    lines = [
        f"# {title}",
        "",
        f"Generated: {datetime.now().isoformat()}",
        "",
        "## Summary",
        "",
    ]
    lines.append(
        format_results_table(
            [
                {
                    "suite": s["suite"],
                    "passed": f"{s['num_passed']}/{s['num_benchmarks']}",
                    "duration_s": s["duration_s"],
                    "status": "OK" if s["all_passed"] else "FAIL",
                }
                for s in suite_outputs
            ],
            ["suite", "passed", "duration_s", "status"],
        )
    )
    for s in suite_outputs:
        lines += ["", f"## {s['suite']}", ""]
        if s.get("error"):
            lines.append(f"**Suite error:** `{s['error']}`")
            continue
        for r in s["results"]:
            status = "PASS" if r["passed"] else "FAIL"
            grade = f" (grade {r['grade']})" if r.get("grade") else ""
            lines.append(f"### {r['name']} — {status}{grade}")
            lines.append("")
            for k, v in r["metrics"].items():
                lines.append(
                    f"- {k}: {v:.6g}" if isinstance(v, float) else f"- {k}: {v}"
                )
            lines.append("")
    report = "\n".join(lines)
    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(report)
    return report


def save_json(data: Any, path: Union[str, Path]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def default(o):
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return str(o)

    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, default=default)
