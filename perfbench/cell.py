"""A cell resolved from ``BENCHMARK.json`` and the files it names: the
configuration (``configs/<config>.json``, by the ``file`` of its entry),
the traffic mix (``traffic/<traffic>.json``), the driver the mix names
(``drivers/<driver>.py``) and the metrics the cell reports, each read by
``metrics/<metric name>.py``. Nothing here names a cell, a mix or a
metric: adding one is adding files and entries."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]  # the checkout
HERE = Path(__file__).resolve().parent


class Cell:
    def __init__(self, bench: Dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads(
            (root / configs[self.workload["config"]]["file"]).read_text())
        self.traffic = json.loads(
            (HERE / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if self._applies(m, None)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if self._applies(m, reported)]

    def _applies(self, metric: Dict, reported) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return reported is None or metric["moves"] in reported


def load_bench(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reader(name: str):
    """The ``read(record)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[Dict], record: Dict) -> Dict[str, Dict]:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
