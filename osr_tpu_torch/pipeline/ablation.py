"""Ablation study driver (counterpart of ``osr_tpu/pipeline/ablation.py``).

Capability parity with reference rag_system/pipeline/run_ablation.py:
recursive config overrides (:13-20), ablation-config generation from a base
experiment (:22-44), a default top-k/parameter sweep (:64-100), per-ablation
output directories and failure isolation (:118-151).
"""

from __future__ import annotations

import copy
import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from osr_tpu_torch.pipeline.experiment import run_rag_experiment

logger = logging.getLogger(__name__)


def deep_update(base: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``overrides`` into a copy of ``base``."""
    out = copy.deepcopy(base)
    for key, value in overrides.items():
        if (
            key in out
            and isinstance(out[key], dict)
            and isinstance(value, dict)
        ):
            out[key] = deep_update(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


DEFAULT_ABLATIONS: List[Dict[str, Any]] = [
    {"name": "top_k_10", "retriever": {"params": {"top_k": 10}}},
    {"name": "top_k_25", "retriever": {"params": {"top_k": 25}}},
    {"name": "top_k_50", "retriever": {"params": {"top_k": 50}}},
    {"name": "top_k_100", "retriever": {"params": {"top_k": 100}}},
    {"name": "bm25_k1_0.9", "retriever": {"params": {"k1": 0.9}}},
    {"name": "bm25_k1_1.5", "retriever": {"params": {"k1": 1.5}}},
    {"name": "bm25_b_0.4", "retriever": {"params": {"b": 0.4}}},
    {"name": "bm25_b_1.0", "retriever": {"params": {"b": 1.0}}},
]


def generate_ablation_configs(
    base_experiment: Dict[str, Any],
    ablations: Optional[List[Dict[str, Any]]] = None,
) -> List[Dict[str, Any]]:
    """Expand a base experiment into one config per ablation."""
    ablations = ablations if ablations is not None else DEFAULT_ABLATIONS
    configs = []
    for ab in ablations:
        overrides = {k: v for k, v in ab.items() if k != "name"}
        cfg = deep_update(base_experiment, overrides)
        cfg["name"] = f"{base_experiment['name']}_{ab['name']}"
        configs.append(cfg)
    return configs


def run_ablation(
    base_experiment: Dict[str, Any],
    global_cfg: Dict[str, Any],
    out_root: Union[str, Path],
    ablations: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Run every ablation in its own output directory; one failure doesn't
    kill the sweep."""
    out_root = Path(out_root)
    results: Dict[str, Any] = {}
    for cfg in generate_ablation_configs(base_experiment, ablations):
        out_dir = out_root / cfg["name"]
        try:
            results[cfg["name"]] = run_rag_experiment(cfg, global_cfg, out_dir)
            results[cfg["name"]]["status"] = "ok"
        except Exception as e:
            logger.error("Ablation %s failed: %s", cfg["name"], e)
            results[cfg["name"]] = {"status": "failed", "error": str(e)}
    out_root.mkdir(parents=True, exist_ok=True)
    with open(out_root / "ablation_results.json", "w", encoding="utf-8") as f:
        json.dump(results, f, indent=2, ensure_ascii=False)
    return results
