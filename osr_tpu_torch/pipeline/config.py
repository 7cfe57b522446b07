"""YAML experiment configuration (counterpart of
``osr_tpu/pipeline/config.py``). ``validate_config`` takes a dict, so a
caller without PyYAML passes its configuration as one; ``load_config``
imports ``yaml`` when it reads a file.

Schema-compatible with the reference's configs (reference
rag_system/configs/paper_results.yaml, loaded/validated at
rag_research_pipeline.py:14-38):

    output_dir: results
    datasets_root: datasets        # optional, default 'datasets'
    experiments:
      - name: fiqa_bm25_custom
        dataset: fiqa
        retriever: {type: bm25_custom, model: null, params: {...}}
        reader:    {type: extractive, params: {...}}
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union


class ConfigError(ValueError):
    pass


def validate_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    if not isinstance(cfg, dict):
        raise ConfigError("Config must be a mapping")
    experiments = cfg.get("experiments")
    if not isinstance(experiments, list) or not experiments:
        raise ConfigError("Config must contain a non-empty 'experiments' list")
    for i, exp in enumerate(experiments):
        for key in ("name", "dataset", "retriever"):
            if key not in exp:
                raise ConfigError(f"experiments[{i}] missing '{key}'")
        retriever = exp["retriever"]
        if isinstance(retriever, str):
            pass  # plain type string — RetrieverRegistry.create accepts it
        elif isinstance(retriever, dict):
            if "type" not in retriever and "name" not in retriever:
                raise ConfigError(
                    f"experiments[{i}].retriever missing 'type'"
                )
        else:
            raise ConfigError(
                f"experiments[{i}].retriever must be a string or mapping"
            )
    cfg.setdefault("output_dir", "results")
    cfg.setdefault("datasets_root", "datasets")
    return cfg


def load_config(path: Union[str, Path]) -> Dict[str, Any]:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Config file not found: {path}")
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    return validate_config(cfg)
