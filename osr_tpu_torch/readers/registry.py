"""Reader registry (counterpart of ``osr_tpu/readers/registry.py``;
reference rag_system/core/reader_registry.py:174-212)."""

from __future__ import annotations

from typing import Any, Dict

from osr_tpu_torch.readers.extractive import ExtractiveReader
from osr_tpu_torch.readers.generative import GenerativeReader
from osr_tpu_torch.readers.llm import LLMReader


class ReaderRegistry:
    _readers: Dict[str, Any] = {}

    @classmethod
    def register(cls, name: str, reader_class) -> None:
        cls._readers[name] = reader_class

    @classmethod
    def create(cls, config) -> Any:
        if isinstance(config, str):
            name, params = config, {}
        else:
            name = config.get("type", config.get("name"))
            # YAML `params:` with no value parses to None — treat as empty.
            params = config.get("params") or {}
        if not name:
            raise ValueError("Reader name/type not specified")
        key = name.lower()
        if key in ("extractive", "extractive_reader"):
            return ExtractiveReader(**params)
        if key in ("generative", "generative_reader"):
            return GenerativeReader(**params)
        if key in ("llm", "llm_reader"):
            return LLMReader(**params)
        if name in cls._readers:
            return cls._readers[name](**params)
        raise ValueError(f"Unknown reader: {name}")

    @classmethod
    def list_available(cls) -> Dict[str, Any]:
        return {
            "builtin": ["extractive", "generative", "llm"],
            "registered_custom": list(cls._readers.keys()),
        }
