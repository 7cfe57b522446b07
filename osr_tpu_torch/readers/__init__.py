from osr_tpu_torch.readers.registry import ReaderRegistry
from osr_tpu_torch.readers.extractive import ExtractiveReader
from osr_tpu_torch.readers.generative import GenerativeReader
from osr_tpu_torch.readers.llm import LLMReader

__all__ = ["ReaderRegistry", "ExtractiveReader", "GenerativeReader", "LLMReader"]
