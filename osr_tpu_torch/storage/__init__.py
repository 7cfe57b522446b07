"""Document storage: the ``Document`` record, corpus processing, the
memory-mapped compressed ``DocumentStore`` and the BEIR-format dataset
loaders."""

from osr_tpu_torch.storage.doc_store import DocumentStore, LRUCache
from osr_tpu_torch.storage.documents import CorpusProcessor, Document
from osr_tpu_torch.storage.loaders import (
    compute_dataset_stats,
    load_corpus,
    load_qrels,
    load_queries,
    validate_dataset,
)

__all__ = [
    "CorpusProcessor",
    "Document",
    "DocumentStore",
    "LRUCache",
    "compute_dataset_stats",
    "load_corpus",
    "load_qrels",
    "load_queries",
    "validate_dataset",
]
