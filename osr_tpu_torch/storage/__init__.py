"""Document storage: the ``Document`` record, corpus processing and the
memory-mapped compressed ``DocumentStore``."""

from osr_tpu_torch.storage.doc_store import DocumentStore, LRUCache
from osr_tpu_torch.storage.documents import CorpusProcessor, Document

__all__ = ["CorpusProcessor", "Document", "DocumentStore", "LRUCache"]
