"""High-level retrieval service: document store + search engines + stats
(counterpart of ``osr_tpu/retrieval/service.py``; ``device``, None for
``cuda``, goes to both engines).

Capability parity with the reference's ``RetrievalService`` (reference
rag_system/core/retrieval.py:95-506): one object owning the persistent
document store, the BM25 index/engine, an optional dense-embedding index,
document caching, and introspection — the "Basic Usage" library API.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from osr_tpu_torch.index.builder import SparseIndexBuilder
from osr_tpu_torch.index.dense import load_embeddings
from osr_tpu_torch.retrieval.engine import DenseSearchEngine, SparseSearchEngine
from osr_tpu_torch.storage.doc_store import DocumentStore
from osr_tpu_torch.storage.documents import Document

logger = logging.getLogger(__name__)


class RetrievalService:
    """Production retrieval facade.

    Usage::

        svc = RetrievalService("corpus.osrd", create=True)
        svc.add_documents(docs)
        svc.build_bm25_index()
        hits = svc.search_bm25({"q1": "exchange traded funds"}, top_k=10)
        results = svc.get_search_results(hits["q1"])
    """

    def __init__(
        self,
        index_path: Union[str, Path],
        embedding_path: Optional[Union[str, Path]] = None,
        embedding_dim: Optional[int] = None,
        create: bool = False,
        cache_size: int = 1000,
        num_workers: int = 4,
        k1: float = 1.2,
        b: float = 0.75,
        device=None,
        **engine_kwargs: Any,
    ):
        self.store = DocumentStore(
            index_path,
            create=create,
            cache_items=cache_size,
            num_workers=num_workers,
        )
        self.k1, self.b = k1, b
        self.device = device
        self.engine_kwargs = engine_kwargs
        self.sparse_engine: Optional[SparseSearchEngine] = None
        self.dense_engine: Optional[DenseSearchEngine] = None
        self.embedding_path = Path(embedding_path) if embedding_path else None
        self.embedding_dim = embedding_dim
        if self.embedding_path and self.embedding_path.exists():
            self._load_embeddings()

    # -- documents ---------------------------------------------------------

    def add_documents(self, docs: Sequence[Document]) -> int:
        return self.store.add_documents(docs)

    def get_document(self, doc_id: str) -> Optional[Document]:
        return self.store.get_document(doc_id)

    def get_documents(self, doc_ids: Sequence[str]) -> List[Optional[Document]]:
        return self.store.get_documents(doc_ids)

    # -- sparse index ------------------------------------------------------

    def build_bm25_index(
        self, corpus: Optional[Mapping[str, Mapping]] = None, **builder_kwargs
    ) -> None:
        """Build the BM25 index from an explicit corpus mapping, or from
        every document in the store."""
        if corpus is None:
            corpus = {
                doc.id: {"text": doc.text, "title": doc.title}
                for doc in self.store.iter_documents()
            }
        if not corpus:
            raise ValueError("Empty corpus provided")
        builder = SparseIndexBuilder(
            method="bm25", k1=self.k1, b=self.b, **builder_kwargs
        )
        index = builder.build(corpus)
        self.sparse_engine = SparseSearchEngine(
            index, device=self.device, **self.engine_kwargs
        )
        logger.info("BM25 index ready: %s", index.stats())

    def search_bm25(
        self, queries: Mapping[str, str], top_k: int = 10
    ) -> Dict[str, Dict[str, float]]:
        if self.sparse_engine is None:
            raise ValueError("BM25 index not built. Call build_bm25_index() first.")
        return self.sparse_engine.search(queries, top_k=top_k)

    # -- dense index ---------------------------------------------------------

    def _load_embeddings(self) -> None:
        try:
            doc_ids = self.store.doc_ids()
            emb = np.asarray(
                load_embeddings(
                    self.embedding_path,
                    num_docs=len(doc_ids) or None,
                    dim=self.embedding_dim,
                )
            )
            if len(doc_ids) != emb.shape[0]:
                doc_ids = [str(i) for i in range(emb.shape[0])]
            self.dense_engine = DenseSearchEngine(
                doc_ids, emb, device=self.device
            )
            logger.info("Loaded embeddings: %s", emb.shape)
        except Exception as e:
            logger.error("Error loading embeddings: %s", e)
            self.dense_engine = None

    def set_embeddings(
        self, doc_ids: Sequence[str], embeddings: np.ndarray, **kwargs
    ) -> None:
        self.dense_engine = DenseSearchEngine(
            doc_ids, embeddings, **{"device": self.device, **kwargs}
        )

    def search_by_vector(
        self,
        query_vector: np.ndarray,
        k: int = 10,
        min_score: float = 0.0,
    ) -> List[Dict[str, Any]]:
        """Dense search for one query vector (reference retrieval.py:402-436
        API: list of {'doc_id', 'score'} above min_score)."""
        if self.dense_engine is None:
            raise ValueError("No embedding index available")
        scores, ids = self.dense_engine.search_vectors(
            np.asarray(query_vector, dtype=np.float32)[None, :], top_k=k
        )
        return [
            {"doc_id": self.dense_engine.doc_ids[int(i)], "score": float(s)}
            for i, s in zip(ids[0], scores[0])
            if s >= min_score
        ]

    # -- results -----------------------------------------------------------

    def get_search_results(
        self,
        hits: Union[Mapping[str, float], Sequence[Mapping[str, Any]]],
        include_text: bool = True,
    ) -> List[Dict[str, Any]]:
        """Join search hits with stored documents."""
        if isinstance(hits, Mapping):
            pairs = list(hits.items())
        else:
            pairs = [(h["doc_id"], h["score"]) for h in hits]
        docs = self.get_documents([d for d, _ in pairs])
        out = []
        for (doc_id, score), doc in zip(pairs, docs):
            if doc is None:
                continue
            rec: Dict[str, Any] = {"id": doc_id, "score": float(score)}
            if include_text:
                rec.update(
                    {"text": doc.text, "title": doc.title, "metadata": doc.metadata}
                )
            out.append(rec)
        return out

    # -- lifecycle / stats ---------------------------------------------------

    def clear_cache(self) -> None:
        self.store.cache.clear()
        if self.sparse_engine is not None:
            self.sparse_engine.clear_cache()

    def get_stats(self) -> Dict[str, Any]:
        stats: Dict[str, Any] = {"store": self.store.get_stats()}
        if self.sparse_engine is not None:
            stats["sparse"] = self.sparse_engine.stats()
        if self.dense_engine is not None:
            stats["dense"] = {
                "num_docs": len(self.dense_engine.doc_ids),
                "dim": self.dense_engine.dim,
                "quantization": self.dense_engine.quantization,
            }
        return stats

    def close(self) -> None:
        self.store.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
