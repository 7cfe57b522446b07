"""Retriever registry — config-driven retriever construction (counterpart
of ``osr_tpu/retrieval/registry.py``: the same routes, parameters and
results, through this package's engines and kernels).

Every retriever takes ``device`` (None means ``cuda``; the tests pass
``"cpu"``) and hands it to its engines. ``narrow_backend: xla``, the name
``osr_tpu`` gives its standard selection, maps to this package's
``torch`` selection (bit-identical results), so a YAML written for
``osr_tpu`` runs here unchanged.

Routing matches the reference registry (reference
rag_system/core/retriever_registry.py:562-626):

- ``bm25`` / ``bm25_custom`` / ``bm25_retriever``  -> sparse BM25
- ``tfidf``                                        -> sparse TF-IDF
- ``dpr`` / ``contriever`` / ``splade``            -> quantized dense
  retriever (synthetic embeddings unless an embedding file is configured)

plus a ``sparse_dpr``-style mode: the reference *pipeline* scores dpr/
contriever/splade experiments with the TF-IDF kernel over the term matrix
(reference evaluate_rag_pipeline.py:392-399); set ``params.scoring='sparse'``
to reproduce that measured configuration, and ``hybrid`` to mix sparse and
dense scores (the ms_marco config's hybrid experiment,
reference rag_system/configs/ms_marco_paper_results.yaml).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from osr_tpu_torch.index.builder import SparseIndexBuilder, extract_text
from osr_tpu_torch.index.dense import (
    load_embeddings,
    synthetic_corpus_embeddings,
    synthetic_query_embedding,
    synthetic_query_embeddings,
)
from osr_tpu_torch.retrieval.engine import DenseSearchEngine, SparseSearchEngine
from osr_tpu_torch.retrieval.fusion import (
    fuse_topk_arrays,
    fused_rows_to_results,
)
from osr_tpu_torch.retrieval.pipeline_util import run_pipelined

logger = logging.getLogger(__name__)

# osr_tpu's selection names -> this package's (results bit-identical).
_NARROW_BACKENDS = {"xla": "torch"}


class SparseRetriever:
    """BM25/TF-IDF retriever: index build + search engine behind the
    reference duck-type ``{build_index_from_corpus, search}``."""

    def __init__(
        self,
        method: str = "bm25",
        model: Optional[str] = None,
        k1: float = 1.2,
        b: float = 0.75,
        head_terms: Optional[int] = None,
        head_dtype: str = "int8",  # 'int4' halves head HBM (test_int4.py)
        cache_dir: Optional[str] = ".rag_cache",
        cache_matrices: bool = True,
        topk_mode: str = "exact",
        narrow_m: int = 0,
        narrow_backend: str = "xla",
        score_chunk_rows: Optional[int] = None,
        device=None,
        **_: Any,
    ):
        self.method = method
        self.model_name = model
        self.builder = SparseIndexBuilder(
            method=method, k1=k1, b=b, head_terms=head_terms,
            head_dtype=head_dtype,
        )
        self.cache_dir = cache_dir if cache_matrices else None
        self.index = None
        # Engine tuning reachable from YAML retriever params (exact vs
        # approx top-k, narrowed/extract selection, score chunking).
        self._engine_kwargs = dict(
            topk_mode=topk_mode,
            narrow_m=narrow_m,
            narrow_backend=_NARROW_BACKENDS.get(narrow_backend, narrow_backend),
            score_chunk_rows=score_chunk_rows,
            device=device,
        )
        self.engine: Optional[SparseSearchEngine] = None

    def build_index_from_corpus(self, corpus: Mapping[str, Any]) -> None:
        if self.cache_dir:
            from osr_tpu_torch.index.cache import load_or_build

            self.index = load_or_build(self.builder, corpus, self.cache_dir)
        else:
            self.index = self.builder.build(corpus)
        self.engine = SparseSearchEngine(self.index, **self._engine_kwargs)

    def search(
        self, queries: Mapping[str, str], top_k: int = 10
    ) -> Dict[str, Dict[str, float]]:
        if self.engine is None:
            raise ValueError(
                "Index not built. Call build_index_from_corpus() first."
            )
        return self.engine.search(queries, top_k=top_k)

    def clear_cache(self) -> None:
        if self.engine is not None:
            self.engine.clear_cache()


class QuantizedDenseRetriever:
    """INT8-quantized dense retriever (reference
    retriever_registry.py:358-559 capability).

    Embeddings come from (in priority order): an explicit ``embedding_fn``,
    an ``embeddings_path`` file of real encoder outputs, or the synthetic
    clustered generator. Query embeddings analogously: ``query_embedding_fn``
    or the deterministic hash-seeded generator.
    """

    def __init__(
        self,
        method: str,
        model: Optional[str] = None,
        embedding_dim: int = 768,
        use_quantization: bool = True,
        quantization_method: str = "symmetric",
        embeddings_path: Optional[str] = None,
        embedding_fn: Optional[Callable] = None,
        query_embedding_fn: Optional[Callable] = None,
        encoder: Optional[str] = None,  # 'hashing' = deterministic
        # lexical encoder (encoders.py:HashingEncoder) — real,
        # YAML-selectable dense quality with no model weights
        device=None,
        **_: Any,
    ):
        if encoder is not None and embedding_fn is None:
            if encoder in ("hashing", "hashing_idf"):
                from osr_tpu_torch.encoders import HashingEncoder

                # 'hashing_idf' fits smooth-IDF feature weights on the
                # corpus at build time (encode()'s first call is the
                # corpus) and applies them to query vectors too.
                enc = HashingEncoder(
                    dim=embedding_dim, idf=(encoder == "hashing_idf")
                )
                embedding_fn = enc.encode
                query_embedding_fn = enc.encode_one
            else:
                raise ValueError(
                    f"Unknown encoder {encoder!r} (use 'hashing', "
                    "'hashing_idf', or pass embedding_fn/embeddings_path "
                    "for neural encoders)"
                )
        self.method = method
        self.model_name = model
        self.embedding_dim = embedding_dim
        self.quantization = (
            quantization_method if use_quantization else "none"
        )
        self.embeddings_path = embeddings_path
        self.embedding_fn = embedding_fn
        self.query_embedding_fn = query_embedding_fn
        self.device = device
        self.engine: Optional[DenseSearchEngine] = None
        self.doc_ids = []

    def build_index_from_corpus(self, corpus: Mapping[str, Any]) -> None:
        self.doc_ids = list(corpus.keys())
        if self.embedding_fn is not None:
            texts = [extract_text(corpus[d]) for d in self.doc_ids]
            embeddings = np.asarray(self.embedding_fn(texts), dtype=np.float32)
        elif self.embeddings_path:
            embeddings = np.asarray(
                load_embeddings(
                    self.embeddings_path,
                    num_docs=len(self.doc_ids),
                    dim=self.embedding_dim,
                )
            )
        else:
            embeddings = synthetic_corpus_embeddings(
                len(self.doc_ids), self.embedding_dim
            )
        self.embedding_dim = embeddings.shape[1]
        self.engine = DenseSearchEngine(
            self.doc_ids, embeddings, quantization=self.quantization,
            device=self.device,
        )

    def embed_query(self, text: str) -> np.ndarray:
        if self.query_embedding_fn is not None:
            return np.asarray(self.query_embedding_fn(text), dtype=np.float32)
        return synthetic_query_embedding(text, self.embedding_dim)

    def embed_queries(self, texts) -> np.ndarray:
        """Batched query embedding, (B, dim) — one vectorized pass when
        on the synthetic generator (identical per-text vectors to
        :meth:`embed_query`); per-text loop for injected fns, which have
        no batch contract."""
        if self.query_embedding_fn is not None:
            return np.stack(
                [
                    np.asarray(self.query_embedding_fn(t), dtype=np.float32)
                    for t in texts
                ]
            )
        return synthetic_query_embeddings(texts, self.embedding_dim)

    def search(
        self, queries: Mapping[str, str], top_k: int = 10
    ) -> Dict[str, Dict[str, float]]:
        if self.engine is None:
            raise ValueError(
                "Index not built. Call build_index_from_corpus() first."
            )
        vectors = {
            qid: self.embed_query(text)
            for qid, text in queries.items()
            if text
        }
        results = self.engine.search(vectors, top_k=top_k)
        for qid in queries:
            results.setdefault(qid, {})
        return results

    def clear_cache(self) -> None:
        pass  # dense engine keeps no query cache


class LearnedSparseRetriever:
    """SPLADE-style retrieval over EXTERNAL learned (term, weight) vectors
    (index/learned.py). The reference lists splade as a benchmark
    method (reference bench/fiqa_benchmark.py:47-52) but never ingests real
    learned vectors; this retriever does.

    Document vectors come from ``vectors`` (an in-memory
    {doc_id: {term: w}} mapping) or ``vectors_path`` (npz/jsonl). Query
    vectors come from ``query_encoder_fn(text) -> {term: w}``,
    ``query_vectors`` ({qid: {term: w}}), or — the degenerate fallback —
    the query's own tokens with weight 1 (sound for SPLADE-style vocab
    overlap, not a replacement for a real query encoder).
    """

    def __init__(
        self,
        vectors: Optional[Mapping[str, Mapping[str, float]]] = None,
        vectors_path: Optional[str] = None,
        query_vectors: Optional[Mapping[str, Mapping[str, float]]] = None,
        query_encoder_fn: Optional[Callable] = None,
        head_terms: Optional[int] = None,
        device=None,
        **_: Any,
    ):
        if vectors is None and vectors_path is None:
            raise ValueError(
                "LearnedSparseRetriever needs `vectors` or `vectors_path` "
                "(without learned vectors, route splade to the tfidf "
                "fallback: params.scoring='sparse')"
            )
        from osr_tpu_torch.index.learned import LearnedSparseIndexBuilder

        self._builder = LearnedSparseIndexBuilder(head_terms=head_terms)
        self._source = vectors if vectors is not None else vectors_path
        self.query_vectors = query_vectors or {}
        self.query_encoder_fn = query_encoder_fn
        self.device = device
        self.index = None
        self.engine: Optional[SparseSearchEngine] = None

    def build_index_from_corpus(
        self, corpus: Optional[Mapping[str, Any]] = None
    ) -> None:
        """``corpus`` is accepted for duck-type compatibility; the index is
        built from the learned vectors (their doc ids are authoritative)."""
        self.index = self._builder.build(self._source)
        self.engine = SparseSearchEngine(self.index, device=self.device)

    def _query_vec(self, qid: str, text: str) -> Mapping[str, float]:
        if qid in self.query_vectors:
            return self.query_vectors[qid]
        if self.query_encoder_fn is not None:
            return self.query_encoder_fn(text)
        from osr_tpu_torch.index.tokenizer import term_counts

        return dict(term_counts(text))

    def search(
        self, queries: Mapping[str, str], top_k: int = 10
    ) -> Dict[str, Dict[str, float]]:
        if self.engine is None:
            raise ValueError(
                "Index not built. Call build_index_from_corpus() first."
            )
        weighted = {
            qid: self._query_vec(qid, text or "")
            for qid, text in queries.items()
        }
        return self.engine.search_weighted(weighted, top_k=top_k)

    def clear_cache(self) -> None:
        if self.engine is not None:
            self.engine.clear_cache()


class HybridRetriever:
    """Weighted late fusion of a sparse and a dense retriever
    (capability of the reference's ms_marco hybrid experiment:
    sparse 0.3 + dense 0.7, reference configs/ms_marco_paper_results.yaml).

    Fast path: one pass over the query dict (tokenize + embed together),
    BOTH engines' device steps dispatched back-to-back so they are in
    flight while the sparse host tail work runs, then a vectorized
    array-level fusion (retrieval/fusion.py) — no intermediate
    result dicts. The r3 dict-fusion implementation measured 13x slower
    than the sparse engine alone; it is kept as ``_search_dicts`` as the
    semantics oracle (tests/test_torch_fusion.py parity tests)."""

    def __init__(
        self,
        sparse_weight: float = 0.3,
        dense_weight: float = 0.7,
        fusion_depth: int = 100,
        fusion: str = "weighted",
        rrf_k: float = 60.0,
        **params: Any,
    ):
        if fusion not in ("weighted", "rrf"):
            raise ValueError(f"unknown fusion mode: {fusion!r}")
        self.sparse_weight = sparse_weight
        self.dense_weight = dense_weight
        self.fusion_depth = fusion_depth
        self.fusion = fusion
        self.rrf_k = rrf_k
        self.sparse = SparseRetriever(method="bm25", **params)
        self.dense = QuantizedDenseRetriever(method="hybrid_dense", **params)

    def set_fusion(
        self,
        sparse_weight: float = None,
        dense_weight: float = None,
        fusion: str = None,
        rrf_k: float = None,
    ) -> None:
        """Retune fusion at search time — weights/mode are applied during
        fusion, not indexing, so sweeps never rebuild either index."""
        if fusion is not None:
            if fusion not in ("weighted", "rrf"):
                raise ValueError(f"unknown fusion mode: {fusion!r}")
            self.fusion = fusion
        if sparse_weight is not None:
            self.sparse_weight = sparse_weight
        if dense_weight is not None:
            self.dense_weight = dense_weight
        if rrf_k is not None:
            self.rrf_k = rrf_k

    def build_index_from_corpus(self, corpus: Mapping[str, Any]) -> None:
        self.sparse.build_index_from_corpus(corpus)
        self.dense.build_index_from_corpus(corpus)
        # Array fusion merges on integer doc indices — both engines must
        # agree on the corpus ordering (they do: both preserve corpus
        # insertion order; this guards against a future builder change).
        assert self.sparse.engine.index.doc_ids == self.dense.engine.doc_ids

    @staticmethod
    def _minmax(scores: Dict[str, float]) -> Dict[str, float]:
        if not scores:
            return {}
        vals = list(scores.values())
        lo, hi = min(vals), max(vals)
        span = (hi - lo) or 1.0
        return {d: (s - lo) / span for d, s in scores.items()}

    def _search_dicts(
        self, queries: Mapping[str, str], top_k: int = 10
    ) -> Dict[str, Dict[str, float]]:
        """Dict-level fusion — the r3 implementation, kept as the
        semantics oracle for the array fast path. Whitespace-only queries
        normalize to empty here exactly as in the fast path (the dense
        engine would otherwise embed the raw whitespace string)."""
        norm = {q: (t or "").strip() for q, t in queries.items()}
        s_res = self.sparse.search(norm, top_k=self.fusion_depth)
        d_res = self.dense.search(norm, top_k=self.fusion_depth)
        out: Dict[str, Dict[str, float]] = {}
        for qid in queries:
            fused: Dict[str, float] = {}
            for res, weight in (
                (s_res.get(qid, {}), self.sparse_weight),
                (d_res.get(qid, {}), self.dense_weight),
            ):
                if self.fusion == "rrf":
                    # Engine result dicts are already in descending-score
                    # order; a stable re-sort preserves their tie order.
                    ranked_docs = sorted(
                        res.items(), key=lambda kv: -kv[1]
                    )
                    leg = {
                        doc: weight / (self.rrf_k + rank)
                        for rank, (doc, _) in enumerate(ranked_docs, 1)
                    }
                else:
                    leg = {
                        doc: weight * s
                        for doc, s in self._minmax(res).items()
                    }
                for doc, s in leg.items():
                    fused[doc] = fused.get(doc, 0.0) + s
            ranked = sorted(fused.items(), key=lambda kv: -kv[1])[:top_k]
            out[qid] = dict(ranked)
        return out

    def search(
        self, queries: Mapping[str, str], top_k: int = 10
    ) -> Dict[str, Dict[str, float]]:
        sp = self.sparse.engine
        de = self.dense.engine
        if sp is None or de is None:
            raise ValueError(
                "Index not built. Call build_index_from_corpus() first."
            )
        results: Dict[str, Dict[str, float]] = {}
        pending: List[Tuple[str, str]] = []
        for qid, text in queries.items():
            text = (text or "").strip()
            if text:
                pending.append((qid, text))
            else:
                results[qid] = {}

        # The sparse engine's object-dtype name array, built once with the
        # engine: rebuilding the O(N) array per batch would cost tens of ms
        # at 1M docs.
        doc_ids = sp._doc_names
        depth = self.fusion_depth

        def dispatch(chunk):
            texts = [t for _, t in chunk]
            # Dense first: its device step has no host stage, so it rides
            # the device while the sparse host work (tokenize + tail
            # postings) runs below.
            vecs = self.dense.embed_queries(texts)
            d_handle = de.dispatch_vectors(vecs, depth)
            enc = sp.encode_queries(texts)
            return sp.search_encoded_device(enc, depth), d_handle

        def collect(chunk, handles):
            s_handle, d_handle = handles
            s_scores, s_ids = sp.finish_batch(s_handle, depth)
            d_scores, d_ids = de.collect_vectors(d_handle)
            n = len(chunk)  # sparse rows are padded to the batch bucket
            f_sc, f_ids = fuse_topk_arrays(
                s_scores[:n],
                s_ids[:n],
                d_scores,
                d_ids,
                self.sparse_weight,
                self.dense_weight,
                top_k,
                mode=self.fusion,
                rrf_k=self.rrf_k,
            )
            results.update(
                fused_rows_to_results(
                    [q for q, _ in chunk], f_sc, f_ids, doc_ids
                )
            )

        # Depth 2 (vs the sparse engine's 4): each in-flight entry holds
        # TWO device result buffers (sparse + dense).
        run_pipelined(
            pending, sp.batch_sizes[-1], dispatch, collect, depth=2
        )
        return results

    def clear_cache(self) -> None:
        self.sparse.clear_cache()
        self.dense.clear_cache()


class RetrieverRegistry:
    """Config-driven factory matching reference retriever_registry.py:562."""

    _retrievers: Dict[str, Any] = {}

    SPARSE_METHODS = ("bm25", "bm25_custom", "bm25_retriever", "tfidf")
    DENSE_METHODS = ("dpr", "contriever", "splade", "ance")

    @classmethod
    def register(cls, name: str, retriever_class) -> None:
        cls._retrievers[name] = retriever_class

    @classmethod
    def create(cls, config) -> Any:
        if isinstance(config, str):
            method, model, params = config, None, {}
        else:
            method = config.get("type", config.get("name"))
            model = config.get("model")
            # YAML `params:` with no value parses to None — treat as empty.
            params = dict(config.get("params") or {})
        if not method:
            raise ValueError("Retriever name/type not specified")
        m = method.lower()
        params.pop("top_k", None)  # search-time parameter, not constructor
        if m in cls.SPARSE_METHODS:
            return SparseRetriever(method=m, model=model, **params)
        if m == "splade" and (
            "vectors" in params or "vectors_path" in params
        ):
            # Real learned-sparse ingestion when external vectors are given.
            return LearnedSparseRetriever(**params)
        if m in cls.DENSE_METHODS:
            scoring = params.pop("scoring", "dense")
            if scoring == "sparse":
                # Reproduce the reference *pipeline*'s measured configuration:
                # dpr/contriever/splade scored by the TF-IDF sparse kernel
                # (reference evaluate_rag_pipeline.py:392-399).
                return SparseRetriever(method="tfidf", model=model, **params)
            return QuantizedDenseRetriever(method=m, model=model, **params)
        if m == "hybrid":
            return HybridRetriever(**params)
        if method in cls._retrievers:
            return cls._retrievers[method](**params)
        raise ValueError(f"Unknown retriever method: {method}")

    @classmethod
    def list_available(cls) -> Dict[str, Any]:
        return {
            "sparse": list(cls.SPARSE_METHODS),
            "quantized_dense": list(cls.DENSE_METHODS),
            "hybrid": ["hybrid"],
            "registered_custom": list(cls._retrievers.keys()),
        }
