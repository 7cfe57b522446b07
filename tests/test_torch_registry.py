"""The port's RetrieverRegistry (osr_tpu_torch/retrieval/registry.py),
mirrored from tests/test_registries.py (its readers test waits for the
port's readers) and held against osr_tpu's registry route by route, both
on the CPU.

Tolerance: sparse and learned-sparse routes give osr_tpu's result dicts
with scores within rtol 1e-5 and the same ids in the same order except at
near-ties (a neighbour within 1e-5 relative), the rule of
tests/test_torch_engine.py; dense routes (symmetric int8, synthetic
embeddings) the same ids with scores within rtol 1e-6, the rule of
tests/test_torch_dense.py.
"""

import numpy as np
import pytest

from osr_tpu_torch.retrieval.registry import (
    HybridRetriever,
    LearnedSparseRetriever,
    QuantizedDenseRetriever,
    RetrieverRegistry,
    SparseRetriever,
)
from osr_tpu_torch.testing import SyntheticDataGenerator

from tests.reference_impl import zipf_corpus, zipf_queries


def _create(cfg):
    cfg = dict(cfg)
    cfg["params"] = {**(cfg.get("params") or {}), "device": "cpu"}
    return RetrieverRegistry.create(cfg)


@pytest.fixture(scope="module")
def corpus():
    return zipf_corpus(num_docs=120, vocab_size=300, avg_len=30)


def test_sparse_retriever_via_registry(corpus, tmp_path_factory):
    cache = tmp_path_factory.mktemp("rag_cache")
    cfg = {
        "type": "bm25_custom",
        "model": None,
        "params": {"top_k": 50, "k1": 1.2, "b": 0.75, "cache_dir": str(cache)},
    }
    r = _create(cfg)
    r.build_index_from_corpus(corpus)
    res = r.search({"q1": "term200 term250"}, top_k=5)
    assert "q1" in res and len(res["q1"]) > 0
    # cache round-trip: a second build must load from disk and search equally
    assert len(list(cache.iterdir())) == 1
    r2 = _create(cfg)
    r2.build_index_from_corpus(corpus)
    res2 = r2.search({"q1": "term200 term250"}, top_k=5)
    assert list(res["q1"].items()) == pytest.approx(list(res2["q1"].items()))


def test_dense_retriever_via_registry(corpus):
    r = _create(
        {"type": "dpr", "model": "synthetic", "params": {"embedding_dim": 64}}
    )
    assert isinstance(r, QuantizedDenseRetriever)
    r.build_index_from_corpus(corpus)
    assert r.engine.device.type == "cpu"
    res = r.search({"q1": "what is alpha", "q2": ""}, top_k=5)
    assert len(res["q1"]) > 0
    assert res["q2"] == {}


def test_dense_retriever_sparse_scoring_mode(corpus):
    r = _create(
        {"type": "contriever", "params": {"scoring": "sparse", "cache_dir": None}}
    )
    assert isinstance(r, SparseRetriever) and r.method == "tfidf"
    r.build_index_from_corpus(corpus)
    res = r.search({"q1": "term200"}, top_k=5)
    assert len(res["q1"]) > 0


def test_hybrid_retriever(corpus):
    r = _create(
        {
            "type": "hybrid",
            "params": {
                "sparse_weight": 0.3,
                "dense_weight": 0.7,
                "embedding_dim": 64,
                "cache_dir": None,
            },
        }
    )
    assert isinstance(r, HybridRetriever)
    r.build_index_from_corpus(corpus)
    assert r.sparse.engine.device.type == r.dense.engine.device.type == "cpu"
    res = r.search({"q1": "term200 term123"}, top_k=5)
    assert len(res["q1"]) > 0
    scores = list(res["q1"].values())
    assert scores == sorted(scores, reverse=True)


def test_unknown_retriever():
    with pytest.raises(ValueError):
        RetrieverRegistry.create({"type": "nope"})
    with pytest.raises(ValueError):
        RetrieverRegistry.create({"params": {}})


def test_sparse_retriever_plumbs_engine_params():
    """topk_mode / narrow_m / narrow_backend / score_chunk_rows reach the
    engine from retriever params, and ``narrow_backend: xla`` (osr_tpu's
    name for its standard selection) maps to the port's ``torch``."""
    gen = SyntheticDataGenerator(seed=42)
    corpus = gen.zipf_corpus(6000, 20_000, avg_len=60, word_prefix="t")
    queries = gen.queries(8, 20_000, avg_terms=8, word_prefix="t")
    r = _create(
        {
            "type": "bm25",
            "params": {
                "cache_dir": None,
                "narrow_m": 8,
                "narrow_backend": "xla",
                "topk_mode": "approx",
                "score_chunk_rows": 4096,
            },
        }
    )
    r.build_index_from_corpus(corpus)
    assert r.engine.narrow_m == 8
    assert r.engine.narrow_backend == "torch"
    assert r.engine.topk_mode == "approx"
    assert r.engine.stats().get("score_chunks") == 2
    plain = _create({"type": "bm25", "params": {"cache_dir": None}})
    plain.build_index_from_corpus(corpus)
    assert plain.engine.narrow_backend == "torch"
    assert plain.engine.stats().get("score_chunks") is None
    assert r.search(queries, top_k=10) == plain.search(queries, top_k=10)

    ex = _create(
        {"type": "bm25",
         "params": {"cache_dir": None, "narrow_m": 8,
                    "narrow_backend": "extract"}}
    )
    ex.build_index_from_corpus(corpus)
    assert ex.engine.narrow_backend == "extract"
    assert ex.search(queries, top_k=10) == plain.search(queries, top_k=10)


def test_registry_lists_and_registers_custom():
    avail = RetrieverRegistry.list_available()
    assert avail["sparse"] == ["bm25", "bm25_custom", "bm25_retriever", "tfidf"]
    assert avail["quantized_dense"] == ["dpr", "contriever", "splade", "ance"]

    class Custom:
        def __init__(self, **params):
            self.params = params

    RetrieverRegistry.register("my_custom", Custom)
    try:
        r = RetrieverRegistry.create(
            {"type": "my_custom", "params": {"top_k": 3, "alpha": 1}}
        )
        assert isinstance(r, Custom) and r.params == {"alpha": 1}
        assert "my_custom" in RetrieverRegistry.list_available()[
            "registered_custom"
        ]
    finally:
        RetrieverRegistry._retrievers.pop("my_custom", None)


def test_search_before_build_raises():
    for r in (
        SparseRetriever(device="cpu"),
        QuantizedDenseRetriever(method="dpr", device="cpu"),
        LearnedSparseRetriever(vectors={"d": {"a": 1.0}}, device="cpu"),
    ):
        with pytest.raises(ValueError, match="Index not built"):
            r.search({"q": "a"})
    with pytest.raises(ValueError, match="Index not built"):
        HybridRetriever(device="cpu").search({"q": "a"})


# ----------------------------------------------------------------------
# Route by route against osr_tpu
# ----------------------------------------------------------------------


def _learned_vectors(corpus):
    rng = np.random.RandomState(11)
    return {
        d: {t: float(rng.gamma(2.0, 0.7)) for t in sorted(set(rec["text"].split()))}
        for d, rec in corpus.items()
    }


ROUTES = {
    "bm25": ({"type": "bm25"}, "sparse"),
    "bm25_int4": ({"type": "bm25_retriever",
                   "params": {"head_dtype": "int4"}}, "sparse"),
    "tfidf": ({"type": "tfidf"}, "sparse"),
    "dpr_sparse_scoring": ({"type": "dpr", "params": {"scoring": "sparse"}},
                           "sparse"),
    "contriever": ({"type": "contriever",
                    "params": {"embedding_dim": 64}}, "dense"),
    "ance_int4": ({"type": "ance", "params": {
        "embedding_dim": 64, "quantization_method": "int4"}}, "dense"),
    "splade_learned": ({"type": "splade"}, "sparse"),
}


@pytest.fixture(scope="module")
def route_data():
    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(
        1_200, 3_000, avg_len=40, word_prefix="t", min_len=5
    )
    queries = SyntheticDataGenerator(seed=6).queries(
        48, 3_000, avg_terms=6, word_prefix="t", min_terms=2
    )
    queries["empty"] = ""
    return corpus, queries


def _same(got, want, rtol, near_ties):
    assert got.keys() == want.keys()
    for qid, w in want.items():
        g = got[qid]
        assert len(g) == len(w), qid
        ws = np.array(list(w.values()))
        np.testing.assert_allclose(
            np.array(list(g.values())), ws, rtol=rtol, atol=0
        )
        for i, (a, b) in enumerate(zip(g, w)):
            if a == b:
                continue
            assert near_ties, (qid, i)
            near = [j for j in (i - 1, i + 1) if 0 <= j < len(ws)]
            assert i == len(ws) - 1 or any(
                abs(ws[i] - ws[j]) <= rtol * abs(ws[i]) for j in near
            ), (qid, i)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_osr_tpu(route_data, route):
    pytest.importorskip("jax")
    from osr_tpu.retrieval.registry import RetrieverRegistry as JaxRegistry

    corpus, queries = route_data
    cfg, kind = ROUTES[route]
    params = {"cache_dir": None, **cfg.get("params", {})}
    if route == "splade_learned":
        params["vectors"] = _learned_vectors(corpus)
    cfg = {**cfg, "params": params}
    want_r = JaxRegistry.create(cfg)
    want_r.build_index_from_corpus(corpus)
    got_r = _create(cfg)
    assert type(got_r).__name__ == type(want_r).__name__
    got_r.build_index_from_corpus(corpus)
    want = want_r.search(queries, top_k=15)
    got = got_r.search(queries, top_k=15)
    assert sum(1 for v in got.values() if v) >= 40
    if kind == "sparse":
        _same(got, want, 1e-5, near_ties=True)
    else:
        _same(got, want, 1e-6, near_ties=False)
