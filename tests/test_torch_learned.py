"""The port's learned-sparse ingestion (osr_tpu_torch/index/learned.py),
mirrored from tests/test_learned_sparse.py, with ``search_weighted``
results held against osr_tpu's on the same vectors.

Tolerance: the dot-product oracle within rel/abs 1e-4 (f32 head), as
tests/test_learned_sparse.py holds osr_tpu's; against osr_tpu, scores
within rtol 1e-5 and the same ids in the same order except at near-ties,
the rule of tests/test_torch_engine.py. The built layouts are bit-equal.
"""

import json

import numpy as np
import pytest

from osr_tpu_torch.index.learned import (
    LearnedSparseIndexBuilder,
    load_learned_vectors,
)
from osr_tpu_torch.retrieval.engine import SparseSearchEngine
from osr_tpu_torch.retrieval.registry import (
    LearnedSparseRetriever,
    RetrieverRegistry,
    SparseRetriever,
)


def synthetic_learned_vectors(n_docs=120, n_terms=300, seed=0):
    """SPLADE-shaped vectors: sparse non-negative expansions."""
    rng = np.random.RandomState(seed)
    vecs = {}
    for d in range(n_docs):
        n = rng.randint(5, 40)
        terms = rng.choice(n_terms, size=n, replace=False)
        ws = rng.gamma(2.0, 0.7, size=n).astype(np.float32)
        vecs[f"doc{d}"] = {f"tok{t}": float(w) for t, w in zip(terms, ws)}
    return vecs


def dense_oracle(vecs, query):
    """score(q, d) = sum_t w_q(t) * w_d(t) — the learned-sparse dot."""
    return {
        did: sum(w * v.get(t, 0.0) for t, w in query.items())
        for did, v in vecs.items()
    }


def _engine(index):
    return SparseSearchEngine(index, device="cpu", cache_queries=False)


@pytest.fixture(scope="module")
def vectors():
    return synthetic_learned_vectors()


@pytest.fixture(scope="module")
def queries():
    rng = np.random.RandomState(7)
    out = {}
    for i in range(12):
        terms = rng.choice(300, size=rng.randint(2, 8), replace=False)
        out[f"q{i}"] = {
            f"tok{t}": float(rng.gamma(2.0, 0.7)) for t in terms
        }
    return out


@pytest.mark.parametrize("head_terms", [0, 64, None])
def test_learned_sparse_matches_dot_oracle(vectors, queries, head_terms):
    index = LearnedSparseIndexBuilder(
        head_terms=head_terms, head_dtype="f32"
    ).build(vectors)
    assert index.method == "splade"
    res = _engine(index).search_weighted(queries, top_k=10)
    for qid, qvec in queries.items():
        oracle = dense_oracle(vectors, qvec)
        want = dict(
            sorted(
                ((d, s) for d, s in oracle.items() if s > 0),
                key=lambda kv: -kv[1],
            )[:10]
        )
        got = res[qid]
        assert set(got) == set(want), qid
        for d, s in want.items():
            assert got[d] == pytest.approx(s, rel=1e-4, abs=1e-4)


def test_learned_sparse_int8_ranking(vectors, queries):
    r32 = _engine(
        LearnedSparseIndexBuilder(head_dtype="f32").build(vectors)
    ).search_weighted(queries, top_k=10)
    r8 = _engine(
        LearnedSparseIndexBuilder(head_dtype="int8").build(vectors)
    ).search_weighted(queries, top_k=10)
    overlaps = [
        len(set(r32[q]) & set(r8[q])) / max(len(r32[q]), len(r8[q]), 1)
        for q in queries
        if r32[q] or r8[q]
    ]
    assert np.mean(overlaps) >= 0.9


def test_negative_weights_rejected(vectors):
    bad = dict(vectors)
    bad["neg"] = {"tok0": -1.0}
    with pytest.raises(ValueError, match="non-negative"):
        LearnedSparseIndexBuilder().build(bad)


def test_jsonl_and_npz_loaders(tmp_path, vectors, queries):
    p = tmp_path / "vecs.jsonl"
    with open(p, "w") as f:
        for did, v in vectors.items():
            f.write(json.dumps({"id": did, "vector": v}) + "\n")
    doc_ids, terms, indptr, tids, ws = load_learned_vectors(p)
    assert doc_ids == list(vectors.keys())
    assert int(indptr[-1]) == sum(len(v) for v in vectors.values())

    pz = tmp_path / "vecs.npz"
    np.savez(
        pz,
        doc_ids_json=json.dumps(doc_ids),
        vocab_json=json.dumps(terms),
        indptr=indptr,
        term_ids=tids,
        weights=ws,
    )
    r = RetrieverRegistry.create(
        {"type": "splade", "params": {"vectors_path": str(pz), "device": "cpu"}}
    )
    assert isinstance(r, LearnedSparseRetriever)
    r.build_index_from_corpus({})
    r.query_vectors = queries
    res = r.search({qid: "" for qid in queries}, top_k=5)
    oracle_top = dense_oracle(vectors, queries["q0"])
    best = max(oracle_top, key=oracle_top.get)
    assert best in res["q0"]


def test_splade_without_vectors_still_routes_to_tfidf():
    r = RetrieverRegistry.create(
        {"type": "splade", "params": {"scoring": "sparse", "cache_dir": None}}
    )
    assert isinstance(r, SparseRetriever)
    with pytest.raises(ValueError, match="vectors"):
        LearnedSparseRetriever()


def test_query_vector_sources(vectors):
    """Explicit query vectors win over an encoder, which wins over the
    query's own tokens."""
    r = LearnedSparseRetriever(
        vectors=vectors,
        query_vectors={"a": {"tok1": 2.0}},
        query_encoder_fn=lambda text: {"tok2": 1.0},
        device="cpu",
    )
    assert r._query_vec("a", "tok9") == {"tok1": 2.0}
    assert r._query_vec("b", "tok9") == {"tok2": 1.0}
    r.query_encoder_fn = None
    assert r._query_vec("b", "tok9 tok9 tok3") == {"tok9": 2, "tok3": 1}


# ----------------------------------------------------------------------
# Against osr_tpu
# ----------------------------------------------------------------------


@pytest.mark.parametrize("head_dtype", ["int8", "int4", "f32"])
@pytest.mark.parametrize("head_terms", [0, 64, None])
def test_search_weighted_matches_osr_tpu(vectors, queries, head_dtype,
                                         head_terms):
    pytest.importorskip("jax")
    from osr_tpu.index.learned import (
        LearnedSparseIndexBuilder as JaxBuilder,
    )
    from osr_tpu.retrieval.engine import SparseSearchEngine as JaxEngine

    kw = dict(head_terms=head_terms, head_dtype=head_dtype)
    jidx = JaxBuilder(**kw).build(vectors)
    tidx = LearnedSparseIndexBuilder(**kw).build(vectors)
    assert tidx.vocabulary == jidx.vocabulary
    assert tidx.layout.head.tobytes() == jidx.layout.head.tobytes()
    np.testing.assert_array_equal(tidx.layout.post_weights,
                                  jidx.layout.post_weights)
    weighted = {**queries, "empty": {}}
    want = JaxEngine(jidx, cache_queries=False).search_weighted(
        weighted, top_k=10
    )
    got = _engine(tidx).search_weighted(weighted, top_k=10)
    assert got.keys() == want.keys() and got["empty"] == {}
    for qid, w in want.items():
        g = got[qid]
        assert len(g) == len(w), qid
        ws = np.array(list(w.values()))
        np.testing.assert_allclose(
            np.array(list(g.values())), ws, rtol=1e-5, atol=0
        )
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                near = [j for j in (i - 1, i + 1) if 0 <= j < len(ws)]
                assert i == len(ws) - 1 or any(
                    abs(ws[i] - ws[j]) <= 1e-5 * abs(ws[i]) for j in near
                ), (qid, i)
