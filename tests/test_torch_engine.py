"""The port's SparseSearchEngine (osr_tpu_torch/retrieval/engine.py) against
osr_tpu's on one index, both on the CPU.

The index is built once by osr_tpu and carried across with
osr_tpu_torch.convert.index_from_arrays. Tolerance: result dicts hold the
same doc ids in the same order, except at positions whose score is within
1e-5 relative of a neighbour's (a near-tie that f32 summation order may
flip), and scores agree to rtol 1e-5 (the head scores of the two engines
differ only in f32 accumulation order; the host merge is shared code).
"""

import numpy as np
import pytest

import osr_tpu_torch.testing as ttesting
from osr_tpu.index.builder import SparseIndexBuilder
from osr_tpu.retrieval.engine import SparseSearchEngine as JaxEngine
from osr_tpu.testing import SyntheticDataGenerator
from osr_tpu_torch.convert import index_from_arrays
from osr_tpu_torch.retrieval.engine import SparseSearchEngine

VOCAB = 20_000
RTOL = 1e-5


@pytest.fixture(scope="module")
def corpus():
    return SyntheticDataGenerator(seed=42).zipf_corpus(
        5_000, VOCAB, avg_len=130, word_prefix="t", min_len=5
    )


@pytest.fixture(scope="module")
def queries():
    return SyntheticDataGenerator(seed=6).queries(
        96, VOCAB, avg_terms=11, word_prefix="t", min_terms=2
    )


def _convert(index):
    lay = index.layout
    return index_from_arrays(
        head=lay.head, head_scales=lay.head_scales, post_ptr=lay.post_ptr,
        post_rows=lay.post_rows, post_weights=lay.post_weights,
        valid=lay.valid, num_docs=lay.num_docs, vocab_size=lay.vocab_size,
        head_terms=lay.head_terms, head_dtype=lay.head_dtype,
        vocabulary=index.vocabulary, doc_ids=index.doc_ids,
        method=index.method, idf=index.idf, doc_lengths=index.doc_lengths,
        avgdl=index.avgdl, k1=index.k1, b=index.b,
    )


@pytest.fixture(scope="module")
def indexes(corpus):
    out = {}
    for dtype in ("int8", "int4"):
        jidx = SparseIndexBuilder(head_dtype=dtype).build(corpus)
        out[dtype] = (jidx, _convert(jidx))
    return out


def assert_same_results(got, want):
    assert got.keys() == want.keys()
    for qid, w in want.items():
        g = got[qid]
        assert len(g) == len(w), qid
        g_ids, g_s = list(g), np.array(list(g.values()))
        w_ids, w_s = list(w), np.array(list(w.values()))
        np.testing.assert_allclose(g_s, w_s, rtol=RTOL)
        for i, (a, b) in enumerate(zip(g_ids, w_ids)):
            if a == b:
                continue
            near = [
                j for j in (i - 1, i + 1) if 0 <= j < len(w_s)
            ]
            tied = any(
                abs(w_s[i] - w_s[j]) <= RTOL * abs(w_s[i]) for j in near
            ) or i == len(w_s) - 1
            assert tied, (qid, i, a, b, w_s[max(0, i - 1) : i + 2])


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("top_k", [10, 1000])
@pytest.mark.parametrize("merge", ["host", "device"])
def test_search_matches_osr_tpu(indexes, queries, dtype, top_k, merge):
    jidx, tidx = indexes[dtype]
    want = JaxEngine(jidx, merge_backend=merge, cache_queries=False).search(
        queries, top_k=top_k
    )
    eng = SparseSearchEngine(
        tidx, device="cpu", merge_backend=merge, cache_queries=False
    )
    assert eng.head_backend == "torch"
    got = eng.search(queries, top_k=top_k)
    assert sum(1 for r in got.values() if r) > 80
    assert_same_results(got, want)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_search_weighted_matches_osr_tpu(indexes, queries, dtype):
    jidx, tidx = indexes[dtype]
    rng = np.random.RandomState(9)
    weighted = {
        qid: {t: float(rng.randint(1, 6)) / 2 for t in text.split()}
        for qid, text in list(queries.items())[:40]
    }
    weighted["empty"] = {}
    want = JaxEngine(jidx).search_weighted(weighted, top_k=10)
    got = SparseSearchEngine(tidx, device="cpu").search_weighted(
        weighted, top_k=10
    )
    assert got["empty"] == {}
    assert_same_results(got, want)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_score_all_matches_osr_tpu(indexes, queries, dtype):
    jidx, tidx = indexes[dtype]
    texts = list(queries.values())[:20]
    want = JaxEngine(jidx).score_all(texts)
    got = SparseSearchEngine(tidx, device="cpu").score_all(texts)
    assert got.shape == want.shape == (20, jidx.num_docs)
    # Head scores differ only in f32 summation order over <= F terms.
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


def test_query_cache_and_stats(indexes, queries):
    _, tidx = indexes["int8"]
    eng = SparseSearchEngine(tidx, device="cpu", query_cache_limit=5)
    sub = dict(list(queries.items())[:8])
    first = eng.search(sub, top_k=10)
    assert eng.stats()["query_cache_size"] == 5
    assert eng.search(sub, top_k=10) == first
    assert eng.search({"e": "", "oov": "zzzz qqqq"}, top_k=5) == {
        "e": {}, "oov": {},
    }
    assert eng.stats()["device"] == "cpu"


def test_cuda_backend_refused_on_cpu(indexes):
    _, tidx = indexes["int8"]
    with pytest.raises(ValueError, match="head_backend='cuda'"):
        SparseSearchEngine(tidx, device="cpu", head_backend="cuda")


@pytest.mark.parametrize(
    "kwargs",
    [
        {"topk_mode": "approx"},
        {"narrow_m": 8},
        {"narrow_backend": "extract"},
        {"score_chunk_rows": 1024},
    ],
)
def test_unported_plans_refused(indexes, kwargs):
    _, tidx = indexes["int8"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 4"):
        SparseSearchEngine(tidx, device="cpu", **kwargs)


def test_port_generator_builds_the_same_corpus(corpus):
    port = ttesting.SyntheticDataGenerator(seed=42).zipf_corpus(
        5_000, VOCAB, avg_len=130, word_prefix="t", min_len=5
    )
    assert port == corpus
