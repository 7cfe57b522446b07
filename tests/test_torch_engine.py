"""The port's SparseSearchEngine (osr_tpu_torch/retrieval/engine.py) against
osr_tpu's on one index, both on the CPU.

The index is built once by osr_tpu and carried across with
osr_tpu_torch.convert.index_from_arrays. Tolerance: result dicts hold the
same doc ids in the same order, except at positions whose score is within
1e-5 relative of a neighbour's (a near-tie that f32 summation order may
flip), and scores agree to rtol 1e-5 (the head scores of the two engines
differ only in f32 accumulation order; the host merge is shared code).

The plans beyond the standard one (approx, narrowing, the extraction
kernel's plain twin, row chunks) run on a 12,000-document index: with
score_chunk_rows=4,096 it splits into 3 chunks of 4,096 rows, each at
the extraction path's floor (4,096 rows, more than 2 k blocks).
"""

import logging

import numpy as np
import pytest
import torch

import osr_tpu_torch.testing as ttesting
from osr_tpu.index.builder import SparseIndexBuilder
from osr_tpu.retrieval.engine import SparseSearchEngine as JaxEngine
from osr_tpu.testing import SyntheticDataGenerator
from osr_tpu_torch.convert import index_from_arrays
from osr_tpu_torch.retrieval import engine as tengine
from osr_tpu_torch.retrieval.engine import (
    SparseSearchEngine,
    plan_score_chunks,
)

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


def test_port_generator_builds_the_same_corpus(corpus):
    port = ttesting.SyntheticDataGenerator(seed=42).zipf_corpus(
        5_000, VOCAB, avg_len=130, word_prefix="t", min_len=5
    )
    assert port == corpus


# ----------------------------------------------------------------------
# Approx, narrowed, extracted and row-chunked plans
# ----------------------------------------------------------------------

PLAN_K = 10
PLAN_B = 24
CHUNK = 4_096
PLANS = {
    "approx": {"topk_mode": "approx"},
    "narrow": {"narrow_m": 8},
    "extract": {"narrow_m": 8, "narrow_backend": "extract"},
    "chunked": {"score_chunk_rows": CHUNK},
    "extract_chunked": {
        "narrow_m": 8, "narrow_backend": "extract", "score_chunk_rows": CHUNK,
    },
}


@pytest.fixture(scope="module")
def plan_case():
    """12,000 docs (osr_tpu's extraction tests use 10,000: its 1,024-row
    tile pads 3 chunks to 4,096 rows, where the port's 128-row tile would
    give 3,456), 24 queries, int8 and int4 indexes, and osr_tpu's
    standard engine's results on each."""
    gen = SyntheticDataGenerator(seed=42)
    corpus = gen.zipf_corpus(12_000, VOCAB, avg_len=60, word_prefix="t")
    queries = gen.queries(PLAN_B, VOCAB, avg_terms=8, word_prefix="t")
    out = {}
    for dtype in ("int8", "int4"):
        jidx = SparseIndexBuilder(method="bm25", head_dtype=dtype).build(
            corpus
        )
        want = JaxEngine(
            jidx, batch_sizes=(PLAN_B,), cache_queries=False
        ).search(queries, top_k=PLAN_K)
        out[dtype] = (_convert(jidx), want)
    return queries, out


def _plan_engine(tidx, **kwargs):
    return SparseSearchEngine(
        tidx, device="cpu", batch_sizes=(PLAN_B,), cache_queries=False,
        merge_backend="host", **kwargs,
    )


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_plans_match_osr_tpu(plan_case, dtype, plan):
    queries, cases = plan_case
    tidx, want = cases[dtype]
    eng = _plan_engine(tidx, **PLANS[plan])
    chunked = "score_chunk_rows" in PLANS[plan]
    assert (eng._dev.chunks is not None) == chunked
    if chunked:
        assert len(eng._dev.chunks) == 3 and eng._dev.chunk_rows == CHUNK
    extract = PLANS[plan].get("narrow_backend") == "extract"
    assert eng._use_extract(PLAN_K) == (extract and not chunked)
    assert eng._use_extract_chunked(PLAN_K) == (extract and chunked)
    got = eng.search(queries, top_k=PLAN_K)
    assert sum(1 for r in got.values() if r) > 20
    assert_same_results(got, want)
    # Every plan is exact by construction: dict for dict the port's own
    # standard engine of the same chunking (approx and narrow run its
    # selection; extraction must reproduce it).
    if plan != "chunked":
        std = _plan_engine(
            tidx, score_chunk_rows=CHUNK if chunked else 0
        ).search(queries, top_k=PLAN_K)
        assert got == std
    if extract:
        assert eng.stats()["extract_redispatches"] == 0


@pytest.mark.parametrize("chunk", [0, CHUNK])
def test_extract_unsafe_flag_reruns_standard_program(
    plan_case, monkeypatch, chunk
):
    """A raised tie-safety flag re-runs the standard program (chunked or
    not) for the batch: the results are the standard engine's."""
    queries, cases = plan_case
    tidx, _ = cases["int8"]
    real = tengine.fused_search_extract
    calls = {"n": 0}

    def always_unsafe(*args, **kwargs):
        calls["n"] += 1
        top, rows, _ = real(*args, **kwargs)
        return top, rows, torch.tensor(True)

    monkeypatch.setattr(tengine, "fused_search_extract", always_unsafe)
    ex = _plan_engine(
        tidx, narrow_m=8, narrow_backend="extract", score_chunk_rows=chunk
    )
    got = ex.search(queries, top_k=PLAN_K)
    assert calls["n"] == (3 if chunk else 1)
    assert ex.stats()["extract_redispatches"] == 1
    std = _plan_engine(tidx, score_chunk_rows=chunk)
    assert got == std.search(queries, top_k=PLAN_K)


def test_extract_declines_chunks_below_the_floor(plan_case):
    """Chunks of 2,048 rows are below the extraction floor: the engine
    takes the standard chunked program, still right."""
    queries, cases = plan_case
    tidx, want = cases["int8"]
    ex = _plan_engine(
        tidx, narrow_m=8, narrow_backend="extract", score_chunk_rows=2_048
    )
    assert ex._dev.chunks is not None and ex._dev.chunk_rows == 2_048
    assert not ex._use_extract_chunked(PLAN_K)
    assert_same_results(ex.search(queries, top_k=PLAN_K), want)
    assert ex.stats()["extract_redispatches"] == 0


def test_score_chunks_in_stats(plan_case):
    _, cases = plan_case
    tidx, _ = cases["int4"]
    assert _plan_engine(tidx, score_chunk_rows=CHUNK).stats()[
        "score_chunks"
    ] == 3
    assert "score_chunks" not in _plan_engine(tidx).stats()


def test_chunking_needs_the_host_merge(plan_case, caplog):
    _, cases = plan_case
    tidx, _ = cases["int8"]
    with caplog.at_level(logging.WARNING, logger=tengine.__name__):
        eng = SparseSearchEngine(
            tidx, device="cpu", merge_backend="device",
            score_chunk_rows=CHUNK,
        )
    assert eng._dev.chunks is None
    assert "score chunking" in caplog.text


# Rows 100,000 (100,096 at the 128-row tile), a 1 MB head, B_max = 512,
# 256 head columns: the sweep's transients are 4 * 512 = 2,048 bytes a
# row, 3,072 with the plain path's f32 head copy. The budget is half of
# what the head leaves: (free - 1 MB) / 2.
BUDGET_CASES = [
    # (free bytes, plain f32 copy, requested, chunk rows)
    (10**9, False, None, 0),  # 205 MB fits 499.5 MB: one sweep
    (100 * 10**6, False, None, 24_064),  # 49.5 MB / 2,048, tiled
    (100 * 10**6, True, None, 16_000),  # the f32 copy: / 3,072, tiled
    (8 * 10**6, False, None, 4_096),  # the floor
    (None, False, None, 0),  # no device figure: no budget
    (8 * 10**6, False, 5_000, 5_000),  # an explicit size is honoured
    (8 * 10**6, False, 200_000, 0),  # ... unless it covers the head
]


@pytest.mark.parametrize("free,copy,requested,chunk", BUDGET_CASES)
def test_plan_score_chunks(free, copy, requested, chunk):
    rows, need, budget = plan_score_chunks(
        num_rows=100_000, head_bytes=10**6, max_batch=512, head_width=256,
        free_bytes=free, plain_f32_copy=copy, requested=requested,
    )
    assert rows == chunk
    row_bytes = 2_048 + (1_024 if copy else 0)
    sweep = -(-(rows or 100_000) // 128) * 128
    assert need == sweep * row_bytes
    assert budget == (None if free is None else (free - 10**6) // 2)
    if free is not None and requested is None and rows > 4_096:
        assert need <= budget  # an auto chunk above the floor fits


def _tiled(rows):
    return -(-rows // 128) * 128


def _sweep_rows(num_rows, chunk):
    """(rows of each sweep, sweeps) as ``_DeviceIndex`` equalizes the
    chunks."""
    n = -(-num_rows // _tiled(chunk))
    return _tiled(-(-num_rows // n)), n


# Heads that fill about a quarter of the free memory: each sweep keeps
# more 128-row blocks than twice the depth, so every sweep takes the
# block-pruned selection (a budget of a quarter of the free memory with
# the head inside it left them the 4,096-row floor).
HEAD_CASES = {
    # 1M rows x 2,048 int8 columns (2.048 GB) of 8.2 GB free, B = 1,024,
    # top_k 1,000: 3.076 GB / 4,096 B -> 750,976 rows, 2 sweeps of
    # 500,096 rows (3,907 blocks).
    "quarter": (1_000_000, 1_000_064 * 2_048, 1_024, 8_200_000_000, 1_000,
                2),
    # MS MARCO passage: 8,841,823 rows (8,841,856 tiled) x 2,048 (18.1
    # GB), B = 3,496, 84.5 GB free, top_k 1,000: 33.2 GB / 13,984 B ->
    # 2,373,760 rows, 4 sweeps of 2,210,560 rows (17,270 blocks).
    "msmarco": (8_841_823, 8_841_856 * 2_048, 3_496, 84_500_000_000, 1_000,
                4),
}


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_plan_keeps_block_pruning_under_a_large_head(case):
    from osr_tpu_torch.ops.bm25 import block_prune_applies

    num_rows, head_bytes, batch, free, top_k, sweeps = HEAD_CASES[case]
    chunk, need, budget = plan_score_chunks(
        num_rows=num_rows, head_bytes=head_bytes, max_batch=batch,
        head_width=2_048, free_bytes=free, plain_f32_copy=False,
    )
    assert chunk > 0 and need <= budget
    rows, n = _sweep_rows(num_rows, chunk)
    assert n == sweeps
    assert block_prune_applies(rows, top_k), (rows, top_k)
    assert rows * 4 * batch <= budget


# search_token_batch, mirrored from tests/test_sparse_scoring.py's
# test_fused_topk_equals_dense_argsort (ATOL 1e-3, rtol 1e-3 there), and
# held against osr_tpu's on the same index (scores within RTOL; rows equal
# except at near-ties).
@pytest.mark.parametrize("head_terms", [0, 64, None])
def test_search_token_batch_equals_dense_argsort(head_terms):
    from osr_tpu_torch.index.builder import SparseIndexBuilder as TBuilder

    from tests.reference_impl import zipf_corpus, zipf_queries

    corpus = zipf_corpus(num_docs=300, vocab_size=800, avg_len=60)
    texts = list(
        zipf_queries(num_queries=25, vocab_size=800, terms_per_query=6).values()
    )
    index = TBuilder(
        method="bm25", head_terms=head_terms, head_dtype="f32"
    ).build(corpus)
    engine = SparseSearchEngine(index, device="cpu")
    dense = engine.score_all(texts)
    k, atol = 10, 1e-3
    scores, rows = engine.search_token_batch(texts, k)
    assert rows.dtype == np.int32 and scores.shape == (32, k)  # bucket 32
    for i in range(len(texts)):
        want = np.sort(dense[i])[::-1][:k]
        np.testing.assert_allclose(
            np.sort(scores[i])[::-1], want, atol=atol, rtol=1e-3
        )
        got_set = set(rows[i][scores[i] > want[-1] + atol].tolist())
        want_set = set(np.argsort(dense[i])[::-1][:k].tolist())
        assert got_set <= want_set

    jidx = SparseIndexBuilder(
        method="bm25", head_terms=head_terms, head_dtype="f32"
    ).build(corpus)
    j_scores, j_rows = JaxEngine(jidx).search_token_batch(texts, k)
    np.testing.assert_allclose(scores, j_scores, rtol=RTOL, atol=1e-6)
    for r, c in zip(*np.nonzero(rows != j_rows)):
        near = [j for j in (c - 1, c + 1) if 0 <= j < k]
        assert any(
            abs(j_scores[r, c] - j_scores[r, j]) <= RTOL * abs(j_scores[r, c])
            for j in near
        ), (r, c)


# ----------------------------------------------------------------------
# The chunked engine at a small size, against the benchmark's plain
# reference (perfbench/reference/sparse_bm25.py, float64 over the same int8
# head) and against the unchunked engine on the same index
# ----------------------------------------------------------------------

CHUNKED_K = 10
CHUNKED_B = 32


@pytest.fixture(scope="module")
def chunked_case():
    """12,000 docs of the port's generator, the port's int8 index (head of
    512 terms), 64 queries: 3 chunks of 4,096 rows, each of 32 blocks,
    more than twice the depth of 10, so every sweep prunes."""
    from osr_tpu_torch.index.builder import SparseIndexBuilder as TBuilder

    gen = ttesting.SyntheticDataGenerator(seed=5)
    corpus = gen.zipf_corpus(12_000, VOCAB, avg_len=40, word_prefix="t",
                             min_len=5)
    queries = gen.queries(2 * CHUNKED_B, VOCAB, avg_terms=6, word_prefix="t",
                          min_terms=2)
    index = TBuilder(method="bm25", k1=0.82, b=0.68, head_terms=512,
                     head_dtype="int8").build(corpus)
    return corpus, queries, index


def _chunked_engine(index, chunk):
    return SparseSearchEngine(
        index, device="cpu", batch_sizes=(CHUNKED_B,), cache_queries=False,
        merge_backend="host", score_chunk_rows=chunk,
    )


def test_chunked_engine_prunes_every_sweep(chunked_case):
    from osr_tpu_torch.ops.bm25 import block_prune_applies

    _, _, index = chunked_case
    eng = _chunked_engine(index, CHUNK)
    d = eng._dev
    assert len(d.chunks) == 3 and d.chunk_rows == CHUNK
    assert all(h.shape[0] == CHUNK for h, _ in d.chunks)
    assert block_prune_applies(d.chunk_rows, CHUNKED_K)


def test_chunked_engine_equals_unchunked(chunked_case):
    """Rows and scores equal, batch for batch: each chunk's pruned top-k
    holds every global top-k row of the chunk, and the merge orders ties
    toward the lower chunk, so toward the lower row."""
    _, queries, index = chunked_case
    texts = list(queries.values())
    chunked = _chunked_engine(index, CHUNK)
    whole = _chunked_engine(index, 0)
    assert whole._dev.chunks is None
    for i in range(0, len(texts), CHUNKED_B):
        got = chunked.search_token_batch(texts[i:i + CHUNKED_B], CHUNKED_K)
        want = whole.search_token_batch(texts[i:i + CHUNKED_B], CHUNKED_K)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    assert chunked.stats()["counters"]["chunk_sweeps"] == 3 * 2
    assert whole.stats()["counters"]["chunk_sweeps"] == 0


def test_chunked_engine_matches_the_plain_reference(chunked_case):
    """Each answer against the reference's float64 scores: the scores the
    engine returns are the reference's of the same rows, and its i-th row
    scores as the reference's i-th best, both within the benchmark's
    sparse limit (0.008 of the query's scale: the scaled query rounds to
    bf16 in the head product); a row of the reference's exact top-k (ties
    to the lower row) that the engine left out scores within that limit of
    the k-th, and most answers (three quarters) are the reference's rows in
    its order."""
    from perfbench import compare
    from perfbench.reference.sparse_bm25 import SparseReference

    corpus, queries, index = chunked_case
    doc_ids = list(corpus)
    ref = SparseReference([corpus[d]["text"] for d in doc_ids], k1=0.82,
                          b=0.68, head_terms=512)
    texts = list(queries.values())
    scores = ref.scores(texts).numpy()
    got = _chunked_engine(index, CHUNK).search(queries, top_k=CHUNKED_K)
    row_of = {d: r for r, d in enumerate(doc_ids)}
    same = 0
    for j, (qid, text) in enumerate(queries.items()):
        rows = [row_of[d] for d in got[qid]]
        s = scores[j]
        order = np.argsort(-s, kind="stable")[:CHUNKED_K]
        top = np.where(s[order] > 0, s[order], -np.inf)
        gaps = compare.answer_gaps(rows, list(got[qid].values()), s[rows],
                                   top, ref.scale(text), positive_only=True)
        assert max(gaps) <= 0.008, (qid, gaps)
        want = [int(r) for r in order if s[r] > 0]
        same += rows == want
        # A row the engine left out scores within the limit of the k-th.
        kth = s[want[-1]] if want else 0.0
        for r in set(want) - set(rows):
            assert s[r] - kth <= 0.008 * ref.scale(text), (qid, r)
    assert same >= 0.75 * len(queries), same  # 54 of 64 here
