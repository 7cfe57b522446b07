"""The engines' spans and counters (``osr_tpu_torch/retrieval/engine.py``,
``utils/timing.py:span``) on the CPU: a ``record_function`` range a
stage of a batch or a request while a profiler runs, none otherwise; the
sparse engine's counts of queries, batches, tail candidates,
re-dispatches and row-chunk sweeps; and ``bench/common.py:batch_stages``, which reads the
spans of one served ``search``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from osr_tpu_torch.bench import common
from osr_tpu_torch.index.builder import SparseIndexBuilder
from osr_tpu_torch.retrieval import engine as tengine
from osr_tpu_torch.retrieval.engine import (
    DenseSearchEngine,
    SparseSearchEngine,
)
from osr_tpu_torch.testing import SyntheticDataGenerator
from osr_tpu_torch.utils.timing import span

VOCAB = 12_000
BATCH = 32
SPARSE_STAGES = ("encode", "tail_walk", "dispatch", "cand_dots", "wait",
                 "merge", "dicts")


@pytest.fixture(scope="module")
def index():
    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(
        5_000, VOCAB, avg_len=60, word_prefix="t", min_len=5
    )
    return SparseIndexBuilder(head_terms=512).build(corpus)


@pytest.fixture(scope="module")
def queries():
    return SyntheticDataGenerator(seed=6).queries(
        48, VOCAB, avg_terms=8, word_prefix="t", min_terms=2
    )


def _engine(index, **kw):
    return SparseSearchEngine(index, device="cpu", batch_sizes=(BATCH,),
                              cache_queries=False, **kw)


def _osr_spans(fn):
    """(name, thread, start ns, end ns) of every ``osr.*`` range that
    ``fn`` opens under a CPU profiler, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    spans = [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("osr.")]
    return sorted(spans, key=lambda s: s[2])


def _count(spans, name):
    return sum(s[0] == name for s in spans)


def _inside(inner, outer):
    return (inner[1] == outer[1] and outer[2] <= inner[2]
            and inner[3] <= outer[3])


def test_no_profiler_enters_no_record_function(index, queries, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert span("osr.a") is span("osr.b")
    got = _engine(index).search(queries, top_k=10)
    assert sum(1 for r in got.values() if r) > 40
    dense = DenseSearchEngine([f"d{i}" for i in range(64)],
                              np.eye(64, dtype=np.float32), device="cpu")
    assert list(dense.search({"r": np.eye(64)[3]}, top_k=2)["r"]) == ["d3"]


@pytest.mark.parametrize("filter_per_query", [2048, 1])
def test_sparse_search_spans_a_stage_once_a_batch(index, queries,
                                                  filter_per_query):
    """48 queries in batches of 32: one ``osr.sparse.search``, each stage
    twice inside it on its thread; the tail walk and (without the tau
    filter) the candidate dots inside the dispatch. With a gate of 1 the
    tau filter runs on every batch and the candidate dots move after the
    wait."""
    eng = _engine(index, cand_filter_per_query=filter_per_query)
    spans = _osr_spans(lambda: eng.search(queries, top_k=10))
    whole = [s for s in spans if s[0] == "osr.sparse.search"]
    assert len(whole) == 1
    batches = -(-len(queries) // BATCH)
    for stage in SPARSE_STAGES:
        assert _count(spans, "osr.sparse." + stage) == batches, stage
    assert _count(spans, "osr.sparse.redispatch") == 0
    tau = filter_per_query == 1
    assert _count(spans, "osr.sparse.tau_filter") == (batches if tau else 0)
    assert len(spans) == 1 + batches * (len(SPARSE_STAGES) + tau)
    assert all(_inside(s, whole[0]) for s in spans)
    dispatches = [s for s in spans if s[0] == "osr.sparse.dispatch"]
    for s in spans:
        in_dispatch = any(_inside(s, d) for d in dispatches)
        if s[0] in ("osr.sparse.tail_walk",):
            assert in_dispatch
        elif s[0] == "osr.sparse.cand_dots":
            assert in_dispatch != tau
        elif s[0] != "osr.sparse.dispatch":
            assert not in_dispatch, s[0]


def test_search_weighted_spans_a_stage_once_a_batch(index, queries):
    weighted = {q: {t: 1.0 for t in text.split()}
                for q, text in queries.items()}
    eng = _engine(index)
    spans = _osr_spans(lambda: eng.search_weighted(weighted, top_k=10))
    assert _count(spans, "osr.sparse.search") == 1
    for stage in SPARSE_STAGES:
        assert _count(spans, "osr.sparse." + stage) == 2, stage


def test_extraction_rerun_spans_and_counts(index, queries, monkeypatch):
    """A raised tie-safety flag re-runs each batch under
    ``osr.sparse.redispatch``; ``stats()`` counts it in both places."""
    real = tengine.fused_search_extract

    def always_unsafe(*args, **kwargs):
        top, rows, _ = real(*args, **kwargs)
        return top, rows, torch.tensor(True)

    monkeypatch.setattr(tengine, "fused_search_extract", always_unsafe)
    eng = _engine(index, head_backend="torch", merge_backend="host",
                  narrow_m=8, narrow_backend="extract", score_chunk_rows=0)
    assert eng._use_extract(10)
    spans = _osr_spans(lambda: eng.search(queries, top_k=10))
    assert _count(spans, "osr.sparse.redispatch") == 2
    stats = eng.stats()
    assert stats["extract_redispatches"] == 2
    assert stats["counters"]["redispatches"] == 2


def test_chunked_search_spans_each_chunk_once_a_batch(index, queries):
    """5,000 docs in chunks of 2,048 rows (3 sweeps), 48 queries in
    batches of 32: ``osr.sparse.chunk`` opens once a chunk of a batch and
    ``osr.sparse.chunk_merge`` once a batch, both inside the batch's
    dispatch; ``chunk_sweeps`` counts every sweep."""
    eng = _engine(index, merge_backend="host", score_chunk_rows=2_048)
    assert len(eng._dev.chunks) == 3
    spans = _osr_spans(lambda: eng.search(queries, top_k=10))
    batches = -(-len(queries) // BATCH)
    assert _count(spans, "osr.sparse.chunk") == 3 * batches
    assert _count(spans, "osr.sparse.chunk_merge") == batches
    dispatches = [s for s in spans if s[0] == "osr.sparse.dispatch"]
    assert len(dispatches) == batches
    for d in dispatches:
        inner = [s[0] for s in spans if s[0] in (
            "osr.sparse.chunk", "osr.sparse.chunk_merge") and _inside(s, d)]
        assert inner == ["osr.sparse.chunk"] * 3 + ["osr.sparse.chunk_merge"]
    c = eng.stats()["counters"]
    assert c["chunk_sweeps"] == 3 * batches and c["batches"] == batches


def test_dense_search_spans_one_request(queries):
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((500, 32)).astype(np.float32)
    eng = DenseSearchEngine([str(i) for i in range(500)], emb, device="cpu")
    spans = _osr_spans(lambda: eng.search({"r": emb[7], "s": emb[9]},
                                          top_k=5))
    assert [s[0] for s in spans] == [
        "osr.dense.search", "osr.dense.dispatch", "osr.dense.upload",
        "osr.dense.wait", "osr.dense.dicts"]
    whole, dispatch, upload = spans[:3]
    assert all(_inside(s, whole) for s in spans)
    assert _inside(upload, dispatch)
    assert not _inside(spans[3], dispatch)


def test_counters_sum_the_batches(index, queries):
    """Across two calls: ``queries`` the real rows dispatched (an empty
    query and, with the cache, a repeated one dispatch nothing),
    ``batches``, and ``tail_candidates`` the per-batch ``cand.total``."""
    eng = SparseSearchEngine(index, device="cpu", batch_sizes=(BATCH,))
    first = dict(queries)
    first["blank"] = "  "
    second = dict(list(queries.items())[:10])
    second.update({f"n{i}": f"t{i + 3} t{2 * i + 40}" for i in range(30)})
    want_cand = 0
    for call in (first, second):
        texts = [t for t in call.values() if t.strip()]
        if call is second:
            texts = texts[10:]  # the first ten hit the query cache
        for i in range(0, len(texts), BATCH):
            enc = eng.encode_queries(texts[i:i + BATCH])
            want_cand += eng._tail_candidates(enc, BATCH).total
    assert eng.stats()["counters"] == dict.fromkeys(
        ("queries", "batches", "tail_candidates", "redispatches",
         "chunk_sweeps"), 0)
    eng.search(first, top_k=10)
    eng.search(second, top_k=10)
    assert eng.stats()["counters"] == {
        "queries": 48 + 30, "batches": 2 + 1,
        "tail_candidates": want_cand, "redispatches": 0, "chunk_sweeps": 0}
    assert want_cand > 0


def test_span_self_ms_nests_by_thread():
    ms = 1_000_000
    events = [
        ("osr.x.search", 1, 0, 10 * ms),
        ("osr.x.dispatch", 1, 1 * ms, 4 * ms),
        ("osr.x.walk", 1, 2 * ms, 3 * ms),
        ("osr.x.merge", 1, 5 * ms, 9 * ms),
        ("osr.x.walk", 2, 1 * ms, 8 * ms),  # another thread: no parent
        ("aten::mm", 1, 6 * ms, 7 * ms),  # not a span
    ]
    assert common.span_self_ms(events) == {
        "osr.x.search": pytest.approx(3.0),
        "osr.x.dispatch": pytest.approx(2.0),
        "osr.x.walk": pytest.approx(8.0),
        "osr.x.merge": pytest.approx(4.0),
    }


def test_batch_stages_reads_the_served_spans(index, queries):
    """One served ``search`` of a cached engine: every query runs (the
    cache is emptied first), the stages are the spans of one batch, and
    their self times sum to the call's span."""
    eng = SparseSearchEngine(index, device="cpu", batch_sizes=(BATCH,))
    texts = list(queries.values())[:BATCH]
    eng.search({f"q{i}": t for i, t in enumerate(texts)}, 10)
    assert eng.stats()["query_cache_size"] == BATCH
    before = eng.stats()["counters"]["queries"]
    stages = common.batch_stages(eng, texts, 10)
    assert eng.stats()["counters"]["queries"] == before + BATCH
    assert list(stages) == ["osr.sparse.search"] + [
        "osr.sparse." + s for s in ("encode", "dispatch", "tail_walk",
                                    "cand_dots", "wait", "merge", "dicts")]
    assert all(v >= 0 for v in stages.values())
    med = common.median_stages(eng, texts, 10, runs=2)
    assert list(med) == list(stages)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_on_the_card(cuda, index, queries):
    """On the card under a CPU + CUDA profiler: the same host spans as on
    the CPU, with the kernels; the device's copies of the spans, where the
    trace has them, are user annotations (the benchmark's busy time leaves
    those out)."""
    eng = SparseSearchEngine(index, device=cuda, batch_sizes=(BATCH,),
                             cache_queries=False)
    assert eng.head_backend == "cuda"
    emb = np.random.default_rng(3).standard_normal((500, 64)).astype(
        np.float32)
    dense = DenseSearchEngine([str(i) for i in range(500)], emb, device=cuda)
    assert dense.backend == "cuda"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.search(queries, top_k=10)
        dense.search({"r": emb[7]}, top_k=5)
    on_card = torch.autograd.DeviceType.CUDA
    host, device = {}, []
    for e in prof.profiler.kineto_results.events():
        if not e.name().startswith("osr."):
            continue
        if e.device_type() == on_card:
            device.append(e)
        else:
            host[e.name()] = host.get(e.name(), 0) + 1
    want = {"osr.sparse.search": 1, "osr.dense.search": 1,
            "osr.dense.dispatch": 1, "osr.dense.upload": 1,
            "osr.dense.wait": 1, "osr.dense.dicts": 1}
    want.update({"osr.sparse." + s: 2 for s in SPARSE_STAGES})
    assert host == want
    assert all(e.is_user_annotation() for e in device)
