"""The port's index cache (osr_tpu_torch/index/cache.py), mirrored from
tests/test_cache.py, plus loading across packages: a cache saved by
either package's ``save_index`` loads in the other, bit-equal, and
searches to the same results; both name a corpus's file alike.

Tolerance: loaded indexes are bit-equal to the saved ones and search to
the same dicts; a re-packed index (other k1) matches a fresh build within
abs 1e-3 and the dense oracle within 1e-3, as tests/test_cache.py holds
osr_tpu's.
"""

import numpy as np
import pytest

from osr_tpu_torch.index import cache as cache_mod
from osr_tpu_torch.index.builder import SparseIndexBuilder, corpus_fingerprint
from osr_tpu_torch.index.cache import (
    cache_path,
    load_index,
    load_or_build,
    save_index,
)
from osr_tpu_torch.retrieval.engine import SparseSearchEngine
from osr_tpu_torch.testing import SyntheticDataGenerator

from tests.reference_impl import DenseOracleScorer, zipf_corpus, zipf_queries


@pytest.fixture(scope="module")
def corpus():
    return zipf_corpus(num_docs=150, vocab_size=400, avg_len=30)


def _results(index, queries):
    return SparseSearchEngine(index, device="cpu", cache_queries=False).search(
        queries, top_k=8
    )


def _same_layout(a, b):
    assert a.vocabulary == b.vocabulary
    assert a.doc_ids == b.doc_ids
    assert a.method == b.method and a.avgdl == b.avgdl
    la, lb = a.layout, b.layout
    assert la.head_dtype == lb.head_dtype and la.head_terms == lb.head_terms
    for name in ("head", "post_ptr", "post_rows", "post_weights", "valid"):
        x, y = getattr(la, name), getattr(lb, name)
        assert x.shape == y.shape, name
        np.testing.assert_array_equal(
            np.frombuffer(np.ascontiguousarray(x).tobytes(), np.uint8),
            np.frombuffer(np.ascontiguousarray(y).tobytes(), np.uint8),
        )
    if la.head_scales is None:
        assert lb.head_scales is None
    else:
        np.testing.assert_array_equal(la.head_scales, lb.head_scales)
    np.testing.assert_array_equal(a.idf, b.idf)


def test_packed_roundtrip_identical(corpus, tmp_path):
    queries = zipf_queries(10, 400, 5)
    builder = SparseIndexBuilder(method="bm25", keep_raw_rows=True)
    index = builder.build(corpus)
    save_index(index, tmp_path / "idx.npz", builder)

    loaded = load_index(tmp_path / "idx.npz", SparseIndexBuilder(method="bm25"))
    _same_layout(loaded, index)
    assert loaded.raw_indptr is None  # the loading builder keeps no rows
    assert _results(loaded, queries) == _results(index, queries)


def test_param_change_triggers_repack(corpus, tmp_path):
    queries = zipf_queries(10, 400, 5)
    builder = SparseIndexBuilder(
        method="bm25", k1=1.2, keep_raw_rows=True, head_dtype="f32"
    )
    index = builder.build(corpus)
    save_index(index, tmp_path / "idx.npz", builder)

    loaded = load_index(
        tmp_path / "idx.npz",
        SparseIndexBuilder(method="bm25", k1=2.0, head_dtype="f32"),
    )
    fresh = SparseIndexBuilder(
        method="bm25", k1=2.0, head_dtype="f32"
    ).build(corpus)
    got = _results(loaded, queries)
    want = _results(fresh, queries)
    for qid in queries:
        assert set(got[qid]) == set(want[qid])
        for doc in want[qid]:
            assert got[qid][doc] == pytest.approx(want[qid][doc], abs=1e-3)
    oracle = DenseOracleScorer(corpus, method="bm25", k1=2.0)
    engine = SparseSearchEngine(loaded, device="cpu")
    scores = engine.score_all([list(queries.values())[0]])
    np.testing.assert_allclose(
        scores[0],
        oracle.score(list(queries.values())[0]).astype(np.float32),
        atol=1e-3,
        rtol=1e-3,
    )


def test_load_or_build_cache_flow(corpus, tmp_path):
    builder = SparseIndexBuilder(method="tfidf")
    i1 = load_or_build(builder, corpus, tmp_path)
    assert cache_path(tmp_path, "tfidf", corpus_fingerprint(corpus)).exists()
    assert i1.raw_indptr is None  # the builder did not ask for raw rows
    assert builder.keep_raw_rows is False
    i2 = load_or_build(SparseIndexBuilder(method="tfidf"), corpus, tmp_path)
    assert i2.doc_ids == i1.doc_ids
    assert i2.avgdl == i1.avgdl
    p = cache_path(tmp_path, "tfidf", corpus_fingerprint(corpus))
    p.write_bytes(b"corrupt")
    i3 = load_or_build(SparseIndexBuilder(method="tfidf"), corpus, tmp_path)
    assert i3.doc_ids == i1.doc_ids


def test_method_mismatch_raises(corpus, tmp_path):
    builder = SparseIndexBuilder(method="bm25", keep_raw_rows=True)
    index = builder.build(corpus)
    save_index(index, tmp_path / "idx.npz", builder)
    with pytest.raises(ValueError, match="bm25"):
        load_index(tmp_path / "idx.npz", SparseIndexBuilder(method="tfidf"))
    with pytest.raises(ValueError, match="keep_raw_rows"):
        save_index(SparseIndexBuilder().build(corpus), tmp_path / "x.npz",
                   builder)


def test_cache_v3_zlib_file_still_loads(tmp_path, monkeypatch):
    """A cache written by the zlib (v3) path loads under the v4 reader."""
    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(
        120, 800, avg_len=30, word_prefix="t", min_len=5
    )
    b = SparseIndexBuilder(method="bm25", keep_raw_rows=True)
    idx = b.build(corpus)
    p = tmp_path / "v3.npz"
    monkeypatch.setattr(cache_mod, "_zstd", None)  # force the v3 writer
    cache_mod.save_index(idx, p, b)
    monkeypatch.undo()
    idx2 = cache_mod.load_index(p, b)
    assert np.array_equal(idx2.layout.head, idx.layout.head)
    assert idx2.doc_ids == idx.doc_ids


def test_cache_v4_roundtrip_small_arrays_uncompressed(tmp_path):
    """Small indices stay below the zstd threshold; the v4 container must
    roundtrip them (json strings as utf-8 buffers) bit-exactly."""
    corpus = SyntheticDataGenerator(seed=7).zipf_corpus(
        60, 400, avg_len=20, word_prefix="w", min_len=5
    )
    b = SparseIndexBuilder(method="tfidf", keep_raw_rows=True)
    idx = b.build(corpus)
    p = tmp_path / "v4.npz"
    cache_mod.save_index(idx, p, b)
    idx2 = cache_mod.load_index(p, b)
    assert np.array_equal(idx2.layout.head, idx.layout.head)
    assert idx2.vocabulary == idx.vocabulary
    assert abs(idx2.avgdl - idx.avgdl) < 1e-6


# ----------------------------------------------------------------------
# Across packages
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_cache():
    pytest.importorskip("jax")
    from osr_tpu.index import builder, cache

    return builder, cache


def test_fingerprint_and_file_name_match_osr_tpu(jax_cache, corpus):
    jbuilder, jcache = jax_cache
    fp = corpus_fingerprint(corpus)
    assert fp == jbuilder.corpus_fingerprint(corpus)
    assert cache_path("c", "bm25", fp) == jcache.cache_path("c", "bm25", fp)


@pytest.mark.parametrize("container", ["v4", "v3"])
@pytest.mark.parametrize("head_dtype", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("writer", ["osr_tpu", "port"])
def test_cache_loads_across_packages(
    jax_cache, tmp_path, monkeypatch, writer, head_dtype, container
):
    """An index saved by one package loads in the other bit-equal (the
    bf16 head as raw bytes) and searches to the results of the reading
    package's own build."""
    jbuilder_mod, jcache = jax_cache
    corpus = SyntheticDataGenerator(seed=3).zipf_corpus(
        300, 1_500, avg_len=30, word_prefix="t", min_len=5
    )
    queries = SyntheticDataGenerator(seed=4).queries(
        16, 1_500, avg_terms=5, word_prefix="t"
    )
    kw = dict(method="bm25", head_dtype=head_dtype)
    port_idx = SparseIndexBuilder(keep_raw_rows=True, **kw).build(corpus)
    path = tmp_path / "idx.npz"
    if container == "v3":
        monkeypatch.setattr(cache_mod, "_zstd", None)
        monkeypatch.setattr(jcache, "_zstd", None)
    if writer == "osr_tpu":
        jb = jbuilder_mod.SparseIndexBuilder(keep_raw_rows=True, **kw)
        jcache.save_index(jb.build(corpus), path, jb)
        loaded = load_index(path, SparseIndexBuilder(**kw))
        _same_layout(loaded, port_idx)
        assert _results(loaded, queries) == _results(port_idx, queries)
    else:
        save_index(port_idx, path, SparseIndexBuilder(**kw))
        loaded = jcache.load_index(path, jbuilder_mod.SparseIndexBuilder(**kw))
        want = jbuilder_mod.SparseIndexBuilder(**kw).build(corpus)
        assert loaded.vocabulary == want.vocabulary
        assert loaded.doc_ids == want.doc_ids
        for name in ("head", "post_ptr", "post_rows", "post_weights"):
            x, y = getattr(loaded.layout, name), getattr(want.layout, name)
            assert x.tobytes() == y.tobytes(), name
        from osr_tpu.retrieval.engine import SparseSearchEngine as JaxEngine

        assert JaxEngine(loaded, cache_queries=False).search(
            queries, top_k=8
        ) == JaxEngine(want, cache_queries=False).search(queries, top_k=8)


def test_load_or_build_reads_a_cache_written_by_osr_tpu(jax_cache, tmp_path):
    """The registries of both packages share ``.rag_cache``: a cache file
    osr_tpu's load_or_build wrote is what the port's load_or_build finds
    and loads (it writes nothing new)."""
    jbuilder_mod, jcache = jax_cache
    corpus = SyntheticDataGenerator(seed=5).zipf_corpus(
        200, 1_000, avg_len=30, word_prefix="t", min_len=5
    )
    jcache.load_or_build(jbuilder_mod.SparseIndexBuilder(), corpus, tmp_path)
    files = sorted(tmp_path.iterdir())
    assert len(files) == 1
    stamp = files[0].stat().st_mtime_ns
    loaded = load_or_build(SparseIndexBuilder(), corpus, tmp_path)
    assert sorted(tmp_path.iterdir()) == files
    assert files[0].stat().st_mtime_ns == stamp
    _same_layout(loaded, SparseIndexBuilder().build(corpus))
