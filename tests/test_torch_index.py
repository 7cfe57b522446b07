"""The port's host index stack (osr_tpu_torch/index, retrieval/encoding,
testing, convert, native) against osr_tpu's, on the same seeded inputs.
Everything here is host NumPy in both packages, so the tolerance is zero:
arrays must be byte-identical."""

import sys

import ml_dtypes
import numpy as np
import pytest

import osr_tpu.index.tokenizer as jtok
import osr_tpu_torch.native as tnative
from osr_tpu.index import postings as jpost
from osr_tpu.index.builder import SparseIndexBuilder as JaxBuilder
from osr_tpu.index.layout import unpack_int4 as j_unpack_int4
from osr_tpu.retrieval.encoding import QueryEncoder as JEncoder
from osr_tpu.retrieval.encoding import encode_query_batch as j_encode
from osr_tpu.testing import SyntheticDataGenerator as JaxGen
from osr_tpu_torch.convert import index_from_arrays
from osr_tpu_torch.index import postings as tpost
from osr_tpu_torch.index.builder import SparseIndexBuilder
from osr_tpu_torch.index.layout import repack_int4, unpack_int4
from osr_tpu_torch.index.tokenizer import Tokenizer, term_counts, tokenize
from osr_tpu_torch.retrieval.encoding import QueryEncoder, encode_query_batch
from osr_tpu_torch.testing import SyntheticDataGenerator

LAYOUT_FIELDS = (
    "head", "head_scales", "valid", "post_ptr", "post_rows", "post_weights",
)


@pytest.fixture(scope="module")
def corpus():
    docs = SyntheticDataGenerator(seed=1).zipf_corpus(
        600, 3_000, avg_len=40, word_prefix="w", min_len=3
    )
    docs["extra"] = {"text": "Alpha, BETA gamma; alpha_beta 42 w1 W1"}
    return docs


@pytest.fixture
def no_native(monkeypatch):
    """Both packages without the C++ runtime: their NumPy paths."""

    def refuse():
        raise ImportError("native runtime disabled for this test")

    monkeypatch.setattr(tnative, "library", refuse)
    monkeypatch.setitem(sys.modules, "osr_tpu.native", None)
    monkeypatch.setattr(jtok, "_NATIVE_AVAILABLE", False)


def _head_bits(layout):
    head = layout.head
    if layout.head_dtype == "bf16":
        return np.asarray(head).view(np.uint16)
    return head


def _assert_same_index(got, want):
    for name in LAYOUT_FIELDS:
        a = getattr(got.layout, name)
        b = _head_bits(want.layout) if name == "head" else getattr(
            want.layout, name
        )
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name
    assert got.vocabulary == want.vocabulary
    assert list(got.vocabulary) == list(want.vocabulary)
    assert got.doc_ids == want.doc_ids
    assert got.layout.head_terms == want.layout.head_terms
    assert got.idf.tobytes() == want.idf.tobytes()


@pytest.mark.parametrize("dtype", ["int8", "int4", "bf16", "f32"])
def test_builder_matches_osr_tpu_native(corpus, dtype):
    assert tnative.available()
    want = JaxBuilder(head_dtype=dtype).build(corpus)
    got = SparseIndexBuilder(head_dtype=dtype).build(corpus)
    _assert_same_index(got, want)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_builder_matches_osr_tpu_numpy_fallback(corpus, dtype, no_native):
    assert not tnative.available()
    want = JaxBuilder(head_dtype=dtype, head_terms=200).build(corpus)
    got = SparseIndexBuilder(head_dtype=dtype, head_terms=200).build(corpus)
    _assert_same_index(got, want)


@pytest.mark.parametrize("method", ["bm25", "tfidf"])
def test_native_and_fallback_agree(corpus, method, monkeypatch):
    native = SparseIndexBuilder(method=method, head_dtype="int4").build(corpus)
    monkeypatch.setattr(
        tnative, "library",
        lambda: (_ for _ in ()).throw(ImportError("off")),
    )
    fallback = SparseIndexBuilder(method=method, head_dtype="int4").build(
        corpus
    )
    _assert_same_index(native, fallback)


def test_synthetic_generator_matches_osr_tpu():
    for seed in (0, 6, 42):
        a, b = SyntheticDataGenerator(seed), JaxGen(seed)
        assert a.zipf_corpus(50, 500, avg_len=20) == b.zipf_corpus(
            50, 500, avg_len=20
        )
        assert a.queries(30, 500, avg_terms=5, word_prefix="t") == b.queries(
            30, 500, avg_terms=5, word_prefix="t"
        )
        np.testing.assert_array_equal(a.embeddings(20, 16), b.embeddings(20, 16))


def test_unpack_int4_matches_and_repacks():
    rng = np.random.RandomState(0)
    packed = rng.randint(0, 256, (37, 24)).astype(np.uint8)
    for f in (47, 48):
        np.testing.assert_array_equal(
            unpack_int4(packed, f), j_unpack_int4(packed, f)
        )
        wider = repack_int4(packed, f, 32)
        assert wider.shape == (37, 32)
        np.testing.assert_array_equal(unpack_int4(wider, f), unpack_int4(packed, f))


def test_tokenizer_and_encoding_match_osr_tpu(corpus):
    texts = ["Hello, World! hello", "naïve café CAFÉ", "", "x_y z9 Z9 w1 w2 w2"]
    for t in texts:
        assert tokenize(t) == jtok.tokenize(t)
    idx = SparseIndexBuilder().build(corpus)
    queries = ["w1 w2 w2 w3", "w2999 zzz", "", "w5 W5 w100 w1000 w7"]
    f = idx.layout.head_terms
    got = encode_query_batch(QueryEncoder(Tokenizer(idx.vocabulary)), queries, 8, 64)
    want = j_encode(JEncoder(jtok.Tokenizer(idx.vocabulary)), queries, 8, 64)
    for name in got.__slots__:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        else:
            assert a == b, name
    assert f > 0


@pytest.mark.parametrize("text", [
    "a b a c a", "", "Ünïcode wörds, MIXED case! mixed", "x_y 12 x-y x_y",
])
def test_term_counts_match_osr_tpu(text):
    """term_counts (tests/test_tokenizer.py:test_term_counts) equals
    osr_tpu's Counter, key order included."""
    got, want = term_counts(text), jtok.term_counts(text)
    assert got == want and list(got.items()) == list(want.items())
    if text == "a b a c a":
        assert got == {"a": 3, "b": 1, "c": 1}


@pytest.mark.parametrize("use_native", [True, False])
def test_postings_match_osr_tpu(corpus, use_native):
    """Tail walk, candidate head dots, tau slack and the exact merge."""
    idx = JaxBuilder().build(corpus)
    lay = idx.layout
    queries = list(SyntheticDataGenerator(seed=3).queries(
        24, 3_000, avg_terms=6, word_prefix="w"
    ).values())
    enc = j_encode(JEncoder(jtok.Tokenizer(idx.vocabulary)), queries, 32, lay.head_terms)
    args = (lay.post_ptr, lay.post_rows, lay.post_weights, enc.tail_ids,
            enc.tail_counts, enc.tail_ptr, 32)
    want_c = jpost.tail_candidates_flat(
        *args, num_rows=lay.num_rows, pad_to_menu=False, use_native=use_native
    )
    got_c = tpost.tail_candidates_flat(
        *args, num_rows=lay.num_rows, use_native=use_native
    )
    for name in ("rows", "cols", "tail", "ptr"):
        assert getattr(got_c, name).tobytes() == getattr(want_c, name).tobytes()
    assert got_c.total == want_c.total > 0
    hargs = (lay.head, "int8", lay.head_scales)
    qargs = (enc.head_flat_ids, enc.head_flat_counts, enc.head_ptr)
    want_h = jpost.cand_head_scores_host(*hargs, want_c, *qargs, use_native=use_native)
    got_h = tpost.cand_head_scores_host(*hargs, got_c, *qargs, use_native=use_native)
    assert got_h.tobytes() == want_h.tobytes()
    jstate = jpost.prepare_host_merge(lay, want_head_t=False)
    tstate = tpost.prepare_host_merge(lay, want_head_t=False)
    assert tstate[3].tobytes() == jstate[3].tobytes()
    slack = tpost.merge_tau_slack(tstate[3], *qargs)
    assert slack.tobytes() == jpost.merge_tau_slack(jstate[3], *qargs).tobytes()
    rng = np.random.RandomState(4)
    k = 10
    head_r = np.stack([rng.permutation(lay.num_docs)[:k] for _ in range(32)])
    head_s = -np.sort(-rng.rand(32, k).astype(np.float32) * 5, axis=1)
    margs = (head_s, head_r.astype(np.int32))
    want_m = jpost.merge_host(*margs, want_c, want_h, lay.num_rows, k,
                              use_native=use_native, tau_slack=slack)
    got_m = tpost.merge_host(*margs, got_c, got_h, lay.num_rows, k,
                             use_native=use_native, tau_slack=slack)
    for a, b in zip(got_m, want_m):
        assert a.tobytes() == b.tobytes()


def _tail_case(top):
    """Three tail terms whose ascending postings reach row ``top``, with
    rows that differ in each 12-bit digit and rows shared across terms,
    over a batch of 4 (query 1 empty, query 3 padding). Weights are
    multiples of 1/4, so every sum is exact in float32 and the runtime's
    float32 sums and the NumPy body's float64 ones give the same bits."""
    terms = [
        sorted({7, 4096, top // 3, top - 2, top}),
        sorted({0, 4095, top // 3, top - 2}),
        sorted({3, 1 << 12, (top >> 12) << 12, top // 3, top - 1, top}),
    ]
    post_ptr = np.cumsum([0] + [len(t) for t in terms]).astype(np.int64)
    post_rows = np.array([r for t in terms for r in t], np.int32)
    post_weights = np.arange(1, len(post_rows) + 1, dtype=np.float32) / 4
    tail_ids = np.array([0, 1, 2, 1, 2, 0], np.int32)
    tail_counts = np.array([1.0, 2.0, 1.0, 3.0, 1.0, 2.0], np.float32)
    tail_ptr = np.array([0, 3, 3, 6], np.int64)
    return (post_ptr, post_rows, post_weights, tail_ids, tail_counts,
            tail_ptr)


def _dict_sums(post_ptr, post_rows, post_weights, tail_ids, tail_counts,
               tail_ptr):
    """(query, row) -> summed contribution, by plain dict."""
    sums = {}
    for q in range(len(tail_ptr) - 1):
        for i in range(tail_ptr[q], tail_ptr[q + 1]):
            t = tail_ids[i]
            for p in range(post_ptr[t], post_ptr[t + 1]):
                key = (q, int(post_rows[p]))
                sums[key] = sums.get(key, 0.0) + float(
                    post_weights[p] * tail_counts[i]
                )
    return sums


def _assert_dict_sums(cand, sums):
    keys = sorted(sums)
    assert cand.total == len(keys)
    assert cand.cols[: cand.total].tolist() == [q for q, _ in keys]
    assert cand.rows[: cand.total].tolist() == [r for _, r in keys]
    assert cand.tail[: cand.total].tolist() == [sums[k] for k in keys]


@pytest.mark.parametrize(
    "top", [(1 << 24) - 1, 1 << 24, 1 << 28, (1 << 31) - 1]
)
def test_native_walk_equals_numpy_body_past_2_pow_24(top):
    """The runtime's walker sorts rows on at most three 12-bit digits, so
    rows up to the int32 maximum walk as the NumPy body and a plain dict
    walk them."""
    case = _tail_case(top)
    rows, cols, tail, qptr, total = tnative.tail_candidates_native(*case)
    want = tpost.tail_candidates_flat(
        *case, 3, num_rows=top + 1, use_native=False
    )
    assert total == want.total
    assert rows[:total].tobytes() == want.rows.tobytes()
    assert cols[:total].tobytes() == want.cols.tobytes()
    assert tail[:total].tobytes() == want.tail.tobytes()
    assert qptr.tobytes() == want.ptr.tobytes()
    _assert_dict_sums(want, _dict_sums(*case))


def test_tail_walk_at_2_pow_24_rows_takes_numpy_body(monkeypatch):
    """An index of 2^24 rows or more (row chunks lift osr_tpu's cap):
    ``tail_candidates_flat(use_native=True)`` walks it in the runtime,
    once, and its candidates equal the NumPy body's and the plain-dict
    sums."""
    top = 1 << 24
    case = _tail_case(top)
    calls = []
    walk = tnative.tail_candidates_native

    def counted(*args):
        calls.append(args)
        return walk(*args)

    monkeypatch.setattr(tnative, "tail_candidates_native", counted)
    got = tpost.tail_candidates_flat(
        *case, 4, num_rows=top + 1, use_native=True
    )
    assert len(calls) == 1
    want = tpost.tail_candidates_flat(
        *case, 4, num_rows=top + 1, use_native=False
    )
    assert len(calls) == 1
    for name in ("rows", "cols", "tail", "ptr"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes()
    assert got.total == want.total
    _assert_dict_sums(got, _dict_sums(*case))
    assert got.ptr.tolist() == [0, 9, 9, 18, 18]


@pytest.mark.parametrize("dtype", ["int8", "int4", "bf16"])
def test_index_from_arrays_round_trips(corpus, dtype):
    want = JaxBuilder(head_dtype=dtype).build(corpus)
    lay = want.layout
    got = index_from_arrays(
        head=lay.head, head_scales=lay.head_scales, post_ptr=lay.post_ptr,
        post_rows=lay.post_rows, post_weights=lay.post_weights,
        valid=lay.valid, num_docs=lay.num_docs, vocab_size=lay.vocab_size,
        head_terms=lay.head_terms, head_dtype=lay.head_dtype,
        vocabulary=want.vocabulary, doc_ids=want.doc_ids, idf=want.idf,
    )
    _assert_same_index(got, want)
    assert got.layout.num_rows == lay.num_rows
    assert got.stats()["num_docs"] == want.num_docs
    if dtype == "bf16":
        assert isinstance(lay.head[0, 0], ml_dtypes.bfloat16)
    with pytest.raises(ValueError):
        index_from_arrays(
            head=lay.head[:, :-1], head_scales=lay.head_scales,
            post_ptr=lay.post_ptr, post_rows=lay.post_rows,
            post_weights=lay.post_weights, valid=lay.valid,
            num_docs=lay.num_docs, vocab_size=lay.vocab_size,
            head_terms=lay.head_terms, head_dtype=lay.head_dtype,
            vocabulary=want.vocabulary, doc_ids=want.doc_ids,
        )
