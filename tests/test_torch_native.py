"""The port's C++ host runtime (osr_tpu_torch/native.py over
csrc/host_runtime.cc) against osr_tpu's (osr_tpu.native over
native/osr_native.cc): the mirror of tests/test_native.py.

Every binding gets the same numpy-seeded inputs through both runtimes and
must give the same bytes. ``test_zlib_roundtrip`` has no counterpart: the
port's document store compresses with Python's ``zlib``, and its runtime
neither exports a codec nor links zlib.

The tests below also hold the runtime to what it owns: it is built from
``csrc/host_runtime.cc`` into ``build/osr_tpu_torch/``, it imports no
``mallopt``, multithreaded calls give single-threaded bytes, a failed
build reaches the caller with the compiler's output, and (``-m cuda``) an
engine on the card refuses to run without it. This file imports JAX and
``osr_tpu`` only inside the tests that compare with them, so the card test
runs where JAX is absent.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import osr_tpu_torch.native as tnative
from osr_tpu_torch.index.builder import (
    SparseIndexBuilder,
    bm25_idf,
    compute_weights_flat,
    tfidf_idf,
)
from osr_tpu_torch.index.layout import DOC_ALIGN, pack_flat, round_up
from osr_tpu_torch.ops import _build
from osr_tpu_torch.retrieval import engine as tengine
from osr_tpu_torch.retrieval.engine import SparseSearchEngine
from osr_tpu_torch.testing import SyntheticDataGenerator

REPO = Path(__file__).resolve().parents[1]
TEXTS = [
    "Hello, World! 123 foo_bar",
    "UPPER lower MiXeD",
    "",
    "   ...   ",
    "tabs\tand\nnewlines here",
    "a" * 3000,
    "digits 007 under_score __lead trail__",
]


@pytest.fixture(scope="module")
def jn():
    """osr_tpu's runtime, the reference."""
    return pytest.importorskip("osr_tpu.native")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small():
    """A 2,000-doc index, its vocabulary in id order, and 97 queries."""
    gen = SyntheticDataGenerator(seed=5)
    corpus = gen.zipf_corpus(2_000, 3_000, avg_len=40, word_prefix="w")
    queries = list(
        gen.queries(97, 3_000, avg_terms=8, word_prefix="w").values()
    )
    index = SparseIndexBuilder(head_terms=256).build(corpus)
    terms = [""] * len(index.vocabulary)
    for t, i in index.vocabulary.items():
        terms[i] = t
    return index, terms, queries


def _split(tids, counts, ptr, head_terms):
    """Head and tail segments of flat encoded queries, as the engine
    splits them: (tail ids local, tail counts, tail ptr, head ids, head
    counts, head ptr)."""
    nq = len(ptr) - 1
    qidx = np.repeat(np.arange(nq, dtype=np.int64), np.diff(ptr))
    in_head = tids < head_terms
    t_ptr = np.zeros(nq + 1, dtype=np.int64)
    np.cumsum(np.bincount(qidx[~in_head], minlength=nq), out=t_ptr[1:])
    h_ptr = np.zeros(nq + 1, dtype=np.int64)
    np.cumsum(np.bincount(qidx[in_head], minlength=nq), out=h_ptr[1:])
    return (
        (tids[~in_head] - head_terms).astype(np.int32), counts[~in_head],
        t_ptr, tids[in_head], counts[in_head], h_ptr,
    )


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        else:
            assert a == b


@pytest.mark.parametrize("text", TEXTS)
def test_ascii_tokenize_matches_regex_and_osr_tpu(jn, text):
    got = tnative.ascii_tokenize(text)
    assert got == re.findall(r"\b\w+\b", text.lower())
    assert got == jn.ascii_tokenize(text)


def test_build_corpus_tf_matches_osr_tpu(jn):
    corpus = SyntheticDataGenerator(seed=2).zipf_corpus(60, 150, avg_len=25)
    texts = [d["text"] for d in corpus.values()] + ["", "!!! ??? ..."]
    encoded = [t.encode("ascii") for t in texts]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    buf = b"".join(encoded)
    _same(tnative.build_corpus_tf(buf, offsets),
          jn.build_corpus_tf(buf, offsets))


def test_native_counting_equals_python():
    corpus = SyntheticDataGenerator(seed=2).zipf_corpus(60, 150, avg_len=25)
    texts = [d["text"] for d in corpus.values()] + ["", "!!! ??? ..."]
    got = SparseIndexBuilder._count_corpus_native(texts)
    want = SparseIndexBuilder._count_corpus_python(texts)
    assert got is not None
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def test_native_path_falls_back_on_unicode():
    texts = ["ünïcode text", "plain ascii"]
    assert SparseIndexBuilder._count_corpus_native(texts) is None


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("method", ["bm25", "tfidf"])
@pytest.mark.parametrize("head_terms", [0, 32, 150])
def test_pack_hybrid_matches_osr_tpu_and_numpy(jn, dtype, method, head_terms):
    """The fused pack equals osr_tpu's byte for byte and the NumPy
    compute_weights_flat + pack_flat reference array for array."""
    corpus = SyntheticDataGenerator(seed=3).zipf_corpus(70, 150, avg_len=40)
    texts = [d["text"] for d in corpus.values()]
    vocab, df, dl, indptr, tids, tfs = (
        SparseIndexBuilder._count_corpus_python(texts)
    )
    num_docs, vocab_size = len(texts), len(vocab)
    head_terms = min(head_terms, vocab_size)
    avgdl = float(dl.mean())
    idf = bm25_idf(df, num_docs) if method == "bm25" else tfidf_idf(
        df, num_docs
    )
    rows = max(round_up(num_docs, DOC_ALIGN), DOC_ALIGN)
    args = (indptr, tids, tfs, dl, idf, rows, head_terms, vocab_size,
            method, 1.2, 0.75, avgdl)
    fn = f"pack_hybrid_{dtype}_native"
    got = getattr(tnative, fn)(*args)
    _same(got, getattr(jn, fn)(*args))

    weights = compute_weights_flat(
        tids, tfs, indptr, dl, idf, method, 1.2, 0.75, avgdl
    )
    doc_idx = np.repeat(np.arange(num_docs, dtype=np.int64), np.diff(indptr))
    want = pack_flat(doc_idx, tids, weights, num_docs, vocab_size,
                     head_terms=head_terms, head_dtype=dtype)
    for a, b in zip(got, (want.head, want.head_scales, want.post_ptr,
                          want.post_rows, want.post_weights)):
        np.testing.assert_array_equal(a, b)


def test_thread_override_roundtrip():
    try:
        tnative.set_num_threads(4)
        assert tnative.get_num_threads() == 4
    finally:
        tnative.set_num_threads(0)
    assert tnative.get_num_threads() >= 1


def test_encode_queries_matches_osr_tpu(jn, small):
    _, terms, queries = small
    queries = queries + ["", "W1 w1 w1 zzz", "w2999 W0"]
    _same(tnative.NativeVocab(terms).encode_queries(queries),
          jn.NativeVocab(terms).encode_queries(queries))


def test_tail_candidates_matches_osr_tpu(jn, small):
    index, terms, queries = small
    lay = index.layout
    tids, counts, ptr = tnative.NativeVocab(terms).encode_queries(queries)
    t_ids, t_counts, t_ptr, *_ = _split(tids, counts, ptr, lay.head_terms)
    args = (lay.post_ptr, lay.post_rows, lay.post_weights, t_ids, t_counts,
            t_ptr)
    got = tnative.tail_candidates_native(*args)
    want = jn.tail_candidates_native(*args)
    total = got[4]
    assert total == want[4] > 0
    for a, b in zip(got[:3], want[:3]):
        assert a[:total].tobytes() == b[:total].tobytes()
    assert got[3].tobytes() == want[3].tobytes()


@pytest.mark.parametrize("head_dtype", ["int8", "f32", "bf16"])
def test_cand_head_dot_matches_osr_tpu(jn, small, head_dtype):
    """cand_head_dot over an int8 head (scales folded), an f32 head and a
    bf16 head (its uint16 bits); for int8 also transpose_i8 and the
    term-major cand_head_dot_t."""
    index, terms, queries = small
    lay = index.layout
    tids, counts, ptr = tnative.NativeVocab(terms).encode_queries(queries)
    t_ids, t_counts, t_ptr, h_ids, h_counts, h_ptr = _split(
        tids, counts, ptr, lay.head_terms
    )
    rows, cols, _, c_ptr, total = tnative.tail_candidates_native(
        lay.post_ptr, lay.post_rows, lay.post_weights, t_ids, t_counts,
        t_ptr,
    )
    rng = np.random.RandomState(8)
    head, scales = lay.head, lay.head_scales
    if head_dtype == "f32":
        head, scales = rng.randn(*head.shape).astype(np.float32), None
    elif head_dtype == "bf16":
        head = rng.randn(*head.shape).astype(np.float32)
        head = (head.view(np.uint32) >> 16).astype(np.uint16)
        scales = None
    args = (head, head_dtype, scales, rows, cols, total, h_ids, h_counts,
            h_ptr)
    got = tnative.cand_head_dot_native(*args)
    assert got.tobytes() == jn.cand_head_dot_native(*args).tobytes()
    if head_dtype != "int8":
        return
    head_t = tnative.transpose_i8_native(head)
    assert head_t.tobytes() == jn.transpose_i8_native(head).tobytes()
    np.testing.assert_array_equal(head_t, head.T)
    t_args = (head_t, scales, rows, c_ptr, total, h_ids, h_counts, h_ptr)
    got_t = tnative.cand_head_dot_t_native(*t_args)
    assert got_t.tobytes() == jn.cand_head_dot_t_native(*t_args).tobytes()
    assert got_t.tobytes() == got.tobytes()


@pytest.mark.parametrize("slack", [None, "zeros", "random"])
def test_merge_topk_matches_osr_tpu(jn, small, slack):
    index, terms, queries = small
    lay = index.layout
    tids, counts, ptr = tnative.NativeVocab(terms).encode_queries(queries)
    t_ids, t_counts, t_ptr, *_ = _split(tids, counts, ptr, lay.head_terms)
    rows, _, tail, c_ptr, total = tnative.tail_candidates_native(
        lay.post_ptr, lay.post_rows, lay.post_weights, t_ids, t_counts,
        t_ptr,
    )
    rng = np.random.RandomState(9)
    b, k = len(queries), 10
    head_r = np.stack(
        [rng.permutation(lay.num_docs)[:k] for _ in range(b)]
    ).astype(np.int32)
    head_s = -np.sort(-rng.rand(b, k).astype(np.float32) * 5, axis=1)
    # Ties: the merge keeps the head-top order first, then candidates.
    head_s[:, 3] = head_s[:, 2]
    c_tot = tail[:total] + np.round(rng.rand(total) * 4).astype(np.float32)
    tau = {None: None, "zeros": np.zeros(b, np.float32),
           "random": rng.rand(b).astype(np.float32)}[slack]
    args = (head_s, head_r, rows, c_tot, c_ptr, total, k)
    _same(tnative.merge_topk_native(*args, tau_slack=tau),
          jn.merge_topk_native(*args, tau_slack=tau))


def test_multithreaded_host_identical_to_single_thread():
    """The whole host runtime (encode, tail walk, candidate dots, merge)
    at 1 and 4 threads gives the same search results on a 12,000-doc
    corpus: every parallel section partitions deterministically and each
    thread owns a disjoint output range."""
    gen = SyntheticDataGenerator(seed=4)
    corpus = gen.zipf_corpus(12_000, 8_000, avg_len=40)
    queries = gen.queries(64, 8_000, avg_terms=5)
    index = SparseIndexBuilder().build(corpus)
    engine = SparseSearchEngine(index, device="cpu", cache_queries=False)
    assert engine.merge_backend == "host"  # the runtime is in play
    try:
        tnative.set_num_threads(1)
        single = engine.search(queries, top_k=20)
        tnative.set_num_threads(4)
        multi = engine.search(queries, top_k=20)
    finally:
        tnative.set_num_threads(0)
    assert single == multi


def test_multithreaded_kernels_identical_to_single_thread():
    """Entry point by entry point, 1 against 5 threads (5 does not divide
    the work evenly): the same bytes."""
    gen = SyntheticDataGenerator(seed=6)
    corpus = gen.zipf_corpus(10_000, 6_000, avg_len=35)
    queries = list(gen.queries(97, 6_000, avg_terms=5).values())
    index = SparseIndexBuilder().build(corpus)
    lay = index.layout
    terms = [""] * len(index.vocabulary)
    for t, i in index.vocabulary.items():
        terms[i] = t
    nv = tnative.NativeVocab(terms)

    def run_all():
        tids, counts, ptr = nv.encode_queries(queries)
        t_ids, t_counts, t_ptr, h_ids, h_counts, h_ptr = _split(
            tids, counts, ptr, lay.head_terms
        )
        rows, cols, tail, qptr, total = tnative.tail_candidates_native(
            lay.post_ptr, lay.post_rows, lay.post_weights, t_ids, t_counts,
            t_ptr,
        )
        cand_head = tnative.cand_head_dot_native(
            lay.head, lay.head_dtype, lay.head_scales, rows, cols, total,
            h_ids, h_counts, h_ptr,
        )
        return tids, counts, ptr, rows[:total], tail[:total], qptr, cand_head

    try:
        tnative.set_num_threads(1)
        base = run_all()
        tnative.set_num_threads(5)
        got = run_all()
    finally:
        tnative.set_num_threads(0)
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a, b)


def test_index_built_via_native_matches_oracle():
    from tests.reference_impl import DenseOracleScorer, zipf_corpus, zipf_queries

    corpus = zipf_corpus(num_docs=100, vocab_size=300, avg_len=30)
    queries = zipf_queries(num_queries=8, vocab_size=300)
    oracle = DenseOracleScorer(corpus, method="bm25")
    engine = SparseSearchEngine(
        SparseIndexBuilder(head_dtype="f32").build(corpus), device="cpu"
    )
    got = engine.score_all(list(queries.values()))
    for i, text in enumerate(queries.values()):
        np.testing.assert_allclose(
            got[i], oracle.score(text).astype(np.float32), atol=1e-3, rtol=1e-4
        )


def test_blake2b64_matches_hashlib_and_osr_tpu(jn):
    import hashlib
    import random

    random.seed(7)
    cases = [b"", b"a", b"the", "naïve café".encode("utf-8"),
             b"x" * 127, b"y" * 128, b"z" * 129, b"w" * 300, b"q" * 1000]
    cases += [random.randbytes(random.randrange(0, 260)) for _ in range(200)]
    for c in cases:
        want = int.from_bytes(
            hashlib.blake2b(c, digest_size=8).digest(), "little"
        )
        assert tnative.blake2b64(c) == want == jn.blake2b64(c), c[:24]


def _hash_texts(n=200, seed=3):
    import random

    random.seed(seed)
    vocab = [f"w{i}" for i in range(800)] + ["naïve", "Ωmega", "café"]
    texts = [
        " ".join(random.choices(vocab, k=random.randrange(1, 120)))
        for _ in range(n)
    ]
    texts += ["", "   ", "!!! ...", "solo", "rep rep rep rep"]
    return texts


@pytest.mark.parametrize("idf", [False, True])
def test_native_hashing_encoder_bit_identical_to_python(idf):
    from osr_tpu_torch.encoders import HashingEncoder

    texts = _hash_texts()
    nat = HashingEncoder(dim=256, idf=idf, native="force")
    py = HashingEncoder(dim=256, idf=idf, native="off")
    assert nat._nb is not None and py._nb is None
    np.testing.assert_array_equal(nat.encode(texts), py.encode(texts))
    for q in ("w1 w2 unseenterm", "naïve café", ""):
        np.testing.assert_array_equal(nat.encode_one(q), py.encode_one(q))
        np.testing.assert_array_equal(nat.encode([q])[0], nat.encode_one(q))
    if idf:
        for f in ("w1", "w1 w2", "never-seen-feature"):
            assert nat._idf(py._hash(f)) == py._idf(py._hash(f))


@pytest.mark.parametrize("ngrams", [1, 2, 3])
def test_henc_matches_osr_tpu(jn, ngrams):
    """The henc_* family through both runtimes: fit, the df table, idf,
    encode, and a df table imported from the other runtime."""
    import hashlib

    def token_docs(texts):
        return [
            "\0".join(re.findall(r"\b\w+\b", t.lower())).encode("utf-8")
            for t in texts
        ]

    docs = token_docs(_hash_texts(n=150, seed=ngrams))
    queries = token_docs(["w1 w2 w3", "naïve café w7", "", "unseen words"])
    got = tnative.NativeHashingBackend(128, ngrams, True)
    want = jn.NativeHashingBackend(128, ngrams, True)
    got.fit(docs)
    want.fit(docs)
    keys, vals = got.export_df()
    _same((keys, vals), want.export_df())
    for feat in (b"w1", b"w1 w2", b"never-seen"):
        h = int.from_bytes(hashlib.blake2b(feat, digest_size=8).digest(),
                           "little")
        assert got.idf(h) == want.idf(h)
    for batch in (docs, queries):
        assert got.encode(batch).tobytes() == want.encode(batch).tobytes()
    fresh = tnative.NativeHashingBackend(128, ngrams, True)
    fresh.import_df(*want.export_df(), len(docs))
    assert fresh.encode(queries).tobytes() == want.encode(queries).tobytes()
    _same(fresh.export_df(), (keys, vals))


def test_native_hashing_encoder_thread_determinism():
    from osr_tpu_torch.encoders import HashingEncoder

    texts = _hash_texts(n=400, seed=11)
    enc = HashingEncoder(dim=128, idf=True, native="force")
    try:
        tnative.set_num_threads(1)
        one = enc.encode(texts)
        tnative.set_num_threads(4)
        four = enc.encode(texts)
    finally:
        tnative.set_num_threads(0)
    np.testing.assert_array_equal(one, four)


def test_runtime_is_the_ports_own_build():
    """The loaded library is csrc/host_runtime.cc's, built under
    build/osr_tpu_torch/; nothing in the package names osr_tpu's runtime
    or its build."""
    lib = tnative.library()
    assert _build.BUILD_DIR == REPO / "build" / "osr_tpu_torch"
    assert lib.path.parent == _build.BUILD_DIR
    assert lib.path == _build.host_target()
    assert _build.HOST_SOURCE == REPO / "osr_tpu_torch/csrc/host_runtime.cc"
    pattern = re.compile(
        r"native/libosrnative|make -C native|OSR_TPU_NATIVE_LIB|"
        r"OSR_TPU_BUILD_NATIVE"
    )
    for path in (REPO / "osr_tpu_torch").rglob("*"):
        if path.suffix in (".py", ".cc", ".cu", ".cuh"):
            assert not pattern.search(path.read_text()), path


def _undefined_symbols(path):
    nm = shutil.which("nm")
    if nm is None:
        pytest.skip("nm is not installed")
    return subprocess.run(
        [nm, "-D", "--undefined-only", str(path)],
        capture_output=True, text=True, check=True,
    ).stdout


def test_runtime_imports_no_mallopt():
    assert "mallopt" not in _undefined_symbols(tnative.library().path)


def test_nm_sees_osr_tpu_runtimes_mallopt(jn):
    """The check above can see the symbol: osr_tpu's runtime imports
    mallopt for its static allocator tuning."""
    assert "mallopt" in _undefined_symbols(jn._LIB_PATH)


@pytest.fixture
def failing_compiler(monkeypatch, tmp_path):
    """A compiler that fails with a message of its own, and a process
    that has not loaded the runtime yet (both restored after the test)."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'cxx: no host runtime today' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)
    return "no host runtime today"


def test_runtime_build_failure_reaches_the_caller(small, failing_compiler):
    """On the CPU a runtime that cannot be built leaves the NumPy bodies
    (osr_tpu's semantics); the compiler's output is in the error, and on a
    CUDA device the engines' check raises it."""
    index = small[0]
    assert not tnative.available()
    with pytest.raises(ImportError, match=failing_compiler):
        tnative.library()
    engine = SparseSearchEngine(index, device="cpu")
    assert engine.merge_backend == "device"
    assert tengine.host_runtime(torch.device("cpu")) is False
    with pytest.raises(RuntimeError, match=failing_compiler):
        tengine.host_runtime(torch.device("cuda"))


@pytest.mark.cuda
def test_engine_on_card_raises_without_the_runtime(cuda, small,
                                                   failing_compiler):
    """On a CUDA device a SparseSearchEngine whose runtime cannot be built
    raises with the compiler's output instead of switching to the device
    merge and the NumPy bodies."""
    with pytest.raises(RuntimeError, match=failing_compiler):
        SparseSearchEngine(small[0], device=cuda)
