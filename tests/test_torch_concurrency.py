"""Concurrency stress tests of the port's shared host-side state: the
three cases of tests/test_concurrency.py on osr_tpu_torch (on the CPU),
and the host runtime's tail walker called from many Python threads at
once, where each call checks its scratch out of one shared pool."""

import sys
import threading

import numpy as np

from osr_tpu_torch import native
from osr_tpu_torch.index.builder import SparseIndexBuilder
from osr_tpu_torch.retrieval.engine import SparseSearchEngine
from osr_tpu_torch.storage.doc_store import DocumentStore, LRUCache
from osr_tpu_torch.storage.documents import Document
from osr_tpu_torch.testing import SyntheticDataGenerator

from tests.reference_impl import zipf_corpus, zipf_queries

JOIN_TIMEOUT_S = 120


def _run_threads(fn, n_threads=8, iterations=50):
    errors = []

    def worker(tid):
        try:
            for i in range(iterations):
                fn(tid, i)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    threads = [
        threading.Thread(target=worker, args=(t,)) for t in range(n_threads)
    ]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_TIMEOUT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads), "a worker did not finish"
    assert not errors, errors


def test_lru_cache_thread_safety():
    cache = LRUCache(max_items=64, max_bytes=1 << 20)

    def op(tid, i):
        key = f"k{(tid * 7 + i) % 100}"
        doc = cache.get(key)
        if doc is not None:
            assert doc.id == key
        cache.put(key, Document(id=key, text="x" * (i % 50 + 1)))

    _run_threads(op)
    assert len(cache) <= 64
    stats = cache.stats()
    assert 0.0 <= stats["hit_rate"] <= 1.0


def test_doc_store_concurrent_reads(tmp_path):
    store = DocumentStore(tmp_path / "s.osrd", create=True, cache_items=16)
    store.add_documents(
        [Document(id=f"d{i}", text=f"text {i} " * 20) for i in range(100)]
    )

    def op(tid, i):
        doc_id = f"d{(tid * 13 + i) % 100}"
        doc = store.get_document(doc_id)
        assert doc is not None and doc.id == doc_id
        assert doc.text.startswith(f"text {doc_id[1:]} ")

    _run_threads(op)
    store.close()


def test_engine_query_cache_concurrent_search():
    corpus = zipf_corpus(num_docs=100, vocab_size=300, avg_len=25)
    queries = list(zipf_queries(20, 300, 4).values())
    index = SparseIndexBuilder().build(corpus)
    engine = SparseSearchEngine(index, device="cpu", query_cache_limit=10)
    baseline = {q: engine.search({"q": q}, top_k=5)["q"] for q in queries}
    engine.clear_cache()

    def op(tid, i):
        q = queries[(tid + i) % len(queries)]
        res = engine.search({"q": q}, top_k=5)["q"]
        assert res == baseline[q]

    _run_threads(op, n_threads=6, iterations=20)


def test_tail_walk_from_8_threads_equals_serial():
    """8 Python threads walk the tail at once (ctypes releases the GIL, and
    each call runs its own worker threads), each on a batch of its own
    size, so the calls check scratch sets of different sizes in and out of
    the runtime's pool concurrently; every call returns the bytes of the
    same walk run alone."""
    gen = SyntheticDataGenerator(seed=12)
    corpus = gen.zipf_corpus(20_000, 8_000, avg_len=40, word_prefix="w")
    queries = list(gen.queries(512, 8_000, avg_terms=8,
                               word_prefix="w").values())
    index = SparseIndexBuilder(head_terms=256).build(corpus)
    lay = index.layout
    terms = [""] * len(index.vocabulary)
    for t, i in index.vocabulary.items():
        terms[i] = t
    tids, counts, ptr = native.NativeVocab(terms).encode_queries(queries)

    def batch(n):
        """The tail segments of the first n queries."""
        end = ptr[n]
        ids, cts = tids[:end], counts[:end]
        qidx = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr[: n + 1]))
        tail = ids >= lay.head_terms
        t_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(qidx[tail], minlength=n), out=t_ptr[1:])
        return (lay.post_ptr, lay.post_rows, lay.post_weights,
                (ids[tail] - lay.head_terms).astype(np.int32), cts[tail],
                t_ptr)

    def walk(n):
        rows, cols, tail, qptr, total = native.tail_candidates_native(
            *batches[n]
        )
        return (rows[:total].tobytes(), cols[:total].tobytes(),
                tail[:total].tobytes(), qptr.tobytes())

    sizes = [512, 64, 448, 128, 384, 192, 320, 256]
    batches = {n: batch(n) for n in sizes}
    serial = {n: walk(n) for n in sizes}
    assert all(len(serial[n][0]) > 0 for n in sizes)

    def op(tid, i):
        n = sizes[(tid + i) % len(sizes)]
        assert walk(n) == serial[n]

    _run_threads(op, n_threads=8, iterations=12)
