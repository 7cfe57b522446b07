"""The port's RetrievalService (osr_tpu_torch/retrieval/service.py),
mirrored from tests/test_service.py, with ``search_bm25`` held against
osr_tpu's service on the same documents (scores within rtol 1e-5, the same
ids in the same order except at near-ties: the rule of
tests/test_torch_engine.py).

The test marked ``cuda`` holds the service on the card against the service
on the CPU and skips without a card.
"""

import numpy as np
import pytest
import torch

from osr_tpu_torch.index.dense import synthetic_corpus_embeddings
from osr_tpu_torch.retrieval.service import RetrievalService
from osr_tpu_torch.storage.documents import Document
from osr_tpu_torch.testing import SyntheticDataGenerator


def _reference_impl():
    """tests/reference_impl.py, imported where it is used: the card's
    machine runs this file's card tests without the ``tests`` package on
    its path."""
    from tests import reference_impl

    return reference_impl


def _same(got, want, rtol=1e-5):
    assert got.keys() == want.keys()
    for qid, w in want.items():
        g = got[qid]
        assert len(g) == len(w), qid
        ws = np.array(list(w.values()))
        np.testing.assert_allclose(
            np.array(list(g.values())), ws, rtol=rtol, atol=0
        )
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                near = [j for j in (i - 1, i + 1) if 0 <= j < len(ws)]
                assert i == len(ws) - 1 or any(
                    abs(ws[i] - ws[j]) <= rtol * abs(ws[i]) for j in near
                ), (qid, i)


def test_service_end_to_end(tmp_path):
    corpus = _reference_impl().zipf_corpus(
        num_docs=60, vocab_size=200, avg_len=25
    )
    docs = [
        Document(id=d, text=rec["text"], title=rec["title"])
        for d, rec in corpus.items()
    ]
    with RetrievalService(
        tmp_path / "corpus.osrd", create=True, device="cpu"
    ) as svc:
        assert svc.add_documents(docs) == 60
        svc.build_bm25_index()
        assert svc.sparse_engine.device.type == "cpu"
        hits = svc.search_bm25({"q": "term150 term180"}, top_k=5)
        assert len(hits["q"]) > 0
        results = svc.get_search_results(hits["q"])
        assert results and "text" in results[0]
        assert results[0]["score"] >= results[-1]["score"]

        emb = synthetic_corpus_embeddings(60, dim=32, seed=1)
        svc.set_embeddings(list(corpus.keys()), emb)
        assert svc.dense_engine.device.type == "cpu"
        dense_hits = svc.search_by_vector(emb[3], k=5)
        assert dense_hits[0]["doc_id"] == "doc3"  # self-similarity wins

        stats = svc.get_stats()
        assert stats["store"]["num_documents"] == 60
        assert stats["sparse"]["num_docs"] == 60
        assert stats["dense"]["dim"] == 32

        doc = svc.get_document("doc5")
        assert doc is not None and doc.title == "Document 5"
        svc.clear_cache()
    assert svc.store._mm is None and svc.store._file is None


def test_service_errors(tmp_path):
    svc = RetrievalService(tmp_path / "x.osrd", create=True, device="cpu")
    with pytest.raises(ValueError):
        svc.search_bm25({"q": "hello"})
    with pytest.raises(ValueError):
        svc.search_by_vector(np.zeros(8, np.float32))
    with pytest.raises(ValueError):
        svc.build_bm25_index()  # empty store
    svc.close()


def test_service_loads_embeddings_file(tmp_path):
    corpus = _reference_impl().zipf_corpus(
        num_docs=40, vocab_size=150, avg_len=20
    )
    emb = synthetic_corpus_embeddings(40, dim=16, seed=2)
    np.save(tmp_path / "emb.npy", emb)
    with RetrievalService(tmp_path / "c.osrd", create=True,
                          device="cpu") as svc:
        svc.add_documents(
            [Document(id=d, text=r["text"]) for d, r in corpus.items()]
        )
    with RetrievalService(tmp_path / "c.osrd", device="cpu",
                          embedding_path=tmp_path / "emb.npy",
                          embedding_dim=16) as svc:
        assert svc.dense_engine is not None
        assert svc.dense_engine.device.type == "cpu"
        assert svc.search_by_vector(emb[7], k=3)[0]["doc_id"] == "doc7"


@pytest.fixture(scope="module")
def service_data():
    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(
        800, 3_000, avg_len=40, word_prefix="t", min_len=5
    )
    queries = SyntheticDataGenerator(seed=6).queries(
        40, 3_000, avg_terms=6, word_prefix="t", min_terms=2
    )
    return corpus, queries


def test_search_bm25_matches_osr_tpu(tmp_path, service_data):
    pytest.importorskip("jax")
    from osr_tpu.retrieval.service import RetrievalService as JaxService
    from osr_tpu.storage.documents import Document as JaxDocument

    corpus, queries = service_data
    out = {}
    for name, svc_cls, doc_cls, kw in (
        ("osr_tpu", JaxService, JaxDocument, {}),
        ("port", RetrievalService, Document, {"device": "cpu"}),
    ):
        with svc_cls(tmp_path / f"{name}.osrd", create=True, **kw) as svc:
            svc.add_documents(
                [doc_cls(id=d, text=r["text"], title=r["title"])
                 for d, r in corpus.items()]
            )
            svc.build_bm25_index()
            hits = svc.search_bm25(queries, top_k=10)
            joined = svc.get_search_results(hits["q0"])
        out[name] = hits, joined
    _same(out["port"][0], out["osr_tpu"][0])
    assert [r["text"] for r in out["port"][1]] == [
        corpus[d]["text"] for d in out["port"][0]["q0"]
    ]


@pytest.mark.cuda
def test_service_on_card_matches_cpu(tmp_path):
    """search_bm25 on the card (K2: 6,000 docs at top_k 10) equals the
    service on the CPU within K2's rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    from osr_tpu_torch.ops import head

    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(
        6_000, 20_000, avg_len=60, word_prefix="t", min_len=5
    )
    queries = SyntheticDataGenerator(seed=6).queries(
        200, 20_000, avg_terms=8, word_prefix="t", min_terms=2
    )
    docs = [Document(id=d, text=r["text"]) for d, r in corpus.items()]
    out = {}
    for dev in ("cuda", "cpu"):
        with RetrievalService(tmp_path / f"{dev}.osrd", create=True,
                              device=dev) as svc:
            svc.add_documents(docs)
            svc.build_bm25_index()
            head.reset_launches()
            out[dev] = svc.search_bm25(queries, top_k=10)
            if dev == "cuda":
                assert head.LAUNCHES["head_blockmax_i8"] > 0
                hits = out[dev]["q0"]
                texts = [r["text"] for r in svc.get_search_results(hits)]
                assert texts == [corpus[d]["text"] for d in hits]
    _same(out["cuda"], out["cpu"])
