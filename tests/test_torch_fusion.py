"""The port's array-level hybrid fusion (osr_tpu_torch/retrieval/fusion.py)
and HybridRetriever, mirrored from tests/test_fusion.py and held against
osr_tpu's.

Tolerances:
- ``fuse_topk_arrays`` is the same NumPy as osr_tpu's: bit-equal output on
  the same arrays;
- the fast path against the dict oracle (``_search_dicts``): the same ids,
  fused scores within abs 1e-5 (weighted) or 1e-6 (RRF), as
  tests/test_fusion.py holds osr_tpu's;
- the port's HybridRetriever against osr_tpu's on one corpus (both on the
  CPU, synthetic dense embeddings): RRF ids equal and scores within 1e-6
  relative (ranks decide RRF scores); weighted scores within atol 1e-5 and
  ids equal except where osr_tpu's fused row holds a near-tie within 2e-5,
  the rule of tests/test_torch_dense.py.

The test marked ``cuda`` holds the retriever on the card (K2, K7, K5)
against the same retriever on the CPU and skips without a card.
"""

import numpy as np
import pytest
import torch

from osr_tpu_torch.retrieval.fusion import (
    fuse_topk_arrays,
    fused_rows_to_results,
)
from osr_tpu_torch.retrieval.registry import RetrieverRegistry

CPU = {"device": "cpu"}


def _reference_impl():
    """tests/reference_impl.py, imported where it is used: the card's
    machine runs this file's card tests without the ``tests`` package on
    its path."""
    from tests import reference_impl

    return reference_impl


def _hybrid(**params):
    return RetrieverRegistry.create(
        {"type": "hybrid", "params": {**CPU, "cache_dir": None, **params}}
    )


def _fuse_dict_oracle(s_pairs, d_pairs, ws, wd, top_k):
    """Reimplementation of the dict-path semantics on one query."""

    def minmax(pairs):
        kept = {i: s for i, s in pairs if s > 0 and i >= 0}
        if not kept:
            return {}
        lo, hi = min(kept.values()), max(kept.values())
        span = (hi - lo) or 1.0
        return {i: (s - lo) / span for i, s in kept.items()}

    fused = {}
    for i, s in minmax(s_pairs).items():
        fused[i] = fused.get(i, 0.0) + ws * s
    for i, s in minmax(d_pairs).items():
        fused[i] = fused.get(i, 0.0) + wd * s
    return sorted(fused.items(), key=lambda kv: -kv[1])[:top_k]


def _random_legs(seed, B, ds, dd, n_docs):
    """Two score-sorted legs with unique ids per row, half of the dense
    ids shared with the sparse row, empty slots and one query with no kept
    dense result."""
    rng = np.random.default_rng(seed)
    s_ids = np.stack(
        [rng.choice(n_docs, ds, replace=False) for _ in range(B)]
    )
    d_ids = np.stack(
        [
            np.concatenate(
                [
                    s_ids[r, : dd // 2],
                    rng.choice(
                        np.setdiff1d(np.arange(n_docs), s_ids[r]),
                        dd - dd // 2,
                        replace=False,
                    ),
                ]
            )
            for r in range(B)
        ]
    )
    s_sc = np.sort(rng.normal(2.0, 1.0, (B, ds)).astype(np.float32))[:, ::-1]
    d_sc = np.sort(rng.normal(1.0, 1.0, (B, dd)).astype(np.float32))[:, ::-1]
    s_ids[:, -2:] = -1
    s_sc[:, -2:] = 0.0
    d_sc[3, :] = -1.0
    return s_sc, s_ids, d_sc, d_ids


def test_fuse_matches_dict_oracle_random():
    B, k = 17, 10
    s_sc, s_ids, d_sc, d_ids = _random_legs(42, B, 23, 19, 200)
    f_sc, f_ids = fuse_topk_arrays(s_sc, s_ids, d_sc, d_ids, 0.3, 0.7, k)
    for r in range(B):
        want = _fuse_dict_oracle(
            list(zip(s_ids[r].tolist(), s_sc[r].tolist())),
            list(zip(d_ids[r].tolist(), d_sc[r].tolist())),
            0.3,
            0.7,
            k,
        )
        got = [
            (i, s)
            for i, s in zip(f_ids[r].tolist(), f_sc[r].tolist())
            if i >= 0
        ]
        assert len(got) == len(want)
        for (gi, gs), (wi, ws_) in zip(got, want):
            assert gs == pytest.approx(ws_, abs=1e-5)
        assert {i for i, _ in got} == {i for i, _ in want} or all(
            abs(gs - ws_) < 1e-5
            for (_, gs), (_, ws_) in zip(got, want)
        )


def test_fuse_duplicate_doc_sums_both_sides():
    s_sc = np.array([[3.0, 2.0, 1.0]], np.float32)
    s_ids = np.array([[5, 7, 9]])
    d_sc = np.array([[4.0, 2.0]], np.float32)
    d_ids = np.array([[7, 5]])
    f_sc, f_ids = fuse_topk_arrays(s_sc, s_ids, d_sc, d_ids, 0.5, 0.5, 3)
    # sparse norm: 5->1.0, 7->0.5, 9->0.0 ; dense norm: 7->1.0, 5->0.0
    # fused: 5 -> 0.5, 7 -> 0.25 + 0.5 = 0.75, 9 -> 0.0
    assert f_ids[0].tolist() == [7, 5, 9]
    assert f_sc[0].tolist() == pytest.approx([0.75, 0.5, 0.0], abs=1e-6)


def test_fuse_empty_sides():
    empty_sc = np.zeros((2, 4), np.float32)
    empty_ids = np.full((2, 4), -1)
    d_sc = np.array([[2.0, 1.0], [0.0, 0.0]], np.float32)
    d_ids = np.array([[3, 1], [2, 4]])
    f_sc, f_ids = fuse_topk_arrays(
        empty_sc, empty_ids, d_sc, d_ids, 0.3, 0.7, 5
    )
    assert f_ids[0].tolist()[:2] == [3, 1]
    assert f_sc[0][:2].tolist() == pytest.approx([0.7, 0.0], abs=1e-6)
    assert (f_ids[1] == -1).all()
    res = fused_rows_to_results(
        ["a", "b"], f_sc, f_ids, [f"d{i}" for i in range(5)]
    )
    assert res["b"] == {}
    assert list(res["a"].keys())[:2] == ["d3", "d1"]


def _fast_equals_dicts(r, queries, top_k, abs_tol):
    fast = r.search(queries, top_k=top_k)
    slow = r._search_dicts(queries, top_k=top_k)
    assert set(fast) == set(slow)
    for qid in slow:
        assert set(fast[qid]) == set(slow[qid]), qid
        for doc, s in slow[qid].items():
            assert fast[qid][doc] == pytest.approx(s, abs=abs_tol), (qid, doc)


def test_hybrid_fast_path_matches_dict_path():
    corpus = _reference_impl().zipf_corpus(
        num_docs=250, vocab_size=500, avg_len=40
    )
    r = _hybrid(
        sparse_weight=0.3, dense_weight=0.7, embedding_dim=64,
        fusion_depth=30,
    )
    r.build_index_from_corpus(corpus)
    queries = _reference_impl().zipf_queries(32, vocab_size=500)
    queries["empty"] = ""
    queries["blank"] = "  \t "  # whitespace-only: both paths return {}
    # top_k > both depths so no boundary-tie flakiness.
    _fast_equals_dicts(r, queries, 80, 1e-5)


def _rrf_dict_oracle(s_pairs, d_pairs, ws, wd, rrf_k, top_k):
    """Per-query RRF semantics: rank = 1-based position among kept
    entries in descending-score order (stable on input order)."""

    def leg(pairs, weight):
        kept = [(i, s) for i, s in pairs if s > 0 and i >= 0]
        kept.sort(key=lambda kv: -kv[1])  # stable: input order on ties
        return {i: weight / (rrf_k + r) for r, (i, _) in enumerate(kept, 1)}

    fused = {}
    for part in (leg(s_pairs, ws), leg(d_pairs, wd)):
        for i, s in part.items():
            fused[i] = fused.get(i, 0.0) + s
    return fused


def test_fuse_rrf_matches_dict_oracle_random():
    B, k = 11, 10
    s_sc, s_ids, d_sc, d_ids = _random_legs(7, B, 23, 19, 150)
    f_sc, f_ids = fuse_topk_arrays(
        s_sc, s_ids, d_sc, d_ids, 1.0, 1.0, k, mode="rrf", rrf_k=60.0
    )
    for r in range(B):
        fused = _rrf_dict_oracle(
            list(zip(s_ids[r].tolist(), s_sc[r].tolist())),
            list(zip(d_ids[r].tolist(), d_sc[r].tolist())),
            1.0,
            1.0,
            60.0,
            k,
        )
        want = sorted(fused.values(), reverse=True)[:k]
        got = [
            (i, s)
            for i, s in zip(f_ids[r].tolist(), f_sc[r].tolist())
            if i >= 0
        ]
        assert len(got) == len(want)
        # RRF yields exact ties (same-rank singletons), so compare the
        # fused score sequence, and every selected id against the oracle.
        for (gi, gs), ws_ in zip(got, want):
            assert gs == pytest.approx(ws_, abs=1e-6)
            assert gs == pytest.approx(np.float32(fused[gi]), abs=1e-6)


def test_fuse_rrf_scale_free():
    """RRF depends only on ranks: scaling one leg's scores by 1000x must
    not change the fused ranking."""
    rng = np.random.default_rng(3)
    s_sc = np.sort(rng.random((4, 12)).astype(np.float32))[:, ::-1] + 0.1
    d_sc = np.sort(rng.random((4, 12)).astype(np.float32))[:, ::-1] + 0.1
    s_ids = np.stack([rng.permutation(40)[:12] for _ in range(4)])
    d_ids = np.stack([rng.permutation(40)[:12] for _ in range(4)])
    a_sc, a_ids = fuse_topk_arrays(
        s_sc, s_ids, d_sc, d_ids, 1.0, 1.0, 8, mode="rrf"
    )
    b_sc, b_ids = fuse_topk_arrays(
        s_sc * 1000.0, s_ids, d_sc / 1000.0, d_ids, 1.0, 1.0, 8, mode="rrf"
    )
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_allclose(a_sc, b_sc, rtol=1e-6)


def test_fuse_unknown_mode_raises():
    z = np.zeros((1, 2), np.float32)
    i = np.zeros((1, 2), np.int64)
    with pytest.raises(ValueError):
        fuse_topk_arrays(z, i, z, i, 0.5, 0.5, 2, mode="nope")


def test_hybrid_rrf_fast_path_matches_dict_path():
    corpus = _reference_impl().zipf_corpus(
        num_docs=250, vocab_size=500, avg_len=40
    )
    r = _hybrid(fusion="rrf", rrf_k=60.0, embedding_dim=64, fusion_depth=30)
    r.build_index_from_corpus(corpus)
    queries = _reference_impl().zipf_queries(16, vocab_size=500)
    queries["empty"] = ""
    _fast_equals_dicts(r, queries, 80, 1e-6)


def test_set_fusion_retunes_without_rebuild():
    corpus = _reference_impl().zipf_corpus(
        num_docs=200, vocab_size=400, avg_len=30
    )
    r = _hybrid(embedding_dim=32)
    r.build_index_from_corpus(corpus)
    queries = _reference_impl().zipf_queries(8, vocab_size=400)
    base = r.search(queries, top_k=20)
    r.set_fusion(sparse_weight=0.9, dense_weight=0.1)
    reweighted = r.search(queries, top_k=20)
    r.set_fusion(fusion="rrf", sparse_weight=1.0, dense_weight=1.0)
    rrf = r.search(queries, top_k=20)
    fresh = _hybrid(
        embedding_dim=32, fusion="rrf", sparse_weight=1.0, dense_weight=1.0
    )
    fresh.build_index_from_corpus(corpus)
    assert rrf == fresh.search(queries, top_k=20)
    assert base != reweighted or base != rrf

    with pytest.raises(ValueError):
        r.set_fusion(fusion="nope")


# ----------------------------------------------------------------------
# The port against osr_tpu
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_fusion():
    pytest.importorskip("jax")
    from osr_tpu.retrieval import fusion

    return fusion


@pytest.mark.parametrize("mode", ["weighted", "rrf"])
def test_fuse_bit_equal_to_osr_tpu(jax_fusion, mode):
    s_sc, s_ids, d_sc, d_ids = _random_legs(5, 29, 31, 27, 300)
    args = (s_sc, s_ids, d_sc, d_ids, 0.4, 0.6, 12)
    got = fuse_topk_arrays(*args, mode=mode, rrf_k=30.0)
    want = jax_fusion.fuse_topk_arrays(*args, mode=mode, rrf_k=30.0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    names = [f"d{i}" for i in range(300)]
    qids = [f"q{i}" for i in range(29)]
    assert fused_rows_to_results(qids, *got, names) == (
        jax_fusion.fused_rows_to_results(qids, *want, names)
    )


@pytest.fixture(scope="module")
def hybrid_corpus():
    from osr_tpu_torch.testing import SyntheticDataGenerator

    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(
        1_500, 4_000, avg_len=50, word_prefix="t", min_len=5
    )
    queries = SyntheticDataGenerator(seed=6).queries(
        64, 4_000, avg_terms=8, word_prefix="t", min_terms=2
    )
    queries["blank"] = " "
    return corpus, queries


@pytest.mark.parametrize("fusion", ["rrf", "weighted"])
def test_hybrid_matches_osr_tpu(hybrid_corpus, fusion):
    pytest.importorskip("jax")
    from osr_tpu.retrieval.registry import RetrieverRegistry as JaxRegistry

    corpus, queries = hybrid_corpus
    params = {"cache_dir": None, "embedding_dim": 64, "fusion": fusion,
              "fusion_depth": 40}
    jr = JaxRegistry.create({"type": "hybrid", "params": params})
    jr.build_index_from_corpus(corpus)
    want = jr.search(queries, top_k=20)
    r = _hybrid(**params)
    r.build_index_from_corpus(corpus)
    got = r.search(queries, top_k=20)
    assert got.keys() == want.keys()
    assert sum(1 for v in got.values() if v) >= 60
    for qid, w in want.items():
        g = got[qid]
        ws = np.array(list(w.values()))
        gs = np.array(list(g.values()))
        if fusion == "rrf":
            assert list(g) == list(w), qid
            np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
            continue
        assert len(g) == len(w), qid
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                near = [j for j in (i - 1, i + 1) if 0 <= j < len(ws)]
                assert any(abs(ws[i] - ws[j]) <= 2e-5 for j in near), (qid, i)


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------


@pytest.mark.cuda
def test_hybrid_on_card_matches_cpu():
    """The hashing_idf RRF hybrid on the card (K2 for the sparse leg at
    R >= 4,096 and R/128 > 2 x depth, K7 + K5 for the dense leg) against
    the same retriever on the CPU: dense legs equal, sparse legs equal
    within K2's rtol 1e-5 (ids equal except at near-ties), and fused
    results equal wherever the sparse leg's order is the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    from osr_tpu_torch.ops import head, matmul, quantize_kernels
    from osr_tpu_torch.testing import SyntheticDataGenerator

    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(
        6_000, 20_000, avg_len=60, word_prefix="t", min_len=5
    )
    queries = SyntheticDataGenerator(seed=6).queries(
        200, 20_000, avg_terms=8, word_prefix="t", min_terms=2
    )
    params = {"cache_dir": None, "encoder": "hashing_idf",
              "embedding_dim": 256, "fusion": "rrf", "fusion_depth": 16}
    out = {}
    for dev in ("cuda", "cpu"):
        r = RetrieverRegistry.create(
            {"type": "hybrid", "params": {**params, "device": dev}}
        )
        r.build_index_from_corpus(corpus)
        for mod in (head, matmul, quantize_kernels):
            mod.reset_launches()
        fused = r.search(queries, top_k=10)
        launches = {**head.LAUNCHES, **matmul.LAUNCHES,
                    **quantize_kernels.LAUNCHES}
        norm = {q: t.strip() for q, t in queries.items()}
        out[dev] = (fused, r.sparse.search(norm, top_k=16),
                    r.dense.search(norm, top_k=16), launches)
    fused, sparse, dense, launches = out["cuda"]
    for k in ("head_blockmax_i8", "quantize_symmetric", "int8_similarity"):
        assert launches[k] > 0, launches
    c_fused, c_sparse, c_dense, _ = out["cpu"]
    assert dense == c_dense
    same_order = 0
    for qid, w in c_sparse.items():
        g = sparse[qid]
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
        if list(g) == list(w):
            same_order += 1
            assert fused[qid] == c_fused[qid], qid
    assert same_order >= 0.9 * len(queries)
