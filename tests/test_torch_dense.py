"""The port's DenseSearchEngine (osr_tpu_torch/retrieval/engine.py) against
osr_tpu's, both on the CPU, with osr_tpu's Pallas kernels in interpret
mode (patched in as tests/test_pallas_kernels.py patches them).

Tolerances:
- symmetric and int4: ids equal, scores within rtol 1e-6. The integer sums
  are exact on both sides, and the codes and scales equal osr_tpu's bit
  for bit (both multiply by the f32 reciprocal of 127 or 7); only the
  rescale's f32 products may round in another order;
- asymmetric, int4_grouped and none: scores rank by rank within atol
  3e-5, the f32 summation-order bound 2 D 2^-24 sum_c |q_c d_c| at D = 256
  for unit-norm rows (sum_c |q_c d_c| <= 1); the four terms of the
  asymmetric score stay far inside it (8 ulp of their magnitudes, below
  1e-5 here). Ids are equal except at the reference's near-ties (a
  neighbour within 2 atol), whose order the summation order may flip.

Tests marked ``cuda`` hold the kernel engine to the plain engine on the
card (ids equal, scores bit-equal) and skip without one. On the card they
run with ``python -m pytest --noconftest -m cuda tests/test_torch_dense.py``.
"""

import contextlib
import unittest.mock as mock

import numpy as np
import pytest
import torch

from osr_tpu_torch.convert import dense_engine_from_arrays
from osr_tpu_torch.index.dense import synthetic_corpus_embeddings
from osr_tpu_torch.ops import matmul as tmm
from osr_tpu_torch.ops import quantize as tqz
from osr_tpu_torch.ops import quantize_kernels as tqk
from osr_tpu_torch.ops.topk import block_topk, topk
from osr_tpu_torch.retrieval.engine import (
    FUSED_MAXIMA_MIN_ROWS,
    DenseSearchEngine,
    dense_kernel_scores,
    dense_kernel_step,
)

RTOL = 1e-6
F32_ATOL = 3e-5


@pytest.fixture
def jax_ref():
    """osr_tpu's dense engine (JAX on the CPU); absent on the card's
    machine, where only the kernel tests run."""
    pytest.importorskip("jax")
    from osr_tpu.retrieval import engine

    return engine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    return torch.device("cuda")


@contextlib.contextmanager
def pallas_interpret():
    """osr_tpu's similarity kernels in interpret mode (CPU)."""
    from osr_tpu.ops.pallas import matmul as pmm

    real8, real4 = pmm.int8_similarity_pallas, pmm.int4_similarity_pallas
    with mock.patch.object(
        pmm, "int8_similarity_pallas",
        side_effect=lambda *a, **k: real8(*a, **{**k, "interpret": True}),
    ), mock.patch.object(
        pmm, "int4_similarity_pallas",
        side_effect=lambda *a, **k: real4(*a, **{**k, "interpret": True}),
    ):
        yield


# (docs, queries): 200 docs pad to 256 rows in osr_tpu's Pallas engine and
# 30 queries to 128; 2,200 docs take the block-pruned selection. A chunked
# Pallas engine rounds score_chunk_rows=700 up to 768 rows: 3 chunks.
CORPORA = {"padded": (200, 30), "block_pruned": (2_200, 30)}


def _corpus(name, dim=256, seed=11):
    n, b = CORPORA[name]
    emb = synthetic_corpus_embeddings(n + b, dim=dim, seed=seed)
    return [f"d{i}" for i in range(n)], emb[:n], emb[n:]


def _tied_corpus(n, distinct=20, dim=256, queries=70, seed=0):
    """n rows drawn from ``distinct`` rows, so every top-k of fewer than
    n / distinct rows is made of ties (the k-th score repeats past the
    k-th place); and the queries."""
    rng = np.random.RandomState(seed)
    base = synthetic_corpus_embeddings(distinct, dim=dim, seed=seed)
    return (base[rng.randint(0, distinct, n)],
            synthetic_corpus_embeddings(queries, dim=dim, seed=seed + 1))


# dense_kernel_step's corpora against osr_tpu: CORPORA's (the block-pruned
# one's 2,200 docs and 30 queries take K5/K6's block maxima, 30 >=
# FUSED_MAXIMA_MIN_ROWS), and "tied": 2,200 rows drawn from 20, so that
# every top-7 is made of ties past the 7th place.
STEP_CORPORA = sorted(CORPORA) + ["tied"]


def _step_corpus(name):
    if name != "tied":
        return _corpus(name)
    emb, queries = _tied_corpus(2_200, queries=30, seed=11)
    return [f"d{i}" for i in range(len(emb))], emb, queries


def _same(got, want, atol=None):
    """Exact ids and scores within RTOL; or, with ``atol`` (the f32
    modes), scores rank by rank within atol and ids equal except where the
    reference holds a near-tie (a neighbour's score within 2 atol), whose
    order the f32 summation order may flip."""
    assert got[1].dtype == np.int32
    if atol is None:
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
        return
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=atol)
    ws = want[0]
    for r, i in zip(*np.nonzero(got[1] != want[1])):
        near = [j for j in (i - 1, i + 1) if 0 <= j < ws.shape[1]]
        assert any(abs(ws[r, i] - ws[r, j]) <= 2 * atol for j in near), (r, i)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("jax_backend", ["pallas", "xla"])
@pytest.mark.parametrize("quantization", ["symmetric", "int4"])
def test_engine_matches_osr_tpu(jax_ref, quantization, jax_backend, corpus):
    doc_ids, docs, queries = _corpus(corpus)
    with pallas_interpret():
        jeng = jax_ref.DenseSearchEngine(
            doc_ids, docs, quantization=quantization, backend=jax_backend
        )
        want = jeng.search_vectors(queries, top_k=7)
    eng = DenseSearchEngine(doc_ids, docs, quantization=quantization,
                            device="cpu")
    assert eng.backend == "torch"
    _same(eng.search_vectors(queries, top_k=7), want)
    assert eng._docs.shape == (len(doc_ids), 256 // (
        2 if quantization == "int4" else 1))  # no padding rows


@pytest.mark.parametrize(
    "quantization", ["asymmetric", "int4_grouped", "none"]
)
def test_other_quantizations_match_osr_tpu(jax_ref, quantization):
    doc_ids, docs, queries = _corpus("padded", seed=3)
    jeng = jax_ref.DenseSearchEngine(doc_ids, docs, quantization=quantization)
    eng = DenseSearchEngine(doc_ids, docs, quantization=quantization,
                            device="cpu")
    _same(eng.search_vectors(queries, top_k=7),
          jeng.search_vectors(queries, top_k=7), atol=F32_ATOL)
    with pytest.raises(ValueError):
        DenseSearchEngine(doc_ids, docs, quantization=quantization,
                          device="cpu", backend="cuda")


@pytest.mark.parametrize("corpus", STEP_CORPORA)
@pytest.mark.parametrize("quantization", ["symmetric", "int4"])
def test_kernel_step_matches_pallas_dense_step(jax_ref, quantization, corpus):
    """dense_kernel_step (the kernel path: K7, K5/K6, selection) on CPU
    tensors, where each wrapper runs its plain version, against osr_tpu's
    one-dispatch Pallas step over its zero-scale padded rows: the
    scores-only selection below 2,048 docs, the selection from the
    kernels' block maxima at 2,200 (one blockmax call), ties included."""
    import jax.numpy as jnp

    doc_ids, docs, queries = _step_corpus(corpus)
    with pallas_interpret():
        jeng = jax_ref.DenseSearchEngine(
            doc_ids, docs, quantization=quantization, backend="pallas"
        )
        packed = np.asarray(jax_ref._pallas_dense_step(
            jnp.asarray(queries), jeng._docs, jeng._scales,
            n_real=len(doc_ids), k=7,
        ))
    rows = np.asarray(jeng._docs)[: len(doc_ids)]
    scales = np.asarray(jeng._scales)[: len(doc_ids)]
    before = {**tqk.LAUNCHES, **tmm.LAUNCHES}
    name = ("int4" if quantization == "int4"
            else "int8") + "_similarity_blockmax"
    with mock.patch.object(tmm, name, wraps=getattr(tmm, name)) as fused:
        vals, ids = dense_kernel_step(
            torch.from_numpy(queries), torch.from_numpy(rows),
            torch.from_numpy(scales), 7,
        )
    assert fused.call_count == int(len(doc_ids) >= tqz.BLOCK_SELECT_MIN_COLS)
    assert {**tqk.LAUNCHES, **tmm.LAUNCHES} == before  # plain on the CPU
    if corpus == "tied":  # the 7th score repeats past the 7th place
        scores = dense_kernel_scores(torch.from_numpy(queries),
                                     torch.from_numpy(rows),
                                     torch.from_numpy(scales))
        assert (scores == vals[:, -1:]).sum(1).min() > 7
    _same((vals.numpy(), ids.numpy()),
          (packed[:, :7], packed[:, 7:].astype(np.int32)))


QUANTIZE = {"symmetric": tqz.quantize_symmetric,
            "int4": tqz.quantize_symmetric_int4}


@pytest.mark.parametrize(
    "b", [FUSED_MAXIMA_MIN_ROWS - 1, FUSED_MAXIMA_MIN_ROWS, 70])
@pytest.mark.parametrize("quantization", sorted(QUANTIZE))
@pytest.mark.parametrize("n", [1_000, 2_047, 2_048, 5_000])
def test_kernel_step_on_cpu_tensors_unchanged(quantization, n, b):
    """dense_kernel_step on CPU tensors (the wrappers' plain twins) gives
    the rows and scores of the selection over the scores-only path,
    ``_select_topk``, below the 2,048-document and the batch-size
    crossovers and above both (only there through the blockmax wrapper),
    with ties at the k-th place, and launches (counts) nothing."""
    emb, queries = _tied_corpus(n, queries=b, seed=n)
    docs, scales = QUANTIZE[quantization](torch.from_numpy(emb))
    q = torch.from_numpy(queries)
    before = dict(tmm.LAUNCHES)
    name = ("int4" if quantization == "int4"
            else "int8") + "_similarity_blockmax"
    with mock.patch.object(tmm, name, wraps=getattr(tmm, name)) as fused:
        got = dense_kernel_step(q, docs, scales, 25)
    assert fused.call_count == int(
        n >= tqz.BLOCK_SELECT_MIN_COLS and b >= FUSED_MAXIMA_MIN_ROWS)
    assert tmm.LAUNCHES == before
    scores = dense_kernel_scores(q, docs, scales)
    want = tqz._select_topk(scores, 25)
    assert (scores == want[0][:, -1:]).sum(1).min() > 25  # the planted ties
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_search_dicts_match_osr_tpu(jax_ref):
    doc_ids, docs, queries = _corpus("padded", seed=5)
    qmap = {f"q{i}": q for i, q in enumerate(queries)}
    jeng = jax_ref.DenseSearchEngine(doc_ids, docs)
    eng = DenseSearchEngine(doc_ids, docs, device="cpu")
    for min_score in (0.0, 0.5):
        want = jeng.search(qmap, top_k=5, min_score=min_score)
        got = eng.search(qmap, top_k=5, min_score=min_score)
        assert list(got) == list(want)
        for qid in want:
            assert list(got[qid]) == list(want[qid])
            np.testing.assert_allclose(
                list(got[qid].values()), list(want[qid].values()), rtol=RTOL
            )
    assert eng.search({}) == {}


def test_large_corpus_self_hit():
    """Over a corpus wide enough for the block-pruned selection, each
    query's nearest neighbour is its own source document."""
    docs = synthetic_corpus_embeddings(2200, dim=48, seed=12)
    eng = DenseSearchEngine([f"d{i}" for i in range(2200)], docs,
                            device="cpu")
    queries = docs[:6] + 0.01 * np.random.RandomState(4).randn(6, 48).astype(
        np.float32
    )
    scores, ids = eng.search_vectors(queries, top_k=5)
    assert scores.shape == (6, 5) and ids.shape == (6, 5)
    assert (np.diff(scores, axis=1) <= 0).all()
    np.testing.assert_array_equal(ids[:, 0], np.arange(6))


def _outlier_embeddings(n=400, d=256, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32) * 0.05
    x[np.arange(n), rng.randint(0, d, size=n)] += rng.choice(
        [-3.0, 3.0], size=n
    )
    return x


def test_int4_grouped_ranks_better_than_per_row():
    """With one outlier per row, group scales keep the top-1 agreement
    with f32 search above per-row int4's."""
    x = _outlier_embeddings()
    ids = [f"d{i}" for i in range(len(x))]
    q = {f"q{i}": x[i * 7] + 0.01 * np.random.RandomState(i).randn(256)
         for i in range(40)}
    top1 = {}
    for mode in ("none", "int4", "int4_grouped"):
        res = DenseSearchEngine(ids, x, quantization=mode, device="cpu").search(
            q, top_k=5, min_score=-1e30
        )
        top1[mode] = [next(iter(res[qid]), None) for qid in q]

    def agree(mode):
        return np.mean([a == b for a, b in zip(top1["none"], top1[mode])])

    assert agree("int4_grouped") >= agree("int4")
    assert agree("int4_grouped") >= 0.8


# ----------------------------------------------------------------------
# from_quantized, chunking and carrying an osr_tpu engine across
# ----------------------------------------------------------------------

QFN = {
    "symmetric": tqz.quantize_symmetric_np,
    "int4": tqz.quantize_symmetric_int4_np,
    "int4_grouped": tqz.quantize_symmetric_int4_grouped_np,
}


@pytest.mark.parametrize("quantization", sorted(QFN))
def test_from_quantized_chunked_matches_unchunked(jax_ref, quantization):
    """Row-chunked scoring equals one sweep, uneven last chunk included,
    and both equal osr_tpu's chunked engine."""
    emb = synthetic_corpus_embeddings(470, dim=256, seed=21)
    docs, queries = emb[:437], emb[437:470]  # 437 = 3 x 128 + 53
    doc_ids = [f"d{i}" for i in range(437)]
    rows, scales = QFN[quantization](docs)
    flat = DenseSearchEngine.from_quantized(
        doc_ids, rows, scales, quantization=quantization, device="cpu"
    )
    chunked = DenseSearchEngine.from_quantized(
        doc_ids, rows, scales, quantization=quantization, device="cpu",
        score_chunk_rows=128,
    )
    assert flat._chunks is None and len(chunked._chunks) == 4
    atol = F32_ATOL if quantization == "int4_grouped" else None
    want = flat.search_vectors(queries, top_k=9)
    _same(chunked.search_vectors(queries, top_k=9), want)
    jeng = jax_ref.DenseSearchEngine.from_quantized(
        doc_ids, rows, scales, quantization=quantization,
        score_chunk_rows=128,
    )
    _same(want, jeng.search_vectors(queries, top_k=9), atol=atol)
    # top_k past the last chunk's size still returns min(top_k, N).
    s3, i3 = chunked.search_vectors(queries[:4], top_k=200)
    assert s3.shape == (4, 200) and i3.shape == (4, 200)
    _same((s3, i3), flat.search_vectors(queries[:4], top_k=200))


@pytest.mark.parametrize("quantization", sorted(QFN))
def test_from_quantized_matches_constructor(jax_ref, quantization):
    from osr_tpu.ops import quantize as jqz

    doc_ids, docs, queries = _corpus("padded")
    rows, scales = QFN[quantization](docs)
    pre = DenseSearchEngine.from_quantized(
        doc_ids, rows, scales, quantization=quantization, device="cpu"
    )
    regular = DenseSearchEngine(doc_ids, docs, quantization=quantization,
                                device="cpu")
    # The device quantizers' scales are osr_tpu's XLA scales bit for bit;
    # the NumPy twins divide, as osr_tpu's do: one ulp of scale at most.
    want_scales = getattr(jqz, QFN[quantization].__name__[:-3])(docs)[1]
    np.testing.assert_array_equal(
        regular._scales.numpy(), np.asarray(want_scales)
    )
    _same(pre.search_vectors(queries, top_k=9),
          regular.search_vectors(queries, top_k=9),
          atol=F32_ATOL if quantization == "int4_grouped" else None)


@pytest.mark.parametrize(
    "case", ["dtype", "grouped_scales_1d", "length", "asymmetric"]
)
def test_from_quantized_refuses(case):
    rows, scales = tqz.quantize_symmetric_np(
        synthetic_corpus_embeddings(10, dim=32, seed=1)
    )
    ids = [f"d{i}" for i in range(10)]
    kw = dict(quantization="symmetric", device="cpu")
    if case == "dtype":
        rows = rows.astype(np.int16)
    elif case == "grouped_scales_1d":
        rows, kw["quantization"] = rows.view(np.uint8), "int4_grouped"
    elif case == "length":
        ids = ids[:-1]
    else:
        kw["quantization"] = "asymmetric"
    with pytest.raises(ValueError):
        DenseSearchEngine.from_quantized(ids, rows, scales, **kw)


@pytest.mark.parametrize(
    "kind", ["pallas", "xla", "chunked", "asymmetric", "none"]
)
def test_carry_across_from_osr_tpu(jax_ref, kind):
    """An osr_tpu engine's arrays, through convert.py, give an engine that
    returns osr_tpu's (scores, ids)."""
    doc_ids, docs, queries = _corpus("block_pruned", seed=8)
    quantization = kind if kind in ("asymmetric", "none") else "int4"
    with pallas_interpret():
        if kind == "chunked":
            rows, sc = tqz.quantize_symmetric_np(docs)
            jeng = jax_ref.DenseSearchEngine.from_quantized(
                doc_ids, rows, sc, score_chunk_rows=700, backend="pallas"
            )
            quantization = "symmetric"
        else:
            jeng = jax_ref.DenseSearchEngine(
                doc_ids, docs, quantization=quantization,
                backend="pallas" if kind == "pallas" else "xla",
            )
        want = jeng.search_vectors(queries, top_k=11)
    if kind == "chunked":
        state = dict(
            docs=np.concatenate([np.asarray(c[0])[: c[3]] for c in jeng._chunks]),
            scales=np.concatenate(
                [np.asarray(c[1])[: c[3]] for c in jeng._chunks]
            ),
            score_chunk_rows=jeng._chunk_rows,
        )
    else:
        state = dict(
            docs=np.asarray(jeng._docs),
            scales=None if jeng._scales is None else np.asarray(jeng._scales),
            mins=None if jeng._mins is None else np.asarray(jeng._mins),
        )
    eng = dense_engine_from_arrays(
        doc_ids=doc_ids, quantization=quantization, device="cpu", **state
    )
    if kind == "chunked":
        assert len(eng._chunks) == len(jeng._chunks) == 3
    _same(eng.search_vectors(queries, top_k=11), want,
          atol=F32_ATOL if kind in ("asymmetric", "none") else None)


def test_carry_across_refuses_bad_state():
    rows, sc = tqz.quantize_symmetric_np(
        synthetic_corpus_embeddings(10, dim=32, seed=1)
    )
    ids = [f"d{i}" for i in range(10)]
    with pytest.raises(ValueError):  # int8 rows are not int4
        dense_engine_from_arrays(doc_ids=ids, docs=rows, scales=sc,
                                 quantization="int4", device="cpu")
    with pytest.raises(ValueError):  # fewer rows than ids
        dense_engine_from_arrays(doc_ids=ids + ["x"], docs=rows, scales=sc,
                                 quantization="symmetric", device="cpu")
    with pytest.raises(ValueError):  # asymmetric without mins
        dense_engine_from_arrays(doc_ids=ids, docs=rows.view(np.uint8),
                                 scales=sc, quantization="asymmetric",
                                 device="cpu")


def test_backend_and_device_selection():
    doc_ids, docs, _ = _corpus("padded")
    eng = DenseSearchEngine(doc_ids, docs, device="cpu")
    assert eng.backend == "torch" and eng.device.type == "cpu"
    for kw in (dict(backend="cuda"), dict(backend="pallas"),
               dict(quantization="int3")):
        with pytest.raises(ValueError):
            DenseSearchEngine(doc_ids, docs, device="cpu", **kw)
    with pytest.raises(ValueError):
        DenseSearchEngine(doc_ids[:-1], docs, device="cpu")
    with pytest.raises(ValueError):
        eng.search_vectors(np.zeros((2, 128), np.float32), top_k=3)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    doc_ids, docs, _ = _corpus("padded")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseSearchEngine(doc_ids, docs)


# ----------------------------------------------------------------------
# The kernel engine on the card
# ----------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("quantization", ["symmetric", "int4"])
@pytest.mark.parametrize("n,dim,chunk", [(2_200, 256, None),
                                          (1_000, 776, None),
                                          (437, 768, 128)])
def test_kernel_engine_matches_plain_engine_on_card(
    cuda, quantization, n, dim, chunk
):
    emb = synthetic_corpus_embeddings(n + 37, dim=dim, seed=n)
    doc_ids = [f"d{i}" for i in range(n)]
    kernel = DenseSearchEngine(doc_ids, emb[:n], quantization=quantization,
                               device="cuda")
    assert kernel.backend == "cuda"
    plain = DenseSearchEngine(doc_ids, emb[:n], quantization=quantization,
                              device="cuda", backend="torch")
    if chunk:
        rows, sc = QFN[quantization](emb[:n])
        kernel = DenseSearchEngine.from_quantized(
            doc_ids, rows, sc, quantization=quantization, device="cuda",
            score_chunk_rows=chunk,
        )
        plain = DenseSearchEngine.from_quantized(
            doc_ids, rows, sc, quantization=quantization, device="cuda",
            backend="torch",
        )
    name = "int4_similarity" if quantization == "int4" else "int8_similarity"
    before = tmm.LAUNCHES[name]
    got = kernel.search_vectors(emb[n:], top_k=50)
    assert tmm.LAUNCHES[name] > before
    want = plain.search_vectors(emb[n:], top_k=50)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b", [1, FUSED_MAXIMA_MIN_ROWS - 1, FUSED_MAXIMA_MIN_ROWS, 70])
@pytest.mark.parametrize("quantization", ["symmetric", "int4"])
@pytest.mark.parametrize("n", [2_047, 2_048, 5_000])
def test_kernel_step_blockmax_matches_block_topk_on_card(
    cuda, quantization, n, b
):
    """From 2,048 documents and FUSED_MAXIMA_MIN_ROWS queries on,
    dense_kernel_step and the engine's search take K5/K6's block maxima
    (one blockmax launch a step, none otherwise) and return exactly
    ``block_topk`` of the kernel's scores, the planted ties at the k-th
    place in row order."""
    emb, queries = _tied_corpus(n, queries=b, seed=n)
    doc_ids = [f"d{i}" for i in range(n)]
    eng = DenseSearchEngine(doc_ids, emb, quantization=quantization,
                            device="cuda")
    q = torch.from_numpy(queries).to(cuda)
    scores = dense_kernel_scores(q, eng._docs, eng._scales)
    want = block_topk(scores, k=25)
    assert torch.equal(want[1], topk(scores, k=25)[1])
    assert (scores == want[0][:, -1:]).sum(1).min() > 25  # the planted ties
    name = ("int4_similarity" if quantization == "int4"
            else "int8_similarity") + "_blockmax"
    fused = int(n >= tqz.BLOCK_SELECT_MIN_COLS and b >= FUSED_MAXIMA_MIN_ROWS)
    before = tmm.LAUNCHES[name]
    got = dense_kernel_step(q, eng._docs, eng._scales, 25)
    torch.cuda.synchronize()
    assert tmm.LAUNCHES[name] == before + fused
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    vals, rows = eng.search_vectors(queries, top_k=25)
    assert tmm.LAUNCHES[name] == before + 2 * fused
    np.testing.assert_array_equal(rows, want[1].cpu().numpy())
    np.testing.assert_array_equal(vals, want[0].cpu().numpy())
    res = eng.search({f"q{i}": v for i, v in enumerate(queries)}, top_k=25,
                     min_score=float("-inf"))
    for i, hits in enumerate(res.values()):
        assert list(hits) == [doc_ids[r] for r in rows[i]]
        assert list(hits.values()) == vals[i].tolist()
