"""The port's exact top-k (osr_tpu_torch/ops/topk.py) against osr_tpu's
lax.top_k-based selection, on integer-valued scores full of exact ties.
Tolerance: none. Values, rows and their order must be identical, which
holds only if ties resolve toward the lower index as lax.top_k does."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osr_tpu_torch.ops import topk as ttopk

# osr_tpu.ops re-exports a function named topk over its submodule.
jtopk = importlib.import_module("osr_tpu.ops.topk")


def _tied_scores(seed, b, r, levels, neg_inf_frac=0.0):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, levels, (b, r)).astype(np.float32)
    if neg_inf_frac:
        s[:, rng.rand(r) < neg_inf_frac] = -np.inf
    return s


@pytest.mark.parametrize("levels", [2, 5, 40])
@pytest.mark.parametrize("k", [1, 7, 64, 5000])
def test_topk_matches_lax_top_k(levels, k):
    s = _tied_scores(levels, 6, 1_000, levels)
    wv, wi = jtopk.topk(jnp.asarray(s), k=k)
    gv, gi = ttopk.topk(torch.from_numpy(s), k=k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gi.dtype == torch.int32


@pytest.mark.parametrize("r", [1_280, 1_300])  # aligned and ragged
@pytest.mark.parametrize("levels", [3, 50])
@pytest.mark.parametrize("k", [1, 10, 30])
def test_block_topk_matches(r, levels, k):
    s = _tied_scores(r + levels + k, 5, r, levels, neg_inf_frac=0.05)
    wv, wr = jtopk.block_topk(jnp.asarray(s), k=k)
    gv, gr = ttopk.block_topk(torch.from_numpy(s), k=k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))


@pytest.mark.parametrize("levels", [2, 9])
def test_block_topk_from_max_matches(levels):
    s = _tied_scores(levels, 7, 4_096 + 60, levels, neg_inf_frac=0.02)
    pad = np.pad(s, ((0, 0), (0, (-s.shape[1]) % 128)), constant_values=-np.inf)
    bmax = pad.reshape(7, -1, 128).max(axis=2)
    wv, wr = jtopk.block_topk_from_max(jnp.asarray(s), jnp.asarray(bmax), k=12)
    gv, gr = ttopk.block_topk_from_max(
        torch.from_numpy(s), torch.from_numpy(bmax), k=12
    )
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    # A transposed (G, B) maxima view, as the head kernels return it.
    gv2, gr2 = ttopk.block_topk_from_max(
        torch.from_numpy(s), torch.from_numpy(np.ascontiguousarray(bmax.T)).T,
        k=12,
    )
    np.testing.assert_array_equal(gr2.numpy(), gr.numpy())


def test_block_topk_from_max_rejects_wrong_block_count():
    s = torch.zeros(2, 300)
    with pytest.raises(ValueError, match="blocks"):
        ttopk.block_topk_from_max(s, torch.zeros(2, 2), k=3)


# ----------------------------------------------------------------------
# The selections built on topk (tests/test_topk.py's cases on the same
# numpy inputs). osr_tpu's narrowed selection (block_topk_narrow) has no
# counterpart: the port's narrow_m plan runs block_topk_from_max, which
# must equal it bit for bit.
# ----------------------------------------------------------------------


def _blockmax(scores, block_cols=128):
    b, r = scores.shape
    p = np.pad(
        scores, ((0, 0), (0, (-r) % block_cols)), constant_values=-np.inf
    )
    return p.reshape(b, -1, block_cols).max(axis=2)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize(
    "r,b,k,m", [(57_640, 8, 50, 8), (8_192, 16, 20, 4), (6_016, 4, 50, 8)]
)
def test_block_topk_narrow_bit_identical_random(r, b, k, m):
    rng = np.random.RandomState(11)
    s = rng.randn(b, r).astype(np.float32)
    bmax = _blockmax(s)
    wv, wr = jtopk.block_topk_narrow(
        jnp.asarray(s), jnp.asarray(bmax), k=k, block_m=m
    )
    gv, gr = ttopk.block_topk_from_max(_t(s), _t(bmax), k=k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))


def test_block_topk_narrow_clustered_fallback():
    """30 top-k members in one block per query, and exact ties at the
    k-th boundary: osr_tpu's tie-safe fallback gives the full path's
    output, the port's selection."""
    rng = np.random.RandomState(3)
    b, r, k, m = 4, 8_192, 50, 8
    s = rng.randn(b, r).astype(np.float32) * 1e-3
    for q in range(b):
        s[q, (5 + q) * 128 : (5 + q) * 128 + 30] = 100.0
        s[q, 4_000 : 4_000 + k] = 50.0
    bmax = _blockmax(s)
    wv, wr = jtopk.block_topk_narrow(
        jnp.asarray(s), jnp.asarray(bmax), k=k, block_m=m
    )
    gv, gr = ttopk.block_topk_from_max(_t(s), _t(bmax), k=k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))


@pytest.mark.parametrize(
    "r,b,k,m,tie_p",
    [
        (1_000, 16, 50, 8, 0.1),
        (4_096, 4, 10, 2, 0.5),
        (300, 2, 300, 1, 0.0),  # nb * m < k: the full-width selection
        (512, 3, 4, 1, 0.9),
        (20_000, 2, 100, 16, 0.3),
    ],
)
def test_block_topk_narrow_vs_argsort_sweep(r, b, k, m, tie_p):
    rng = np.random.RandomState(7)
    s = rng.randn(b, r).astype(np.float32)
    s[rng.rand(b, r) < tie_p] = 1.5
    bmax = _blockmax(s)
    gv, gr = ttopk.block_topk_from_max(_t(s), _t(bmax), k=k)
    wv, wr = jtopk.block_topk_narrow(
        jnp.asarray(s), jnp.asarray(bmax), k=k, block_m=m
    )
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    kk = min(k, r)
    np.testing.assert_array_equal(gv.numpy(), -np.sort(-s, axis=1)[:, :kk])
    for i in range(b):
        np.testing.assert_array_equal(s[i, gr[i].numpy()], gv[i].numpy())
        assert len(set(gr[i].tolist())) == kk


@pytest.mark.parametrize("clustered", [False, True])
@pytest.mark.parametrize("m", [4, 8])
def test_blocktopm_topk_matches(clustered, m):
    """Selection from per-block top-m candidates: values, rows and the
    tie-safety flag equal osr_tpu's; with the flag clear, the positive
    part of the result is the full-width selection's."""
    rng = np.random.RandomState(13 + m)
    b, r, k = 6, 6_016, 20
    # A wide range of integers: the flag stays clear unless clustered.
    s = rng.randint(-3, 100_000, (b, r)).astype(np.float32)
    s[:, ::7] = 50.0  # many exact ties, below the top-k
    if clustered:
        s[:, 256 : 256 + 30] = 1e6
    vals, rows = ttopk.block_topm(_t(s), m)
    wv, wr, wu = jtopk.blocktopm_topk(
        jnp.asarray(vals.numpy()), jnp.asarray(rows.numpy()), k=k
    )
    gv, gr, gu = ttopk.blocktopm_topk(vals, rows, k=k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    assert gu.dim() == 0 and gu.dtype == torch.bool
    assert bool(gu) == bool(wu) == clustered
    if not clustered:
        fv, fr = ttopk.block_topk_from_max(_t(s), _t(_blockmax(s)), k=k)
        pos = fv.numpy() > 0
        np.testing.assert_array_equal(gv.numpy()[pos], fv.numpy()[pos])
        np.testing.assert_array_equal(gr.numpy()[pos], fr.numpy()[pos])


@pytest.mark.parametrize("levels", [4, 1_000_000])
def test_merge_chunks_matches_merge_packed_chunks(levels):
    """Chunk-major candidates, one stable selection: osr_tpu's merge of
    packed chunks (rows as f32 values) gives the same top-k."""
    from osr_tpu.ops import bm25 as jbm25

    from osr_tpu_torch.ops import bm25 as tbm25

    rng = np.random.RandomState(levels % 97)
    c, b, k, rc = 3, 5, 10, 4_096
    s = rng.randint(0, levels, (b, c * rc)).astype(np.float32)
    vals, rows = [], []
    for ci in range(c):
        v, i = ttopk.topk(_t(s[:, ci * rc : (ci + 1) * rc]), k=k)
        vals.append(v.numpy())
        rows.append(i.numpy())
    vals, rows = np.stack(vals), np.stack(rows)
    bases = np.arange(c) * rc
    packed = np.concatenate([vals, rows.astype(np.float32)], axis=2)
    want = np.asarray(
        jbm25.merge_packed_chunks(
            jnp.asarray(packed), jnp.asarray(bases.astype(np.float32))
        )
    )
    top, grows = tbm25.merge_chunks(_t(vals), _t(rows), _t(bases))
    assert grows.dtype == torch.int32
    np.testing.assert_array_equal(top.numpy(), want[:, :k])
    np.testing.assert_array_equal(grows.numpy(), want[:, k:].astype(np.int32))
    ev, ei = ttopk.topk(_t(s), k=k)
    np.testing.assert_array_equal(top.numpy(), ev.numpy())
    np.testing.assert_array_equal(grows.numpy(), ei.numpy())


@pytest.mark.parametrize("k", [1, 50, 1000])
def test_topk_outputs_hold_only_k_columns(k):
    """The values and indices own k columns each, not the sort's full
    width, so a row-chunked step that keeps every chunk's top-k until the
    merge does not keep every chunk's sort."""
    scores = torch.from_numpy(
        np.random.default_rng(k).standard_normal((8, 4096)).astype(np.float32))
    vals, idx = ttopk.topk(scores, k=k)
    assert vals.shape == idx.shape == (8, k)
    assert vals.untyped_storage().nbytes() == 8 * k * 4
    assert idx.untyped_storage().nbytes() == 8 * k * 4
    want = torch.sort(scores, dim=-1, descending=True, stable=True)
    assert torch.equal(vals, want.values[:, :k])
    assert torch.equal(idx.long(), want.indices[:, :k])
