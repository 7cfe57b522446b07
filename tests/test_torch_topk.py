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
