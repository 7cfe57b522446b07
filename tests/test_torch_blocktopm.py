"""K4, the per-block top-m extraction (osr_tpu_torch/ops/head.py:
masked_head_blocktopm, csrc/head_wgmma.cu), and the extraction step
(ops/bm25.py:fused_search_extract), against osr_tpu's Pallas kernel in
interpret mode and its fused_search_extract, as
tests/test_pallas_kernels.py runs them on the CPU.

Tolerances:
- on exact-sum inputs (power-of-two column scales, integer query counts)
  every dot product is exact in f32 whatever the summation order, so
  values must be bit-equal, and rows equal wherever the value is finite
  (osr_tpu leaves the row of a -inf value unspecified);
- on random inputs the scores of the two sides differ only in f32
  summation order: values within 4 F 2^-24 sum_j |q_j w_ij| (the bound of
  tests/test_torch_head.py), and each row's exact score within twice that
  of the value at its rank (a near-tie may swap two rows).

Tests marked ``cuda`` hold the kernel against its plain twin and K2/K3 on
the card and skip without one; run them there with ``python -m pytest
--noconftest -m cuda tests/test_torch_blocktopm.py``.
"""

import numpy as np
import pytest
import torch

from osr_tpu_torch.ops import bm25 as tbm25
from osr_tpu_torch.ops import head as thead
from osr_tpu_torch.ops import topk as ttopk


@pytest.fixture
def jax_ref():
    """osr_tpu's head and bm25 modules (JAX on the CPU); absent on the
    card's machine, where only the kernel tests run."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from osr_tpu.ops import bm25
    from osr_tpu.ops.pallas import head

    return jnp, bm25, head


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    return torch.device("cuda")


def _case(dtype, seed, b, r, f, exact_sum, fp=None):
    """(head, scales, qhead, valid, codes (R, f) float64). int8 heads have
    width fp (f by default; columns f and up are zero). int4 heads are
    block-packed with packed width fp (f <= 2 fp), 128 by default as the
    Pallas int4 kernel needs. Exact-sum cases draw codes from a few
    levels, so many dots tie."""
    rng = np.random.RandomState(seed)
    if dtype == "int8":
        codes = (
            rng.randint(-2, 3, (r, f)) if exact_sum
            else rng.randint(-127, 128, (r, f))
        ).astype(np.int8)
        head = np.zeros((r, fp or f), np.int8)
        head[:, :f] = codes
    else:
        fp = fp or 128
        full = (
            rng.randint(0, 3, (r, 2 * fp)) if exact_sum
            else rng.randint(0, 16, (r, 2 * fp))
        ).astype(np.uint8)
        full[:, f:] = 0
        head = (full[:, :fp] | (full[:, fp:] << 4)).astype(np.uint8)
        codes = full[:, :f]
    if exact_sum:
        scales = (2.0 ** -rng.randint(2, 6, f)).astype(np.float32)
        if dtype == "int4":
            scales *= np.where(rng.rand(f) < 0.3, -1.0, 1.0).astype(np.float32)
        # Few terms a query: many dots tie.
        qhead = (rng.randint(1, 3, (b, f)) * (rng.rand(b, f) < 0.05)).astype(
            np.float32
        )
    else:
        sign = 1.0 if dtype == "int8" else np.where(rng.rand(f) < 0.3, -1, 1)
        scales = (sign * (rng.rand(f) + 0.1) / 127.0).astype(np.float32)
        qhead = rng.randint(0, 4, (b, f)).astype(np.float32)
    valid = rng.rand(r) > 0.1
    return head, scales, qhead, valid, codes.astype(np.float64)


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16
    ).float().numpy().astype(np.float64)


def _exact_scores(scales, qhead, codes, valid):
    """(B, R) float64 scores of the bf16-rounded scaled query (exact dots),
    -inf on invalid rows."""
    s = _bf16(qhead * scales[None, :]) @ codes.T
    s[:, ~valid] = -np.inf
    return s


def _bound(scales, qhead, codes):
    q = np.abs(_bf16(qhead * scales[None, :]))
    return 4 * codes.shape[1] * 2.0**-24 * (q @ np.abs(codes).T)


def _oracle(scores, m):
    """NumPy per-block top-m with lax.top_k tie order: sort by (-value,
    lane); rows past R are -inf."""
    b, r = scores.shape
    g = -(-r // 128)
    padded = np.pad(
        scores, ((0, 0), (0, g * 128 - r)), constant_values=-np.inf
    ).reshape(b, g, 128)
    order = np.lexsort(
        (np.broadcast_to(np.arange(128), padded.shape), -padded), axis=2
    )[:, :, :m]
    return (
        np.take_along_axis(padded, order, axis=2),
        order + (np.arange(g) * 128)[None, :, None],
    )


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("exact_sum", [False, True])
def test_blocktopm_plain_matches_pallas_interpret(jax_ref, dtype, exact_sum):
    jnp, _, jhead = jax_ref
    r, f, b, m = 700, 160, 9, 4  # unaligned rows: a ragged last block
    head, scales, qhead, valid, codes = _case(dtype, 5, b, r, f, exact_sum)
    want_v, want_r = jhead.masked_head_blocktopm(
        jnp.asarray(head), jnp.asarray(scales), jnp.asarray(qhead),
        jnp.asarray(valid), m=m, interpret=True,
    )
    before = dict(thead.LAUNCHES)
    got_v, got_r = thead.masked_head_blocktopm(
        *_t(head, scales, qhead, valid), m=m
    )
    assert thead.LAUNCHES == before  # the CPU path launches no kernel
    g = -(-r // 128)
    assert got_v.shape == got_r.shape == (b, g, m)
    assert got_v.dtype == torch.float32 and got_r.dtype == torch.int32
    # osr_tpu pads the rows to 1,024: its extra blocks are all -inf.
    want_v, want_r = np.asarray(want_v), np.asarray(want_r)
    assert np.all(want_v[:, g:] == -np.inf)
    want_v, want_r = want_v[:, :g], want_r[:, :g]
    got_v, got_r = got_v.numpy(), got_r.numpy()
    finite = np.isfinite(want_v)
    np.testing.assert_array_equal(np.isfinite(got_v), finite)
    if exact_sum:
        np.testing.assert_array_equal(got_v, want_v)
        np.testing.assert_array_equal(got_r[finite], want_r[finite])
        ties = sum(
            len(np.unique(row[np.isfinite(row)])) < np.isfinite(row).sum()
            for row in want_v.reshape(-1, m)
        )
        assert ties > 10  # the case really holds ties
    else:
        exact = _exact_scores(scales, qhead, codes, valid)
        tol = _bound(scales, qhead, codes).max()
        assert np.all(np.abs(got_v[finite] - want_v[finite]) <= tol)
        rows_score = np.take_along_axis(
            exact, got_r.reshape(b, -1).clip(0, r - 1), axis=1
        ).reshape(got_r.shape)
        assert np.all(np.abs(rows_score[finite] - want_v[finite]) <= 2 * tol)
    # The plain twin is the oracle of its own masked scores, rows too.
    own = thead.masked_head_scores_plain(*_t(head, scales, qhead, valid))
    ov, orow = _oracle(own.numpy(), m)
    np.testing.assert_array_equal(got_v, ov)
    np.testing.assert_array_equal(got_r, orow)


def test_block_topm_orders_ties_and_padding():
    scores = torch.tensor(
        [[1.0, 3.0, 3.0, -np.inf, 2.0, 3.0] + [0.0] * 124]
    )
    vals, rows = ttopk.block_topm(scores, 4)
    assert vals.shape == (1, 2, 4)
    np.testing.assert_array_equal(vals[0, 0].numpy(), [3.0, 3.0, 3.0, 2.0])
    np.testing.assert_array_equal(rows[0, 0].numpy(), [1, 2, 5, 4])
    # The ragged last block: two real rows, then -inf padding in row order.
    np.testing.assert_array_equal(
        vals[0, 1].numpy(), [0.0, 0.0, -np.inf, -np.inf]
    )
    np.testing.assert_array_equal(rows[0, 1].numpy(), [128, 129, 130, 131])


def test_blocktopm_wrapper_refuses_bad_m():
    head, scales, qhead, valid, _ = _case("int8", 1, 3, 200, 32, True)
    for m in (0, 129):
        with pytest.raises(ValueError, match="m must be"):
            thead.masked_head_blocktopm(*_t(head, scales, qhead, valid), m=m)


def _extract_case(seed):
    """osr_tpu's fused_search_extract case (tests/test_pallas_kernels.py:
    229-294) on exact-sum inputs: power-of-two scales, integer weights."""
    rng = np.random.RandomState(seed)
    r, f, b, k, q = 6144, 256, 8, 20, 8
    head = rng.randint(-127, 128, (r, f)).astype(np.int8)
    scales = (2.0 ** -rng.randint(6, 9, f)).astype(np.float32)
    valid = np.ones(r, dtype=bool)
    ids = np.stack(
        [rng.choice(f, size=q, replace=False) for _ in range(b)]
    ).astype(np.int32)
    w = rng.randint(1, 4, (b, q)).astype(np.float32)
    return head, scales, valid, ids, w, f, k


def _jax_extract(jnp, jbm25, head, scales, valid, ids, w, f, k):
    out = np.asarray(
        jbm25.fused_search_extract(
            jnp.asarray(jbm25.pack_query_batch(ids, w)), jnp.asarray(head),
            jnp.asarray(scales), jnp.asarray(valid), head_terms=f, k=k,
            narrow_m=8, interpret=True,
        )
    )
    kk = (out.shape[1] - 1) // 2
    return out[:, :kk], out[:, kk:-1].astype(np.int32), out[:, -1]


def test_fused_search_extract_matches_osr_tpu(jax_ref):
    jnp, jbm25, _ = jax_ref
    head, scales, valid, ids, w, f, k = _extract_case(11)
    want_top, want_rows, want_flag = _jax_extract(
        jnp, jbm25, head, scales, valid, ids, w, f, k
    )
    top, rows, unsafe = tbm25.fused_search_extract(
        *_t(ids, w, head, scales, valid), head_terms=f, k=k, narrow_m=8,
        head_backend="torch",
    )
    assert (want_flag == 0.0).all() and not bool(unsafe)
    assert unsafe.dim() == 0 and unsafe.dtype == torch.bool
    np.testing.assert_array_equal(top.numpy(), want_top)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    # ... and equal to the standard step's full-width selection.
    ftop, frows, _ = tbm25.fused_search(
        *_t(ids, w), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), *_t(head, scales, valid),
        head_terms=f, k=k, head_backend="torch",
    )
    np.testing.assert_array_equal(top.numpy(), ftop.numpy())
    np.testing.assert_array_equal(rows.numpy(), frows.numpy())


def test_fused_search_extract_flag_fires_on_clustered_head(jax_ref):
    """More than m of the top-k share one 128-row block: both flags fire."""
    jnp, jbm25, _ = jax_ref
    head, scales, valid, ids, w, f, k = _extract_case(11)
    head[256 : 256 + 30] = 127  # 30 equal, very strong rows in one block
    _, _, want_flag = _jax_extract(
        jnp, jbm25, head, scales, valid, ids, w, f, k
    )
    _, _, unsafe = tbm25.fused_search_extract(
        *_t(ids, w, head, scales, valid), head_terms=f, k=k, narrow_m=8,
        head_backend="torch",
    )
    assert (want_flag == 1.0).all()
    assert bool(unsafe)


def test_fused_search_extract_refuses_unknown_backend():
    head, scales, valid, ids, w, f, k = _extract_case(2)
    with pytest.raises(ValueError, match="head_backend"):
        tbm25.fused_search_extract(
            *_t(ids, w, head, scales, valid), head_terms=f, k=k,
            head_backend="pallas",
        )


# ----------------------------------------------------------------------
# K4 on the card
# ----------------------------------------------------------------------

CARD_CASES = [
    # (dtype, B, R, F, m, exact_sum, head width: int8 bytes, int4 packed)
    ("int8", 9, 700, 160, 1, True, None),
    ("int8", 9, 700, 160, 4, True, None),
    ("int8", 9, 700, 160, 8, True, None),
    ("int8", 9, 700, 160, 16, True, None),
    ("int4", 9, 700, 160, 1, True, 128),
    ("int4", 9, 700, 160, 4, True, 128),
    ("int4", 9, 700, 160, 16, True, 128),
    ("int8", 257, 1031, 160, 8, False, None),
    ("int4", 257, 1031, 160, 8, False, 128),
    # The int8 kernel's TMA ring takes 128 head bytes a stage: widths
    # below, at and off a stage, B and R off the 128 tiles.
    ("int8", 1, 1, 16, 1, True, 16),
    ("int8", 64, 127, 10, 8, True, 16),
    ("int8", 130, 129, 48, 4, True, 48),
    ("int8", 257, 1031, 37, 8, False, 48),
    ("int8", 1, 129, 64, 16, True, 64),
    ("int8", 64, 1031, 100, 8, True, 112),
    ("int8", 257, 127, 112, 8, True, 112),
    ("int8", 130, 1, 128, 1, False, 128),
    ("int8", 64, 129, 97, 8, True, 128),
    ("int8", 257, 1031, 144, 16, False, 144),
    ("int8", 1, 1031, 2048, 8, True, 2048),
    ("int8", 130, 127, 1500, 8, False, 2048),
    # The int4 kernel's TMA ring takes 64 packed bytes a stage: packed
    # widths below, at and off a stage, B and R off the 128 tiles.
    ("int4", 1, 1, 32, 1, True, 16),
    ("int4", 64, 127, 20, 8, True, 16),
    ("int4", 130, 129, 96, 4, True, 48),
    ("int4", 257, 1031, 77, 8, False, 48),
    ("int4", 1, 129, 128, 16, True, 64),
    ("int4", 64, 1031, 100, 8, True, 64),
    ("int4", 257, 127, 160, 8, True, 80),
    ("int4", 130, 1, 97, 1, False, 80),
    ("int4", 64, 129, 192, 8, True, 96),
    ("int4", 257, 1031, 150, 16, False, 96),
    ("int4", 1, 1031, 2048, 8, True, 1024),
    ("int4", 130, 127, 1500, 8, False, 1024),
]


def _invalidate_last_block(valid):
    """Every other row of the last 128-row block invalid, from its second
    row on."""
    valid[(len(valid) - 1) // 128 * 128 + 1 :: 2] = False
    return valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,r,f,m,exact_sum,fp", CARD_CASES)
def test_blocktopm_kernel_matches_plain_on_card(cuda, dtype, b, r, f, m,
                                                exact_sum, fp):
    head, scales, qhead, valid, codes = _case(
        dtype, 7, b, r, f, exact_sum, fp=fp
    )
    valid = _invalidate_last_block(valid)
    args = _t(head, scales, qhead, valid, device=cuda)
    name = f"head_blocktopm_{'i4' if dtype == 'int4' else 'i8'}"
    before = thead.LAUNCHES[name]
    got_v, got_r = thead.masked_head_blocktopm(*args, m=m)
    want_v, want_r = thead.masked_head_blocktopm_plain(*args, m)
    torch.cuda.synchronize()
    assert thead.LAUNCHES[name] == before + 1
    got_v, got_r = got_v.cpu().numpy(), got_r.cpu().numpy()
    want_v, want_r = want_v.cpu().numpy(), want_r.cpu().numpy()
    finite = np.isfinite(want_v)
    np.testing.assert_array_equal(np.isfinite(got_v), finite)
    if exact_sum:
        np.testing.assert_array_equal(got_v, want_v)
        np.testing.assert_array_equal(got_r[finite], want_r[finite])
    else:
        tol = _bound(scales, qhead, codes).max()
        assert np.all(np.abs(got_v[finite] - want_v[finite]) <= tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,b,r,f,fp",
    [
        ("int8", 300, 4000, 160, None),
        ("int8", 1, 1, 10, 16),
        ("int8", 130, 129, 48, 48),
        ("int8", 257, 1031, 64, 64),
        ("int8", 64, 127, 100, 112),
        ("int8", 257, 1031, 144, 144),
        ("int8", 130, 4000, 2048, 2048),
        ("int4", 300, 4000, 160, 128),
        ("int4", 1, 1, 20, 16),
        ("int4", 130, 129, 96, 48),
        ("int4", 257, 1031, 128, 64),
        ("int4", 64, 127, 150, 80),
        ("int4", 257, 1031, 192, 96),
        ("int4", 130, 4000, 2048, 1024),
    ],
)
def test_blocktopm_kernel_is_topm_of_blockmax_kernel(cuda, dtype, b, r, f,
                                                     fp):
    """K4 and K2/K3 share their main loop: K4's values and rows are the
    stable per-block top-m of K2's (K3's) own scores, bit for bit."""
    head, scales, qhead, valid, _ = _case(dtype, 3, b, r, f, False, fp=fp)
    valid = _invalidate_last_block(valid)
    args = _t(head, scales, qhead, valid, device=cuda)
    scores, _ = thead.masked_head_scores_blockmax(*args)
    got_v, got_r = thead.masked_head_blocktopm(*args, m=8)
    want_v, want_r = ttopk.block_topm(scores, 8)
    torch.cuda.synchronize()
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_r, want_r)


@pytest.mark.cuda
def test_blocktopm_kernel_refuses_m_over_limit(cuda):
    head, scales, qhead, valid, _ = _case("int8", 1, 3, 200, 32, True)
    args = _t(head, scales, qhead, valid, device=cuda)
    with pytest.raises(ValueError, match=str(thead.BLOCKTOPM_MAX_M)):
        thead.masked_head_blocktopm(*args, m=thead.BLOCKTOPM_MAX_M + 1)
