"""Head scoring in the PyTorch port (osr_tpu_torch/ops/head.py, ops/bm25.py)
against osr_tpu's Pallas head kernels (interpret mode on the CPU, as
tests/test_pallas_kernels.py runs them) and the XLA head scores.

Tolerance, per score entry: 4 * F * 2^-24 * sum_j |q_j * w_ij|, the f32
accumulation-order term of the host merge's slack
(osr_tpu/index/postings.py:merge_tau_slack). Both sides use the same
bf16-rounded scaled queries and exact codes, so their products are
identical and only the order of the f32 sums differs. Masked entries must
be exactly -inf, and block maxima must equal the per-block maxima of the
port's own scores exactly.

Tests marked ``cuda`` run the hand-written kernels against their plain
versions and skip without a card. On the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_head.py`` (the
repository's conftest imports JAX, which the card's machine lacks).
"""

import numpy as np
import pytest
import torch

from osr_tpu_torch.ops import bm25 as tbm25
from osr_tpu_torch.ops import head as thead


@pytest.fixture
def jax_ref():
    """osr_tpu's head modules (JAX on the CPU); absent on the card's
    machine, where only the kernel tests run."""
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


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16
    ).float().numpy()


def _int8_case(seed, b, r, f, width=None):
    """int8 head of ``width`` columns (f by default); columns f and up are
    zero, as the engine pads the head at upload."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(-127, 128, (r, f)).astype(np.int8)
    scales = ((rng.rand(f) + 0.1) / 127.0).astype(np.float32)
    qhead = rng.randint(0, 4, (b, f)).astype(np.float32)
    valid = rng.rand(r) > 0.1
    head = np.zeros((r, width or f), np.int8)
    head[:, :f] = codes
    return head, scales, qhead, valid, codes.astype(np.float64)


def _int4_case(seed, b, r, f_packed, f):
    """Block-packed int4 head: low nibble of byte c is column c, high
    nibble column c + f_packed; signed scales; f <= 2 * f_packed."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 16, (r, 2 * f_packed)).astype(np.uint8)
    codes[:, f:] = 0
    head = (codes[:, :f_packed] | (codes[:, f_packed:] << 4)).astype(np.uint8)
    scales = ((rng.rand(f) - 0.3) / 15.0).astype(np.float32)
    qhead = rng.randint(0, 4, (b, f)).astype(np.float32)
    valid = rng.rand(r) > 0.1
    return head, scales, qhead, valid, codes[:, :f].astype(np.float64)


def _bound(scales, qhead, codes):
    q = _bf16(qhead * scales[None, :]).astype(np.float64)
    f = codes.shape[1]
    return 4 * f * 2.0**-24 * (np.abs(q) @ np.abs(codes).T)


def _assert_scores(got, want, bound, valid):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.all(got[:, ~valid] == -np.inf)
    assert np.all(want[:, ~valid] == -np.inf)
    err = np.abs(got[:, valid].astype(np.float64) - want[:, valid])
    assert np.all(err <= bound[:, valid]), float(
        (err - bound[:, valid]).max()
    )


def _own_block_max(scores):
    s = np.asarray(scores)
    pad = (-s.shape[1]) % 128
    s = np.pad(s, ((0, 0), (0, pad)), constant_values=-np.inf)
    return s.reshape(s.shape[0], -1, 128).max(axis=2)


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def test_masked_head_scores_matches_pallas_interpret(jax_ref):
    jnp, _, jhead = jax_ref
    head, scales, qhead, valid, codes = _int8_case(0, 17, 300, 160)
    want = jhead.masked_head_scores(
        jnp.asarray(head), jnp.asarray(scales), jnp.asarray(qhead),
        jnp.asarray(valid), interpret=True,
    )
    before = dict(thead.LAUNCHES)
    got = thead.masked_head_scores(*_t(head, scales, qhead, valid))
    assert thead.LAUNCHES == before  # the CPU path launches no kernel
    _assert_scores(got.numpy(), want, _bound(scales, qhead, codes), valid)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_masked_head_scores_blockmax_matches_pallas_interpret(
    jax_ref, dtype
):
    jnp, _, jhead = jax_ref
    if dtype == "int8":
        head, scales, qhead, valid, codes = _int8_case(3, 9, 700, 160)
    else:
        # The Pallas int4 kernel needs a 128-aligned packed width.
        head, scales, qhead, valid, codes = _int4_case(4, 9, 700, 128, 250)
    want_s, want_m = jhead.masked_head_scores_blockmax(
        jnp.asarray(head), jnp.asarray(scales), jnp.asarray(qhead),
        jnp.asarray(valid), interpret=True,
    )
    got_s, got_m = thead.masked_head_scores_blockmax(
        *_t(head, scales, qhead, valid)
    )
    bound = _bound(scales, qhead, codes)
    _assert_scores(got_s.numpy(), want_s, bound, valid)
    np.testing.assert_array_equal(got_m.numpy(), _own_block_max(got_s))
    assert got_m.shape == np.asarray(want_m).shape


def _bad_operands(case):
    head, scales, qhead, valid, _ = _int8_case(8, 4, 64, 32)
    args = dict(zip(("head", "head_scales", "qhead", "valid"),
                    _t(head, scales, qhead, valid)))
    if case == "head_dtype":
        args["head"] = args["head"].float()
    elif case == "head_strided":
        args["head"] = torch.zeros(32, 64, dtype=torch.int8).T
    elif case == "width":
        args["head"] = args["head"][:, :24].contiguous()
        args["head_scales"] = args["head_scales"][:24]
        args["qhead"] = args["qhead"][:, :24]
    elif case == "valid_dtype":
        args["valid"] = args["valid"].to(torch.uint8)
    elif case == "valid_len":
        args["valid"] = args["valid"][:-1]
    elif case == "qhead_dtype":
        args["qhead"] = args["qhead"].double()
    elif case == "scales_len":
        args["head_scales"] = args["head_scales"][:-1]
    elif case == "too_wide":
        args["qhead"] = torch.zeros(4, 48)
        args["head_scales"] = torch.ones(48)
    return args


@pytest.mark.parametrize(
    "case",
    ["head_dtype", "head_strided", "width", "valid_dtype", "valid_len",
     "qhead_dtype", "scales_len", "too_wide"],
)
def test_kernel_operand_checks_refuse(case):
    """What the kernel wrappers refuse before a launch (the checks are
    device-independent, so they run here on CPU tensors)."""
    thead._check_operands(**_bad_operands(None))  # the good case passes
    with pytest.raises(ValueError):
        thead._check_operands(**_bad_operands(case))


def test_masked_head_scores_refuses_int4():
    head, scales, qhead, valid, _ = _int4_case(1, 4, 64, 16, 32)
    with pytest.raises(ValueError, match="no int4 kernel"):
        thead.masked_head_scores(*_t(head, scales, qhead, valid))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_head_scores_float_modes_match_xla(jax_ref, dtype):
    """bf16/f32 heads run plain torch products on every device, as
    osr_tpu runs XLA there (no Pallas kernel exists for these modes)."""
    import ml_dtypes

    jnp, jbm25, _ = jax_ref
    rng = np.random.RandomState(7)
    r, f, b = 200, 96, 11
    w = (rng.randn(r, f) * 2.0).astype(np.float32)
    qhead = rng.randint(0, 4, (b, f)).astype(np.float32)
    if dtype == "bf16":
        jhead = jnp.asarray(w.astype(ml_dtypes.bfloat16))
        thead_t = torch.from_numpy(w).to(torch.bfloat16)
        wv = _bf16(w).astype(np.float64)
        rel = 4 * f * 2.0**-24
    else:
        jhead = jnp.asarray(w)
        thead_t = torch.from_numpy(w)
        wv = w.astype(np.float64)
        rel = 2.0**-22 + 4 * f * 2.0**-24  # f32 products round too
    want = np.asarray(jbm25.head_scores(jhead, None, jnp.asarray(qhead)))
    got = tbm25.head_scores(thead_t, None, torch.from_numpy(qhead)).numpy()
    bound = rel * (np.abs(qhead.astype(np.float64)) @ np.abs(wv).T)
    assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_head_scores_quantized_match_xla(jax_ref, dtype):
    jnp, jbm25, _ = jax_ref
    if dtype == "int8":
        head, scales, qhead, _, codes = _int8_case(11, 13, 260, 144)
    else:
        head, scales, qhead, _, codes = _int4_case(12, 13, 260, 80, 150)
    want = np.asarray(
        jbm25.head_scores(
            jnp.asarray(head), jnp.asarray(scales), jnp.asarray(qhead)
        )
    )
    got = tbm25.head_scores(*_t(head, scales, qhead)).numpy()
    bound = _bound(scales, qhead, codes)
    assert np.all(np.abs(got - want) <= bound)


def test_scatter_query_head_matches_jax(jax_ref):
    jnp, jbm25, _ = jax_ref
    rng = np.random.RandomState(2)
    b, q, f = 6, 8, 40
    ids = np.full((b, q), f, np.int32)  # padding id == head_terms
    w = np.zeros((b, q), np.float32)
    for i in range(b):
        n = rng.randint(0, q + 1)
        ids[i, :n] = np.sort(rng.choice(f + 10, n, replace=False))
        w[i, :n] = rng.randint(1, 5, n)
    want = np.asarray(
        jbm25.scatter_query_head(
            jnp.asarray(ids), jnp.asarray(w), head_terms=f
        )
    )
    got = tbm25.scatter_query_head(*_t(ids, w), head_terms=f).numpy()
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# Kernels on the card
# ----------------------------------------------------------------------

KERNEL_CASES = [
    # (kernel, B, R, packed/int8 width, logical F)
    ("head_scores_i8", 130, 300, 160, 160),
    ("head_blockmax_i8", 130, 300, 160, 160),
    ("head_blockmax_i4", 130, 300, 80, 150),
    ("head_scores_i8", 257, 1031, 2048, 2048),
    ("head_blockmax_i8", 257, 1031, 2048, 2048),
    ("head_blockmax_i4", 257, 1031, 1024, 2048),
    # The int8 kernel's TMA ring takes 128 head bytes a stage: widths
    # below, at and off a stage, B and R off the 128 tiles.
    ("head_blockmax_i8", 1, 1, 16, 16),
    ("head_blockmax_i8", 64, 127, 16, 10),
    ("head_blockmax_i8", 130, 129, 48, 48),
    ("head_blockmax_i8", 257, 1031, 48, 37),
    ("head_blockmax_i8", 1, 129, 64, 64),
    ("head_blockmax_i8", 64, 1031, 112, 100),
    ("head_blockmax_i8", 257, 127, 112, 112),
    ("head_blockmax_i8", 130, 1, 128, 128),
    ("head_blockmax_i8", 64, 129, 128, 97),
    ("head_blockmax_i8", 257, 1031, 144, 144),
    ("head_blockmax_i8", 1, 1031, 2048, 2048),
    ("head_blockmax_i8", 130, 127, 2048, 1500),
    # The int4 kernel's TMA ring takes 64 packed bytes a stage: packed
    # widths below, at and off a stage, B and R off the 128 tiles.
    ("head_blockmax_i4", 1, 1, 16, 32),
    ("head_blockmax_i4", 64, 127, 16, 20),
    ("head_blockmax_i4", 130, 129, 48, 96),
    ("head_blockmax_i4", 257, 1031, 48, 77),
    ("head_blockmax_i4", 1, 129, 64, 128),
    ("head_blockmax_i4", 64, 1031, 64, 100),
    ("head_blockmax_i4", 257, 127, 80, 160),
    ("head_blockmax_i4", 130, 1, 80, 97),
    ("head_blockmax_i4", 64, 129, 96, 192),
    ("head_blockmax_i4", 257, 1031, 96, 150),
    ("head_blockmax_i4", 1, 1031, 1024, 2048),
    ("head_blockmax_i4", 130, 127, 1024, 1500),
    # K1 shares the int8 kernel's ring: the same edges.
    ("head_scores_i8", 1, 1, 16, 16),
    ("head_scores_i8", 64, 127, 16, 10),
    ("head_scores_i8", 130, 129, 48, 48),
    ("head_scores_i8", 257, 1031, 48, 37),
    ("head_scores_i8", 1, 129, 64, 64),
    ("head_scores_i8", 64, 1031, 112, 100),
    ("head_scores_i8", 257, 127, 112, 112),
    ("head_scores_i8", 130, 1, 128, 128),
    ("head_scores_i8", 64, 129, 128, 97),
    ("head_scores_i8", 257, 1031, 144, 144),
    ("head_scores_i8", 1, 1031, 2048, 2048),
    ("head_scores_i8", 130, 127, 2048, 1500),
]


def _invalidate_last_block(valid):
    """Every other row of the last 128-row block invalid, from its second
    row on."""
    valid[(len(valid) - 1) // 128 * 128 + 1 :: 2] = False
    return valid


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,b,r,width,f", KERNEL_CASES)
def test_kernel_matches_plain_on_card(cuda, kernel, b, r, width, f):
    if kernel.endswith("i4"):
        head, scales, qhead, valid, codes = _int4_case(5, b, r, width, f)
    else:
        head, scales, qhead, valid, codes = _int8_case(5, b, r, f, width)
    valid = _invalidate_last_block(valid)
    args = _t(head, scales, qhead, valid, device=cuda)
    before = thead.LAUNCHES[kernel]
    if kernel == "head_scores_i8":
        got = thead.masked_head_scores(*args)
        want = thead.masked_head_scores_plain(*args)
    else:
        got, got_m = thead.masked_head_scores_blockmax(*args)
        want, _ = thead.masked_head_scores_blockmax_plain(*args)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(
            got_m.cpu().numpy(), _own_block_max(got.cpu())
        )
    torch.cuda.synchronize()
    assert thead.LAUNCHES[kernel] == before + 1
    _assert_scores(
        got.cpu().numpy(), want.cpu().numpy(),
        _bound(scales, qhead, codes), valid,
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,r,width,f",
    [(130, 300, 160, 160), (1, 129, 64, 64), (257, 1031, 48, 37),
     (130, 127, 2048, 1500), (257, 1031, 2048, 2048)],
)
def test_k1_scores_equal_k2_scores_on_card(cuda, b, r, width, f):
    """K1 is the scores-only epilogue of K2's kernel: on the same operands
    its (B, R) scores are K2's bit for bit."""
    head, scales, qhead, valid, _ = _int8_case(9, b, r, f, width)
    args = _t(head, scales, qhead, _invalidate_last_block(valid),
              device=cuda)
    got = thead.masked_head_scores(*args)
    want, _ = thead.masked_head_scores_blockmax(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_check_aligned_refuses_misaligned_view(dtype):
    """TMA takes 16-byte aligned bases: the wrappers raise on a head view
    that starts elsewhere, and do not copy it; a row-chunk view passes
    (device-independent, so it runs here on CPU tensors)."""
    if dtype == "int8":
        head, scales, qhead, valid, _ = _int8_case(1, 4, 5, 32)
    else:
        head, scales, qhead, valid, _ = _int4_case(1, 4, 5, 16, 32)
    head, scales, qhead, valid = _t(head, scales, qhead, valid)
    thead._check_operands(head[1:], scales, qhead, valid[1:])
    flat = torch.zeros(8 + head.numel(), dtype=head.dtype)
    shifted = flat[8:].view(head.shape)
    with pytest.raises(ValueError, match="multiple of 16"):
        thead._check_operands(shifted, scales, qhead, valid)


@pytest.mark.cuda
def test_head_libraries_refuse_bad_shapes(cuda):
    """The C entry points return cudaErrorInvalidValue (1) and launch
    nothing for a width off 16 bytes (K1, K2, K4-i8) or an m over
    kMaxM (K4-i8)."""
    from osr_tpu_torch.ops import _build

    head, scales, qhead, valid, _ = _int8_case(1, 4, 64, 32)
    head, scales, qhead, valid = _t(head, scales, qhead, valid, device=cuda)
    q = thead.i8_kernel_query(thead.scaled_query(qhead, scales, 32))
    out = torch.zeros(4, 64, device=cuda)
    bmax = torch.zeros(1, 4, device=cuda)
    rows = torch.zeros(4, 1, 17, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), head.data_ptr(), valid.data_ptr())
    wg = _build.library("head_wgmma")
    assert wg.osr_head_i8_scores(*ptrs, out.data_ptr(), 4, 64, 24, stream) == 1
    assert wg.osr_head_i8_blockmax(
        *ptrs, out.data_ptr(), bmax.data_ptr(), 4, 64, 24, stream
    ) == 1
    assert wg.osr_head_i8_blocktopm(
        *ptrs, out.data_ptr(), rows.data_ptr(), 4, 64, 32, 17, stream
    ) == 1
    torch.cuda.synchronize()
    assert torch.count_nonzero(out) == 0 and torch.count_nonzero(bmax) == 0
    assert torch.count_nonzero(rows) == 0


@pytest.mark.cuda
def test_kernel_wrapper_refuses_unaligned_width(cuda):
    head, scales, qhead, valid, _ = _int8_case(6, 4, 64, 40)
    with pytest.raises(ValueError, match="multiple of 16"):
        thead.masked_head_scores(*_t(head, scales, qhead, valid, device=cuda))


# ----------------------------------------------------------------------
# The int8 kernels' operand layout (csrc/head_wgmma.cu), emulated here
# ----------------------------------------------------------------------


def test_i8_stage_order_is_a_permutation():
    order = thead.i8_stage_order().numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(thead.I8_STAGE))
    # Lane t of a quad reads chunks 2 t and 2 t + 1 of a row: the k slots
    # that wgmma's A fragment gives it (2 t, 2 t + 1, 2 t + 8, 2 t + 9 of
    # each k-step) hold exactly those 32 columns.
    for t in range(4):
        slots = [16 * kk + s for kk in range(8)
                 for s in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
        assert sorted(order[slots]) == list(range(32 * t, 32 * t + 32))


@pytest.mark.parametrize("width", [16, 48, 128, 144, 2048])
def test_i8_kernel_query_matches_fragment_reads(width):
    """Emulates the int8 kernel's register decode: lane t loads 16-byte
    chunks 2 t + G of each head row in a stage of 128 bytes, word j of a
    chunk is k-step 4 G + j and byte i the A slot 2 t + (i & 1) + 8 (i >>
    1). Dotting those operands with i8_kernel_query's columns gives the
    plain dots exactly (integer inputs: every sum is exact)."""
    rng = np.random.RandomState(width)
    b, r = 5, 7
    head = rng.randint(-128, 128, (r, width)).astype(np.int8)
    q = rng.randint(-8, 9, (b, width)).astype(np.float32)
    qk = thead.i8_kernel_query(torch.from_numpy(q).to(torch.bfloat16))
    stages = -(-width // thead.I8_STAGE)
    assert qk.shape == (b, stages * thead.I8_STAGE)
    padded = np.zeros((r, stages * 128), np.int8)
    padded[:, :width] = head  # TMA's zero fill past the head's width
    a = np.zeros((r, stages * 128), np.float64)
    for s in range(stages):
        for t in range(4):
            for g in range(2):
                chunk = padded[:, 128 * s + 16 * (2 * t + g) :][:, :16]
                for j in range(4):
                    for i in range(4):
                        slot = 2 * t + (i & 1) + 8 * (i >> 1)
                        k = 128 * s + 16 * (4 * g + j) + slot
                        a[:, k] = chunk[:, 4 * j + i]
    got = qk.double().numpy() @ a.T
    want = q.astype(np.float64) @ head.astype(np.float64).T
    np.testing.assert_array_equal(got, want)


def test_i8_decode_is_exact_for_every_byte():
    """The int8 kernel's decode: bf16 (0x4300 | (b & 0x7f)) minus bf16
    (0x4300 | (b & 0x80)) is the signed code of byte b, for all 256."""
    b = np.arange(256, dtype=np.int32)
    bits = lambda x: torch.from_numpy(x.astype(np.int16)).view(torch.bfloat16)
    got = bits(0x4300 | (b & 0x7F)) - bits(0x4300 | (b & 0x80))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), b.astype(np.uint8).view(np.int8)
    )
