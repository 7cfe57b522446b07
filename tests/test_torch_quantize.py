"""Quantization and quantized similarity in the PyTorch port
(osr_tpu_torch/ops/quantize.py, quantize_kernels.py, matmul.py) against
osr_tpu's XLA ops and its Pallas kernels, run in interpret mode on the CPU
as tests/test_pallas_kernels.py runs them.

Tolerances:
- codes (int8, packed int4, uint8) must be equal;
- scales equal: osr_tpu's XLA lowers ``/ 127`` (``/ 7``, ``/ 255``) as a
  multiply by the f32 reciprocal, and so does the port (K7's plain
  version and the plain quantizers alike); codes divide by the scale
  tensor on both sides, so they stay equal on rounding half steps too;
- dequantized values equal; similarities within rtol 1e-6 (the integer
  sums are exact on both sides, the rescale's f32 products may round in
  another order);
- float32 products (fp_search, grouped int4) within the f32 summation-order
  bound 2 D 2^-24 sum_c |q_c d_c|: both sides round the same operands, only
  the order of the sums differs.

Tests marked ``cuda`` hold the hand-written kernels to their plain
versions on the card, where the error must be 0, and skip without one.
On the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_quantize.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from osr_tpu_torch.index.dense import (
    synthetic_corpus_embeddings,
    synthetic_query_embedding,
)
from osr_tpu_torch.ops import matmul as tmm
from osr_tpu_torch.ops import quantize as tqz
from osr_tpu_torch.ops import quantize_kernels as tqk

RTOL = 1e-6


@pytest.fixture
def jax_ref():
    """osr_tpu's quantize modules (JAX on the CPU); absent on the card's
    machine, where only the kernel tests run."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from osr_tpu.ops import quantize as jqz
    from osr_tpu.ops.pallas import matmul as jpmm
    from osr_tpu.ops.pallas import quantize as jpqz

    return jnp, jqz, jpmm, jpqz


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def embeddings():
    return synthetic_corpus_embeddings(500, dim=128, seed=42)


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


def _f32_bound(q, d):
    """2 D 2^-24 sum_c |q_c d_c| for (B, D) x (N, D) f32 operands."""
    q, d = np.asarray(q, np.float64), np.asarray(d, np.float64)
    return 2 * q.shape[1] * 2.0**-24 * (np.abs(q) @ np.abs(d).T)


# ----------------------------------------------------------------------
# Quantizers against osr_tpu
# ----------------------------------------------------------------------


QUANTIZERS = {
    "symmetric": "quantize_symmetric",
    "int4": "quantize_symmetric_int4",
    "int4_grouped": "quantize_symmetric_int4_grouped",
    "asymmetric": "quantize_asymmetric",
}


@pytest.mark.parametrize("name", sorted(QUANTIZERS))
@pytest.mark.parametrize("shape", [(500, 128), (37, 776), (4, 256)])
def test_quantizers_match_osr_tpu(jax_ref, name, shape):
    jnp, jqz, _, _ = jax_ref
    rng = np.random.RandomState(shape[1])
    x = (rng.randn(*shape) * rng.rand(shape[0], 1) * 3).astype(np.float32)
    if name == "int4_grouped" and shape[1] % 128:
        x = x[:, :640]  # whole 128-column groups
    fn = QUANTIZERS[name]
    want = getattr(jqz, fn)(jnp.asarray(x))
    got = getattr(tqz, fn)(torch.from_numpy(x))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == (torch.int8 if name == "symmetric" else torch.uint8)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize(
    "name",
    ["quantize_symmetric_np", "quantize_symmetric_int4_np",
     "quantize_symmetric_int4_grouped_np"],
)
def test_numpy_twins_identical_to_osr_tpu(jax_ref, embeddings, name):
    _, jqz, _, _ = jax_ref
    x = np.concatenate([embeddings, embeddings], axis=1)  # D = 256
    for g, w in zip(getattr(tqz, name)(x), getattr(jqz, name)(x)):
        np.testing.assert_array_equal(g, w)


def test_symmetric_roundtrip(embeddings):
    values, scales = tqz.quantize_symmetric(torch.from_numpy(embeddings))
    recon = tqz.dequantize_symmetric(values, scales).numpy()
    max_step = (np.abs(embeddings).max(axis=1) / 127.0).max()
    assert np.abs(recon - embeddings).mean() < max_step
    assert values.dtype == torch.int8 and values.abs().max() <= 127


def test_asymmetric_roundtrip(embeddings):
    values, scales, mins = tqz.quantize_asymmetric(torch.from_numpy(embeddings))
    recon = tqz.dequantize_asymmetric(values, scales, mins).numpy()
    assert values.dtype == torch.uint8
    assert np.abs(recon - embeddings).max() <= scales.max().item()


def test_int4_roundtrip(embeddings):
    packed, scales = tqz.quantize_symmetric_int4(torch.from_numpy(embeddings))
    assert packed.dtype == torch.uint8 and packed.shape == (500, 64)
    codes = tqz.unpack_int4_signed(packed)
    assert codes.dtype == torch.int8
    assert codes.min() >= -7 and codes.max() <= 7
    recon = codes.float().numpy() * scales.numpy()[:, None]
    max_step = (np.abs(embeddings).max(axis=1) / 7.0).max()
    assert np.abs(recon - embeddings).mean() < max_step / 2 + 1e-6


def _outlier_embeddings(n=256, d=256, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32) * 0.05
    x[np.arange(n), rng.randint(0, d, size=n)] += rng.choice(
        [-3.0, 3.0], size=n
    )
    return x


def test_int4_grouped_reconstruction_beats_per_row():
    """One outlier per row: group scales bound its reach, and finer groups
    bound it tighter."""
    x = _outlier_embeddings()
    n, d = x.shape

    def recon(group_size):
        if group_size is None:
            p, s = tqz.quantize_symmetric_int4(torch.from_numpy(x))
            return tqz.unpack_int4_signed(p).float().numpy() * s.numpy()[:, None]
        p, s = tqz.quantize_symmetric_int4_grouped(
            torch.from_numpy(x), group_size=group_size
        )
        codes = tqz.unpack_int4_signed(p).float().numpy()
        g = d // group_size
        return (codes.reshape(n, g, group_size)
                * s.numpy()[:, :, None]).reshape(n, d)

    err = {g: np.abs(recon(g) - x).mean() for g in (None, 128, 64)}
    assert err[128] < 0.7 * err[None]
    assert err[64] < err[128]
    # One group as wide as the row is the per-row quantizer.
    p1, s1 = tqz.quantize_symmetric_int4(torch.from_numpy(x[:, :128]))
    pg, sg = tqz.quantize_symmetric_int4_grouped(torch.from_numpy(x[:, :128]))
    assert torch.equal(p1, pg) and torch.equal(s1, sg[:, 0])


def test_quantized_search_keeps_fp32_ranking(embeddings):
    """int8 and asymmetric uint8 search keep most of f32 search's top 10
    (the reference's ~0.93 bar) and approximate its scores."""
    rng = np.random.RandomState(3)
    queries = torch.from_numpy(
        embeddings[:32] + 0.02 * rng.randn(32, 128).astype(np.float32)
    )
    docs = torch.from_numpy(embeddings)
    sf, i_f = tqz.fp_search(queries, docs, k=10)
    d8, ds = tqz.quantize_symmetric(docs)
    _, i8 = tqz.int8_search_symmetric(queries, d8, ds, k=10)
    sa, ia = tqz.int8_search_asymmetric(
        queries, *tqz.quantize_asymmetric(docs), k=10
    )
    for ids in (i8, ia):
        overlap = [len(set(ids[b].tolist()) & set(i_f[b].tolist())) / 10
                   for b in range(32)]
        assert np.mean(overlap) >= 0.9
    np.testing.assert_allclose(sa.numpy(), sf.numpy(), atol=0.05)


def test_int4_pack_layout(jax_ref):
    """Block packing: byte c's low nibble is column c, its high nibble
    column c + D/2, two's complement."""
    jnp, jqz, _, _ = jax_ref
    x = np.array([[0.7, -0.3, 0.1, -0.7]], dtype=np.float32)  # scale 0.1
    packed, scales = tqz.quantize_symmetric_int4(torch.from_numpy(x))
    p = packed.numpy()[0]
    np.testing.assert_allclose(scales.numpy(), [0.1], rtol=1e-5)
    assert p[0] == (7 | (1 << 4))
    assert p[1] == (13 | (9 << 4))
    codes = tqz.unpack_int4_signed(packed).numpy()[0]
    np.testing.assert_array_equal(codes, [7, -3, 1, -7])
    all_bytes = np.arange(256, dtype=np.uint8).reshape(8, 32)
    np.testing.assert_array_equal(
        tqz.unpack_int4_signed(torch.from_numpy(all_bytes)).numpy(),
        np.asarray(jqz.unpack_int4_signed(jnp.asarray(all_bytes))),
    )


def test_int4_odd_dim_raises():
    with pytest.raises(ValueError):
        tqz.quantize_symmetric_int4(torch.ones(4, 5))
    with pytest.raises(ValueError):
        tqz.quantize_symmetric_int4_grouped(torch.ones(4, 192))


def test_synthetic_embeddings_identical_to_osr_tpu(jax_ref):
    from osr_tpu.index import dense as jdense

    np.testing.assert_array_equal(
        synthetic_corpus_embeddings(300, dim=48, seed=12),
        jdense.synthetic_corpus_embeddings(300, dim=48, seed=12),
    )
    texts = ["what is an ETF", "bonds", ""]
    from osr_tpu_torch.index.dense import synthetic_query_embeddings

    np.testing.assert_array_equal(
        synthetic_query_embeddings(texts, 64),
        jdense.synthetic_query_embeddings(texts, 64),
    )
    a = synthetic_query_embedding("what is an ETF", 64)
    np.testing.assert_allclose(np.linalg.norm(a), 1.0, rtol=1e-5)


# ----------------------------------------------------------------------
# Plain K5-K8 against the interpreted Pallas kernels
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(256, 128), (200, 776)])
def test_plain_quantize_matches_pallas_interpret(jax_ref, n, d):
    """K7's plain version against quantize_symmetric_pallas and K8's
    against dequantize_symmetric_pallas."""
    jnp, _, _, jpqz = jax_ref
    x = synthetic_corpus_embeddings(n, dim=d, seed=n)
    v_p, s_p = jpqz.quantize_symmetric_pallas(jnp.asarray(x), interpret=True)
    before = dict(tqk.LAUNCHES)
    v_t, s_t = tqk.quantize_symmetric(torch.from_numpy(x))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_p))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_p))
    recon_p = jpqz.dequantize_symmetric_pallas(v_p, s_p, interpret=True)
    recon_t = tqk.dequantize_symmetric(v_t, s_t)
    np.testing.assert_array_equal(recon_t.numpy(), np.asarray(recon_p))
    assert tqk.LAUNCHES == before  # the CPU path launches no kernel


def test_plain_quantize_matches_osr_tpu_on_half_steps(jax_ref):
    """K7's plain version against osr_tpu's XLA quantizer and its Pallas
    kernel on rows built to land on rounding half steps (a value at half
    of its row's maximum, and odd multiples of half a step), where a scale
    one ulp away would round the code the other way."""
    jnp, jqz, _, jpqz = jax_ref
    rng = np.random.RandomState(11)
    n = 4096
    x = (rng.randn(n, 96) * rng.rand(n, 1) * 3).astype(np.float32)
    absmax = np.abs(x).max(axis=1)
    x[:, 5] = absmax / 2
    x[:, 7] = -absmax * ((np.arange(n) % 127 + 0.5) / 127).astype(np.float32)
    v_t, s_t = (t.numpy() for t in tqk.quantize_symmetric(torch.from_numpy(x)))
    v_x, s_x = (np.asarray(a) for a in jqz.quantize_symmetric(jnp.asarray(x)))
    v_p, s_p = (
        np.asarray(a)
        for a in jpqz.quantize_symmetric_pallas(jnp.asarray(x), interpret=True)
    )
    ieee = np.maximum(absmax, np.float32(1e-8)) / np.float32(127)
    assert np.any(ieee != s_x)  # the inputs tell the two scales apart
    for v, s in ((v_x, s_x), (v_p, s_p)):
        np.testing.assert_array_equal(s_t, s)
        np.testing.assert_array_equal(v_t, v)


@pytest.mark.parametrize("b,n,d", [(128, 256, 128), (37, 300, 200)])
def test_plain_int8_similarity_matches_pallas_interpret(jax_ref, b, n, d):
    """K5's plain version against int8_similarity_pallas, which loads the
    whole width D a tile: B off the 128 tile and D off 16 bytes too."""
    jnp, jqz, jpmm, _ = jax_ref
    queries = synthetic_corpus_embeddings(b, dim=d, seed=9)
    docs = synthetic_corpus_embeddings(n, dim=d, seed=42)
    q8, qs = jqz.quantize_symmetric(jnp.asarray(queries))
    d8, ds = jqz.quantize_symmetric(jnp.asarray(docs))
    want = jpmm.int8_similarity_pallas(q8, d8, qs, ds, interpret=True)
    before = dict(tmm.LAUNCHES)
    got = tmm.int8_similarity(
        *_t(np.asarray(q8), np.asarray(d8), np.asarray(qs), np.asarray(ds))
    )
    assert tmm.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("n,b,d", [(256, 128, 256), (384, 37, 512)])
def test_plain_int4_similarity_matches_pallas_interpret(jax_ref, n, b, d):
    """K6's plain version against int4_similarity_pallas (whose packed
    width must be a multiple of 128), B off the 128 tile too."""
    jnp, jqz, jpmm, _ = jax_ref
    rng = np.random.default_rng(7)
    docs = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    packed, ds = jqz.quantize_symmetric_int4(jnp.asarray(docs))
    q8, qs = jqz.quantize_symmetric(jnp.asarray(queries))
    want = jpmm.int4_similarity_pallas(q8, packed, qs, ds, interpret=True)
    got = tmm.int4_similarity(
        *_t(np.asarray(q8), np.asarray(packed), np.asarray(qs), np.asarray(ds))
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


# ----------------------------------------------------------------------
# K5's and K6's operands and K6's decode (csrc/similarity_wgmma.cu),
# emulated here
# ----------------------------------------------------------------------

K5_STAGE = 128  # bytes of a row a K5 stage loads (Geometry<false>::kChunkBytes)


def _k5_emulated(q8, d8, qs, ds):
    """csrc/similarity_wgmma.cu's K5 on int8_kernel_operands's operands:
    stage k takes columns [128 k, 128 k + 128) of the queries and of the
    corpus, each zero past its operand's width (TMA's fill), in four
    32-column k-steps; the sums are exact; then (float(acc) * qs) * ds in
    f32."""
    q, d, dp = tmm.int8_kernel_operands(q8, d8)
    assert dp % tmm.TMA_ALIGN == 0 and q.shape[1] == d.shape[1] == dp
    assert q.data_ptr() % tmm.TMA_ALIGN == 0
    assert d.data_ptr() % tmm.TMA_ALIGN == 0
    width = K5_STAGE * -(-dp // K5_STAGE)
    qz = np.zeros((q.shape[0], width), np.int64)
    qz[:, :dp] = q.numpy()
    dz = np.zeros((d.shape[0], width), np.int64)
    dz[:, :dp] = d.numpy()
    acc = np.zeros((q.shape[0], d.shape[0]), np.int64)
    for c in range(0, width, 32):
        acc += qz[:, c : c + 32] @ dz[:, c : c + 32].T
    out = acc.astype(np.float32) * qs.numpy()[:, None]
    return out * ds.numpy()[None, :]


@pytest.mark.parametrize("offset", [0, 8])
@pytest.mark.parametrize("d", [16, 24, 32, 100, 128, 200, 768, 776])
def test_k5_operands_give_plain_result(d, offset):
    """The padded operands, read box by box as the kernel reads them, give
    int8_similarity_plain's exact result; a copy of each operand is made
    (and counted) exactly where D is off 16 bytes or its base is."""
    rng = np.random.RandomState(d + offset)
    b, n = 5, 7
    q8, docs = _t(
        rng.randint(-128, 128, (b, d)).astype(np.int8),
        rng.randint(-128, 128, (n, d)).astype(np.int8),
    )
    if offset:  # views whose bases sit `offset` bytes past an allocation
        q8 = torch.cat([torch.zeros(offset, dtype=torch.int8),
                        q8.flatten()])[offset:].view(b, d)
        docs = torch.cat([torch.zeros(offset, dtype=torch.int8),
                          docs.flatten()])[offset:].view(n, d)
        assert q8.data_ptr() % tmm.TMA_ALIGN != 0
    qs, ds = _t((rng.rand(b) / 127).astype(np.float32),
                (rng.rand(n) / 7).astype(np.float32))
    before = dict(tmm.PAD_COPIES)
    got = _k5_emulated(q8, docs, qs, ds)
    copied = int(d % tmm.TMA_ALIGN != 0 or offset != 0)
    assert tmm.PAD_COPIES == {k: v + copied for k, v in before.items()}
    want = tmm.int8_similarity_plain(q8, docs, qs, ds).numpy()
    np.testing.assert_array_equal(got, want)


def test_k5_operands_are_the_inputs_when_aligned():
    q8 = torch.zeros(3, 48, dtype=torch.int8)
    docs = torch.zeros(4, 48, dtype=torch.int8)
    q, d, dp = tmm.int8_kernel_operands(q8, docs)
    assert dp == 48 and q is q8 and d is docs


# ----------------------------------------------------------------------
# K5's and K6's block maxima (csrc/similarity_wgmma.cu: stage_tile, fold,
# max_slot, ordered), emulated here
# ----------------------------------------------------------------------


def _ordered(bits):
    """csrc ``ordered``: int32 keys whose signed order is the floats'."""
    bits = np.asarray(bits, np.int32)
    return np.where(bits >= 0, bits, bits ^ np.int32(0x7FFFFFFF))


def _max_slot(q):
    return q ^ ((q >> 5) & 1) ^ (((q >> 6) & 1) << 3)


def _tile_maxima_emulated(tile, live_docs):
    """One (128 queries x 128 docs) f32 tile's per-query maxima over docs
    [0, live_docs), as the epilogue reduces them: thread (warp 4 wg + w,
    lane 4 g + t) takes the larger of docs row0 and row0 + 8 (row0 = 64
    wg + 16 w + g; a doc >= live_docs is -inf) for queries 8 j + 2 t + e
    (entry 2 j + e), three fold rounds of lanes 16, 8, 4 apart, then
    atomicMax of its 4 keys into the swizzled slots. Returns the maxima
    and, per warp and atomic round, the shared-memory banks of the 32
    lanes' slots."""
    slots = np.full(128, _ordered(np.float32(-np.inf).view(np.int32)))
    banks = []
    for warp in range(8):
        wg, w = divmod(warp, 4)
        m = np.empty((32, 32), np.float32)  # (lane, entry)
        for lane in range(32):
            g, t = divmod(lane, 4)
            row0 = 64 * wg + 16 * w + g
            for p in range(32):
                q = 8 * (p >> 1) + 2 * t + (p & 1)
                v = [tile[q, d] if d < live_docs else -np.inf
                     for d in (row0, row0 + 8)]
                m[lane, p] = np.maximum(np.float32(v[0]), np.float32(v[1]))
        for half in (16, 8, 4):
            send = np.empty((32, half), np.float32)
            keep = np.empty((32, half), np.float32)
            for lane in range(32):
                lo, hi = m[lane, :half], m[lane, half : 2 * half]
                up = bool(lane & half)
                send[lane], keep[lane] = (lo, hi) if up else (hi, lo)
            for lane in range(32):
                m[lane, :half] = np.maximum(keep[lane], send[lane ^ half])
        for i in range(4):
            qs = [16 * (lane >> 2) + 8 * (i >> 1) + 2 * (lane & 3) + (i & 1)
                  for lane in range(32)]
            banks.append([_max_slot(q) % 32 for q in qs])
            for lane, q in enumerate(qs):
                key = _ordered(m[lane, i].view(np.int32))
                slots[_max_slot(q)] = max(slots[_max_slot(q)], key)
    out = np.array([_ordered(slots[_max_slot(q)]) for q in range(128)],
                   np.int32).view(np.float32)
    return out, banks


@pytest.mark.parametrize("live_docs", [128, 124, 1])
@pytest.mark.parametrize("sign", [1, -1])
def test_k5_block_maxima_reduction_emulated(live_docs, sign):
    """The epilogue's reduction gives each query's maximum over the tile's
    real docs bit for bit (a ragged block's docs past N count as -inf, not
    as the 0 the kernel computes there), each round of a warp's atomics
    hitting 32 banks."""
    rng = np.random.RandomState(live_docs)
    tile = sign * rng.rand(128, 128).astype(np.float32)
    tile[:, live_docs:] = 0.0  # what zero fill and the zero scale give
    tile[5, 3] = tile[5, 4] = tile[5].max() + 1  # a planted tie
    want = tile[:, :live_docs].max(axis=1)
    got, banks = _tile_maxima_emulated(tile, live_docs)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert all(len(set(b)) == 32 for b in banks)


def test_k5_block_maxima_keys_and_slots():
    """``ordered`` keeps the floats' order (NaN, the canonical one max.NaN
    gives, above +inf) and is its own inverse; ``max_slot`` is a
    permutation whose 32 slots of a warp's queries hit 32 banks."""
    vals = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf,
                     np.nan], np.float32)
    vals[-1] = np.int32(0x7FFFFFFF).view(np.float32)
    keys = _ordered(vals.view(np.int32))
    assert (np.diff(keys.astype(np.int64)) > 0).all()
    np.testing.assert_array_equal(_ordered(keys), vals.view(np.int32))
    q = np.arange(128)
    assert sorted(_max_slot(q)) == list(q)
    for w in range(4):
        assert len(set(_max_slot(q[32 * w : 32 * w + 32]) % 32)) == 32


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("b,n,d", [(37, 1_000, 64), (5, 128, 32), (3, 7, 16)])
def test_similarity_blockmax_plain_twins(int4, b, n, d):
    """On CPU tensors the blockmax wrappers return the plain scores and
    ``topk.block_max`` of them, and launch (count) nothing."""
    from osr_tpu_torch.ops.topk import block_max

    rng = np.random.RandomState(b + n)
    q8 = _codes(rng, (b, d), False)
    docs = _codes(rng, (n, d // 2 if int4 else d), int4)
    args = _t(q8, docs, (rng.rand(b) / 127).astype(np.float32),
              (rng.rand(n) / 7).astype(np.float32))
    before = dict(tmm.LAUNCHES)
    fn = tmm.int4_similarity_blockmax if int4 else tmm.int8_similarity_blockmax
    scores, maxima = fn(*args)
    plain = tmm.int4_similarity_plain if int4 else tmm.int8_similarity_plain
    want = plain(*args)
    assert tmm.LAUNCHES == before
    assert maxima.shape == (b, -(-n // 128))
    assert torch.equal(scores, want)
    assert torch.equal(maxima, block_max(want))


def test_reset_launches_clears_blockmax_counts():
    saved = dict(tmm.LAUNCHES)
    assert {"int8_similarity_blockmax", "int4_similarity_blockmax"} <= set(
        tmm.LAUNCHES)
    try:
        for name in tmm.LAUNCHES:
            tmm.LAUNCHES[name] = 3
        tmm.reset_launches()
        assert set(tmm.LAUNCHES.values()) == {0}
    finally:
        tmm.LAUNCHES.update(saved)


def _nibbles_to_s8(x):
    """csrc/similarity_wgmma.cu:nibbles_to_s8 on uint32 words: the signed
    codes of the low and of the high nibbles, byte for byte."""
    x = x.astype(np.uint32)
    h = x >> np.uint32(4)
    lo = (x & np.uint32(0x0F0F0F0F)) | (
        (x & np.uint32(0x08080808)) * np.uint32(0x1E)
    )
    hi = (h & np.uint32(0x0F0F0F0F)) | (
        (h & np.uint32(0x08080808)) * np.uint32(0x1E)
    )
    return lo, hi


def test_k6_decode_is_exact_for_every_byte():
    """Both nibbles of all 256 bytes decode to ((v & 0xF) ^ 8) - 8."""
    words = np.arange(256, dtype=np.uint8).view("<u4")
    lo, hi = _nibbles_to_s8(words)
    v = np.arange(256)
    np.testing.assert_array_equal(
        lo.view(np.int8), ((v & 0xF) ^ 8) - 8
    )
    np.testing.assert_array_equal(hi.view(np.int8), ((v >> 4) ^ 8) - 8)


def _k6_emulated(q8, d_packed, qs, ds):
    """csrc/similarity_wgmma.cu on int4_kernel_operands's operands: stage
    k takes corpus bytes [64 k, 64 k + 64) and query columns [64 k, 64 k +
    64) and [HP + 64 k, HP + 64 k + 64), each zero past its operand's width
    (TMA's fill); 32-bit words of 4 corpus bytes decode as the kernel does
    (their bytes in the A slots' order); the sums are exact; then (float(
    acc) * qs) * ds in f32."""
    q, d, hp = tmm.int4_kernel_operands(q8, d_packed)
    q, d = q.numpy().astype(np.int64), d.numpy()
    assert d.shape[1] == hp and q.shape[1] == 2 * hp
    assert hp % tmm.TMA_ALIGN == 0
    stages = -(-hp // 64)
    qz = np.zeros((q.shape[0], 2 * hp + 64), np.int64)
    qz[:, : 2 * hp] = q
    dz = np.zeros((d.shape[0], 64 * stages), np.uint8)
    dz[:, :hp] = d
    acc = np.zeros((q.shape[0], d.shape[0]), np.int64)
    for k in range(stages):
        words = np.ascontiguousarray(dz[:, 64 * k : 64 * k + 64]).view("<u4")
        lo, hi = (w.view(np.int8).astype(np.int64) for w in _nibbles_to_s8(words))
        acc += qz[:, 64 * k : 64 * k + 64] @ lo.T
        acc += qz[:, hp + 64 * k : hp + 64 * k + 64] @ hi.T
    out = acc.astype(np.float32) * qs.numpy()[:, None]
    return out * ds.numpy()[None, :]


@pytest.mark.parametrize("half", [16, 24, 48, 64, 100, 128, 200, 384, 388])
def test_k6_operands_give_plain_result(half):
    """The padded corpus and the placed query, read stage by stage as the
    kernel reads them, give int4_similarity_plain's exact result; a copy
    is made (and counted) only for a packed width off 16 bytes."""
    rng = np.random.RandomState(half)
    b, n = 5, 7
    q8, docs = _t(
        rng.randint(-128, 128, (b, 2 * half)).astype(np.int8),
        rng.randint(0, 256, (n, half)).astype(np.uint8),
    )
    qs, ds = _t((rng.rand(b) / 127).astype(np.float32),
                (rng.rand(n) / 7).astype(np.float32))
    before = dict(tmm.PAD_COPIES)
    got = _k6_emulated(q8, docs, qs, ds)
    copied = int(half % tmm.TMA_ALIGN != 0)
    assert tmm.PAD_COPIES == {k: v + copied for k, v in before.items()}
    want = tmm.int4_similarity_plain(q8, docs, qs, ds).numpy()
    np.testing.assert_array_equal(got, want)


def test_k6_operands_are_the_inputs_when_aligned():
    q8 = torch.zeros(3, 64, dtype=torch.int8)
    docs = torch.zeros(4, 32, dtype=torch.uint8)
    q, d, hp = tmm.int4_kernel_operands(q8, docs)
    assert hp == 32 and q is q8 and d is docs
    # A view that starts off 16 bytes is copied, not refused.
    flat = torch.zeros(8 + docs.numel(), dtype=torch.uint8)
    _, d, _ = tmm.int4_kernel_operands(q8, flat[8:].view(4, 32))
    assert d.data_ptr() % 16 == 0 and d.shape == (4, 32)


# ----------------------------------------------------------------------
# K8's walk (csrc/quantize.cu:dequantize_rows_kernel), modelled here
# ----------------------------------------------------------------------

def _csrc_int_constants(source):
    """The file-scope ``constexpr int name = expr;`` constants of
    osr_tpu_torch/csrc/<source>, each expression (integers, earlier names,
    ``*``, ``/``, ``+``, ``-``) evaluated with C's integer division."""
    path = Path(tmm.__file__).resolve().parents[1] / "csrc" / source
    env = {}
    for name, expr in re.findall(
        r"^constexpr int (\w+) = ([\w\s*/+-]+);", path.read_text(), re.M
    ):
        env[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, env)
    return env


_K8_CONSTANTS = _csrc_int_constants("quantize.cu")
K8_ROWS_PER_BLOCK = _K8_CONSTANTS["kRowsPerBlock"]  # warps a block
K8_UNROLL = _K8_CONSTANTS["kDequantUnroll"]  # words a lane loads first


def _k8_walk(n, d, blocks):
    """How many times the kernel writes each (row, column) of an (n, d)
    output with ``blocks`` blocks, and the word ranges of its vector store
    instructions: warp v of the grid's V warps takes rows v, v + V, ...;
    with D % 4 == 0, lane l stores words l + 32 i (columns 4 w .. 4 w + 3)
    in passes of K8_UNROLL words, else it stores columns l + 32 i."""
    writes = np.zeros((n, d), np.int64)
    stores = []
    warps = blocks * K8_ROWS_PER_BLOCK
    words = d // 4
    for v in range(warps):
        for row in range(v, n, warps):
            if d % 4:
                for lane in range(32):
                    writes[row, lane::32] += 1
                continue
            for start in range(0, words, 32 * K8_UNROLL):
                for u in range(K8_UNROLL):
                    lanes = [start + 32 * u + lane for lane in range(32)]
                    lanes = [w for w in lanes if w < words]
                    for w in lanes:
                        writes[row, 4 * w : 4 * w + 4] += 1
                    if lanes:
                        stores.append(lanes)
    return writes, stores


@pytest.mark.parametrize("blocks", [1, 3, 200])
@pytest.mark.parametrize("n,d", [(37, 776), (5, 3), (9, 1_028), (1, 4),
                                 (17, 2_052), (40, 130)])
def test_k8_walk_writes_every_element_once(n, d, blocks):
    """Every element of ragged shapes is written exactly once, whatever
    the grid (a warp walking several rows, or blocks with no row), and
    each vector store instruction of a warp covers contiguous words: 512
    contiguous bytes, or the row's guarded tail."""
    writes, stores = _k8_walk(n, d, blocks)
    np.testing.assert_array_equal(writes, np.ones((n, d), np.int64))
    for lanes in stores:
        assert lanes == list(range(lanes[0], lanes[0] + len(lanes)))
        assert len(lanes) == 32 or lanes[-1] == d // 4 - 1


def test_stochastic_quantize_unbiased(embeddings):
    """Mirrors tests/test_pallas_kernels.py's stochastic test, which the
    JAX side skips on the CPU: averaging over seeds reduces the error
    below the deterministic rounding's, and one draw stays within a
    quantization step."""
    x = torch.from_numpy(embeddings[:64])
    recons = []
    for seed in range(8):
        v, s = tqk.quantize_symmetric(x, stochastic=True, seed=seed)
        assert v.abs().max() <= 127
        recons.append(tqk.dequantize_symmetric(v, s).numpy())
    det_v, det_s = tqk.quantize_symmetric(x)
    det_err = np.abs(
        tqk.dequantize_symmetric(det_v, det_s).numpy() - embeddings[:64]
    ).mean()
    stoch_err = np.abs(np.mean(recons, axis=0) - embeddings[:64]).mean()
    assert stoch_err < det_err * 1.5
    step = (np.abs(embeddings[:64]).max(axis=1) / 127.0).max()
    assert np.abs(recons[0] - embeddings[:64]).max() <= step + 1e-6
    # The expectation of one code is x / scale: over many seeds the mean
    # code approaches it far closer than deterministic rounding does.
    codes = np.mean(
        [tqk.quantize_symmetric(x[:4], stochastic=True, seed=s)[0].numpy()
         for s in range(400)],
        axis=0,
    )
    exact = (x[:4] / det_s[:4, None]).numpy()
    assert np.abs(codes - exact).mean() < 0.05


def _fmix32_np(x):
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def test_stochastic_bits_are_32_bit_fmix32():
    """The int64 tensor arithmetic of the plain version reproduces uint32
    fmix32 (what csrc/quantize.cu computes), rows past 2^32 wrapping."""
    seed = 0xDEADBEEF
    rows = np.array([0, 1, 7, 123_456, 2**31 - 1, 2**32 + 5], np.int64)
    cols = np.arange(0, 1000, 37, dtype=np.int64)
    with np.errstate(over="ignore"):
        key = _fmix32_np(
            np.uint32(seed)
            ^ (rows.astype(np.uint32) * np.uint32(0x9E3779B1))
        )
        want = _fmix32_np(key[:, None] ^ cols.astype(np.uint32)[None, :])
    got = tqk.stochastic_bits(
        seed, torch.from_numpy(rows), torch.from_numpy(cols)
    )
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_stochastic_seed_from_generator(embeddings):
    x = torch.from_numpy(embeddings[:16])
    a = tqk.quantize_symmetric(
        x, stochastic=True, generator=torch.Generator().manual_seed(3)
    )[0]
    b = tqk.quantize_symmetric(
        x, stochastic=True, generator=torch.Generator().manual_seed(3)
    )[0]
    c = tqk.quantize_symmetric(
        x, stochastic=True, generator=torch.Generator().manual_seed(4)
    )[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


# ----------------------------------------------------------------------
# Similarity and search against osr_tpu's XLA ops
# ----------------------------------------------------------------------


def test_int8_products_match_osr_tpu(jax_ref, embeddings):
    jnp, jqz, _, _ = jax_ref
    queries = synthetic_corpus_embeddings(16, dim=128, seed=7)
    q8, qs = jqz.quantize_symmetric(jnp.asarray(queries))
    d8, ds = jqz.quantize_symmetric(jnp.asarray(embeddings))
    args = _t(*(np.asarray(a) for a in (q8, d8, qs, ds)))
    np.testing.assert_array_equal(
        tqz.int8_matmul(args[0], args[1]).numpy(),
        np.asarray(jqz.int8_matmul(q8, d8)),
    )
    np.testing.assert_allclose(
        tqz.int8_dot_product_batch(*args).numpy(),
        np.asarray(jqz.int8_dot_product_batch(q8, d8, qs, ds)),
        rtol=RTOL,
    )
    np.testing.assert_allclose(
        tqz.int8_cosine_similarity(*args).numpy(),
        np.asarray(jqz.int8_cosine_similarity(q8, d8, qs, ds)),
        rtol=1e-5,  # the f32 norms sum in another order
    )
    got = tqz.int8_dot_product_batch(*args).numpy()
    want = queries @ embeddings.T
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
    np.testing.assert_allclose(got, want, atol=0.05)


SEARCHES = ["int8_search_symmetric", "int4_search_symmetric",
            "int4_search_symmetric_grouped", "int8_search_asymmetric",
            "fp_search"]


@pytest.mark.parametrize("fn", SEARCHES)
@pytest.mark.parametrize("n", [300, 2_500])  # one sort / block-pruned
def test_search_functions_match_osr_tpu(jax_ref, fn, n):
    jnp, jqz, _, _ = jax_ref
    docs = synthetic_corpus_embeddings(n, dim=256, seed=5)
    queries = synthetic_corpus_embeddings(9, dim=256, seed=6)
    jq, tq = jnp.asarray(queries), torch.from_numpy(queries)
    if fn == "int8_search_symmetric":
        jd = jqz.quantize_symmetric(jnp.asarray(docs))
    elif fn == "int4_search_symmetric":
        jd = jqz.quantize_symmetric_int4(jnp.asarray(docs))
    elif fn == "int4_search_symmetric_grouped":
        jd = jqz.quantize_symmetric_int4_grouped(jnp.asarray(docs))
    elif fn == "int8_search_asymmetric":
        jd = jqz.quantize_asymmetric(jnp.asarray(docs))
    else:
        jd = (jnp.asarray(docs),)
    td = _t(*(np.asarray(a) for a in jd))
    wv, wi = getattr(jqz, fn)(jq, *jd, k=13)
    gv, gi = getattr(tqz, fn)(tq, *td, k=13)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if fn == "int8_search_asymmetric":
        bound = _asymmetric_bound(tq, *td)
        bound = np.take_along_axis(bound, np.asarray(wi).astype(int), 1)
        assert np.all(np.abs(gv.numpy() - np.asarray(wv)) <= bound)
    elif fn in ("fp_search", "int4_search_symmetric_grouped"):
        ref = queries if fn == "fp_search" else torch.from_numpy(
            queries).to(torch.bfloat16).float().numpy()
        rows = docs if fn == "fp_search" else (
            tqz.unpack_int4_signed(td[0]).numpy().astype(np.float64)
            .reshape(n, 2, 128) * td[1].numpy()[:, :, None]
        ).reshape(n, 256)
        bound = _f32_bound(ref, rows)
        bound = np.take_along_axis(bound, np.asarray(wi).astype(int), 1)
        assert np.all(np.abs(gv.numpy() - np.asarray(wv)) <= bound)
    else:
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=RTOL,
                                   atol=RTOL * np.abs(np.asarray(wv)).max())


def _asymmetric_bound(queries, docs_u8, scales, mins):
    """8 ulp of the sum of the magnitudes of the four f32 terms of the
    asymmetric score (int8_search_asymmetric's docstring): XLA may fuse
    and contract them differently, and they cancel."""
    uq, qs, qm = (t.double().numpy() for t in tqz.quantize_asymmetric(queries))
    ud = docs_u8.double().numpy()
    ds, dm = scales.double().numpy(), mins.double().numpy()
    terms = (
        np.abs(uq @ ud.T) * np.abs(qs)[:, None] * np.abs(ds)[None, :]
        + np.abs(qs * uq.sum(1))[:, None] * np.abs(dm)[None, :]
        + np.abs(qm)[:, None] * np.abs(ds * ud.sum(1))[None, :]
        + uq.shape[1] * np.abs(qm)[:, None] * np.abs(dm)[None, :]
    )
    return 8 * 2.0**-24 * terms


def test_block_pruned_selection_matches_plain_sort():
    docs = synthetic_corpus_embeddings(2500, dim=64, seed=5)
    queries = synthetic_corpus_embeddings(9, dim=64, seed=6)
    d8, ds = tqz.quantize_symmetric(torch.from_numpy(docs))
    vals, ids = tqz.int8_search_symmetric(torch.from_numpy(queries), d8, ds, k=13)
    q8, qs = tqz.quantize_symmetric(torch.from_numpy(queries))
    full = tqz.int8_dot_product_batch(q8, d8, qs, ds).numpy()
    ref = np.argsort(-full, axis=1, kind="stable")[:, :13]
    np.testing.assert_array_equal(ids.numpy(), ref)
    np.testing.assert_array_equal(
        vals.numpy(), np.take_along_axis(full, ref, axis=1)
    )


# ----------------------------------------------------------------------
# Wrapper checks (device-independent, so they run on CPU tensors)
# ----------------------------------------------------------------------


def _matmul_operands(case):
    rng = np.random.RandomState(1)
    q8 = torch.from_numpy(rng.randint(-127, 128, (5, 64)).astype(np.int8))
    docs = torch.from_numpy(rng.randint(-127, 128, (7, 64)).astype(np.int8))
    qs, ds = torch.rand(5), torch.rand(7)
    int4 = False
    if case == "q_dtype":
        q8 = q8.float()
    elif case == "docs_dtype":
        docs = docs.to(torch.uint8)
    elif case == "width":
        docs = docs[:, :32].contiguous()
    elif case == "int4_width":
        docs, int4 = docs.to(torch.uint8), True
    elif case == "strided":
        docs = torch.zeros(64, 7, dtype=torch.int8).T
    elif case == "q_scales_len":
        qs = qs[:-1]
    elif case == "d_scales_dtype":
        ds = ds.double()
    return (q8, docs, qs, ds, int4)


@pytest.mark.parametrize(
    "case",
    ["q_dtype", "docs_dtype", "width", "int4_width", "strided",
     "q_scales_len", "d_scales_dtype"],
)
def test_similarity_operand_checks_refuse(case):
    tmm._check_operands(*_matmul_operands(None))  # the good case passes
    with pytest.raises(ValueError):
        tmm._check_operands(*_matmul_operands(case))


def test_quantize_operand_checks_refuse():
    tqk._check_2d("x", torch.zeros(3, 4), torch.float32)
    with pytest.raises(ValueError):
        tqk._check_2d("x", torch.zeros(3, 4, dtype=torch.float64),
                      torch.float32)
    with pytest.raises(ValueError):
        tqk._check_2d("x", torch.zeros(4, 3).T, torch.float32)
    with pytest.raises(ValueError):
        tqk._check_2d("x", torch.zeros(4), torch.float32)


# ----------------------------------------------------------------------
# Kernels on the card
# ----------------------------------------------------------------------

# (B, N, D): ragged against the 128 x 128 tiles, the stages and 16 bytes
# (K5's width 776 is padded to 784, K6's packed width 388 to 400), N = 129
# off 4 (plain stores).
RAGGED = [(37, 1_000, 776), (130, 300, 768), (1, 129, 32)]


def _codes(rng, shape, int4):
    if int4:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.randint(-128, 128, shape).astype(np.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("b,n,d", RAGGED)
def test_similarity_kernel_matches_plain_on_card(cuda, int4, b, n, d):
    rng = np.random.RandomState(b + n + d)
    q8 = _codes(rng, (b, d), False)
    docs = _codes(rng, (n, d // 2 if int4 else d), int4)
    qs = (rng.rand(b) / 127).astype(np.float32)
    ds = (rng.rand(n) / 127).astype(np.float32)
    args = _t(q8, docs, qs, ds, device=cuda)
    name = "int4_similarity" if int4 else "int8_similarity"
    before = tmm.LAUNCHES[name]
    got = (tmm.int4_similarity if int4 else tmm.int8_similarity)(*args)
    plain = tmm.int4_similarity_plain if int4 else tmm.int8_similarity_plain
    want = plain(*args)
    torch.cuda.synchronize()
    assert tmm.LAUNCHES[name] == before + 1
    assert torch.equal(got, want)


# K6 (csrc/similarity_wgmma.cu) at its edges, (B, N, D): a stage takes 64
# packed bytes (D/2 below, at and off a stage; off 16 bytes the wrapper
# pads), B and N off the 128 tiles, N off 4 (plain stores), N and B large
# enough that each persistent block walks several tiles, and widths of 9
# to 32 stages.
K6_EDGES = [
    (1, 1, 32), (64, 127, 48), (130, 129, 96), (257, 1_031, 128),
    (1, 129, 200), (130, 1, 256), (64, 1_031, 400), (257, 127, 776),
    (37, 300, 1_024), (130, 34_000, 768), (257, 33_795, 200),
    (17_000, 200, 64), (37, 300, 1_040), (130, 1_031, 2_048),
    (64, 34_000, 1_536),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", K6_EDGES)
def test_int4_similarity_edges_on_card(cuda, b, n, d):
    rng = np.random.RandomState(b * n + d)
    q8 = _codes(rng, (b, d), False)
    docs = _codes(rng, (n, d // 2), True)
    qs = (rng.rand(b) / 127).astype(np.float32)
    ds = (rng.rand(n) / 7).astype(np.float32)
    args = _t(q8, docs, qs, ds, device=cuda)
    before = tmm.LAUNCHES["int4_similarity"]
    copies = dict(tmm.PAD_COPIES)
    got = tmm.int4_similarity(*args)
    want = tmm.int4_similarity_plain(*args)
    torch.cuda.synchronize()
    assert tmm.LAUNCHES["int4_similarity"] == before + 1
    padded = int((d // 2) % tmm.TMA_ALIGN != 0)
    assert tmm.PAD_COPIES == {k: v + padded for k, v in copies.items()}
    assert torch.equal(got, want)


# K5 (csrc/similarity_wgmma.cu, int8) at its edges, (B, N, D): a stage
# takes 128 bytes a row (D below, at and off a stage; off 16 bytes the
# wrapper pads), B and N off the 128 tiles, N off 4 (plain stores), N and
# B large enough that each persistent block walks several tiles, and
# widths of 1 to 16 stages.
K5_EDGES = [
    (5, 3, 1), (1, 1, 16), (64, 127, 24), (130, 129, 128), (1, 129, 100),
    (257, 1_031, 200), (130, 1, 256), (64, 1_031, 776), (257, 127, 768),
    (37, 300, 1_024), (130, 34_000, 768), (257, 33_795, 200),
    (17_000, 200, 64), (37, 300, 1_040), (130, 1_031, 2_048),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", K5_EDGES)
def test_int8_similarity_edges_on_card(cuda, b, n, d):
    rng = np.random.RandomState(b * n + d)
    q8 = _codes(rng, (b, d), False)
    docs = _codes(rng, (n, d), False)
    qs = (rng.rand(b) / 127).astype(np.float32)
    ds = (rng.rand(n) / 7).astype(np.float32)
    args = _t(q8, docs, qs, ds, device=cuda)
    before = tmm.LAUNCHES["int8_similarity"]
    copies = dict(tmm.PAD_COPIES)
    got = tmm.int8_similarity(*args)
    want = tmm.int8_similarity_plain(*args)
    torch.cuda.synchronize()
    assert tmm.LAUNCHES["int8_similarity"] == before + 1
    padded = int(d % tmm.TMA_ALIGN != 0)
    assert tmm.PAD_COPIES == {k: v + padded for k, v in copies.items()}
    assert torch.equal(got, want)


# K5 and K6 with their block maxima, (B, N, D): N a multiple of 128, off
# 128, off 4 (plain stores), below 128; B = 1, 1,024 and 1,000, and last
# query tiles of 1, 2, 3, 8 and 9 rows (rows >= B not written). "negative":
# every real score of the ragged last block is below 0 (non-negative
# queries, negative codes there), so a maximum that counted the block's
# zero-filled docs would read 0.
BLOCKMAX_CASES = [
    (130, 1_024, 768, ""), (37, 1_000, 776, ""), (130, 1_031, 128, ""),
    (64, 127, 48, ""), (1, 4_099, 768, ""), (1_024, 2_048, 768, ""),
    (1_000, 3_000, 256, ""), (136, 1_000, 256, ""), (137, 300, 128, ""),
    (70, 1_000, 256, "negative"),
    (3, 127, 32, "negative"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("b,n,d,tail", BLOCKMAX_CASES)
def test_similarity_blockmax_on_card(cuda, int4, b, n, d, tail):
    """The kernel's maxima equal ``topk.block_max`` of its own scores bit
    for bit, and its scores equal the scores-only launch's and the plain
    version's."""
    from osr_tpu_torch.ops.topk import block_max

    rng = np.random.RandomState(b * n + d)
    q8 = _codes(rng, (b, d), False)
    docs = _codes(rng, (n, d // 2 if int4 else d), int4)
    if tail:
        q8 = np.abs(q8.astype(np.int16)).clip(1, 127).astype(np.int8)
        last = docs[n - n % 128 :]
        if int4:  # both nibbles in 8..15: codes -8..-1
            last[:] = (rng.randint(8, 16, last.shape)
                       | rng.randint(8, 16, last.shape) << 4)
        else:
            last[:] = rng.randint(-128, 0, last.shape)
    qs = (rng.rand(b) / 127).astype(np.float32)
    ds = (rng.rand(n) / 7).astype(np.float32)
    args = _t(q8, docs, qs, ds, device=cuda)
    name = "int4_similarity" if int4 else "int8_similarity"
    before = dict(tmm.LAUNCHES)
    fused = (tmm.int4_similarity_blockmax if int4
             else tmm.int8_similarity_blockmax)
    scores, maxima = fused(*args)
    alone = (tmm.int4_similarity if int4 else tmm.int8_similarity)(*args)
    plain = tmm.int4_similarity_plain if int4 else tmm.int8_similarity_plain
    want = plain(*args)
    torch.cuda.synchronize()
    assert tmm.LAUNCHES[name] == before[name] + 2
    assert tmm.LAUNCHES[name + "_blockmax"] == before[name + "_blockmax"] + 1
    assert maxima.shape == (b, -(-n // 128))
    assert torch.equal(scores.view(torch.int32), alone.view(torch.int32))
    assert torch.equal(scores, want)
    assert torch.equal(maxima.view(torch.int32),
                       block_max(scores).view(torch.int32))
    if tail:
        assert (maxima[:, -1] < 0).all()


@pytest.mark.cuda
def test_similarity_wgmma_refuses_bad_operands(cuda):
    """osr_similarity_i4 and osr_similarity_i8 return
    cudaErrorInvalidValue (1) and launch nothing for an operand width off
    16 bytes, a base off 16 bytes or a negative shape."""
    from osr_tpu_torch.ops import _build

    lib = _build.library("similarity_wgmma")
    q = torch.zeros(4, 80, dtype=torch.int8, device=cuda)
    d = torch.ones(8, 40, dtype=torch.uint8, device=cuda)
    qs = torch.ones(4, device=cuda)
    ds = torch.ones(8, device=cuda)
    out = torch.zeros(4, 8, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (qs.data_ptr(), ds.data_ptr(), out.data_ptr())
    assert lib.osr_similarity_i4(
        q.data_ptr(), d.data_ptr(), *ptrs, 4, 8, 40, stream
    ) == 1
    assert lib.osr_similarity_i4(
        q.data_ptr(), d.data_ptr() + 8, *ptrs, 4, 8, 32, stream
    ) == 1
    assert lib.osr_similarity_i8(
        q.data_ptr(), d.data_ptr(), *ptrs, 4, 8, 40, stream
    ) == 1
    assert lib.osr_similarity_i8(
        q.data_ptr() + 8, d.data_ptr(), *ptrs, 4, 8, 32, stream
    ) == 1
    assert lib.osr_similarity_i8(
        q.data_ptr(), d.data_ptr() + 8, *ptrs, 4, 8, 32, stream
    ) == 1
    assert lib.osr_similarity_i8(
        q.data_ptr(), d.data_ptr(), *ptrs, -1, 8, 32, stream
    ) == 1
    torch.cuda.synchronize()
    assert torch.count_nonzero(out) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("n,d", [(1_000, 776), (37, 3), (130, 768)])
def test_quantize_kernels_match_plain_on_card(cuda, stochastic, n, d):
    rng = np.random.RandomState(n + d)
    x = (rng.randn(n, d) * rng.rand(n, 1)).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes the 1e-8 floor
    (xt,) = _t(x, device=cuda)
    v, s = tqk.quantize_symmetric(xt, stochastic=stochastic, seed=11)
    pv, ps = tqk.quantize_symmetric_plain(xt, stochastic=stochastic, seed=11)
    back = tqk.dequantize_symmetric(v, s)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(s, ps)
    assert torch.equal(back, tqk.dequantize_symmetric_plain(v, s))


# K8's shapes: D % 16 != 0 on the vector path (776, 1,028: a row's last
# pass guarded), D % 4 != 0 (the scalar path), a width of one word, and a
# row longer than one pass of K8_UNROLL words a lane.
K8_SHAPES = [(1_000, 776), (130, 768), (9, 1_028), (37, 3), (300, 1_027),
             (5, 4), (17, 2_052)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", K8_SHAPES)
def test_dequantize_kernel_matches_plain_on_card(cuda, n, d):
    rng = np.random.RandomState(n * d)
    values = rng.randint(-128, 128, (n, d)).astype(np.int8)
    scales = (rng.rand(n) / 127).astype(np.float32)
    v, s = _t(values, scales, device=cuda)
    before = tqk.LAUNCHES["dequantize_symmetric"]
    got = tqk.dequantize_symmetric(v, s)
    # A view whose base is off 4 bytes takes the scalar path.
    flat = torch.cat([torch.zeros(1, dtype=torch.int8, device=cuda),
                      v.flatten()])
    got_off = tqk.dequantize_symmetric(flat[1:].view(n, d), s)
    torch.cuda.synchronize()
    assert tqk.LAUNCHES["dequantize_symmetric"] == before + 2
    want = tqk.dequantize_symmetric_plain(v, s)
    assert torch.equal(got, want) and torch.equal(got_off, want)
