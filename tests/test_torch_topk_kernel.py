"""The select kernel behind ``osr_tpu_torch/ops/topk.py:topk``
(``csrc/topk_select.cu``).

On the CPU: the route rule (which selections launch the kernel), the
counters, and a model of the kernel's algorithm (the order keys, 11-bit
radix digits over the row, the staging threshold, the all-equal shortcut,
the ordered compaction, and the radix select on the 64-bit (key, ~column)
word that keeps k staged words) held to the stable sort at small stage and
tile sizes that reach every branch.

Tests marked ``cuda`` hold the kernel to ``torch.sort(..., stable=True)``'s
first k on the card, values and indices bit for bit (both its paths: a
warp a row for rows of at most 1,024 entries and k at most 64, a block a
row otherwise): at the selection shapes of the benchmark's five cells, on heavy ties at the k-th value,
signed zeros, -inf and NaN, at the edges of k and n, on ragged widths,
misaligned rows, 3-D and non-contiguous inputs and every dtype ``topk``
takes. They skip without a card; on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_topk_kernel.py``.
"""

import numpy as np
import pytest
import torch

from osr_tpu_torch.ops import topk as ttopk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    return torch.device("cuda")


def _sorted_topk(x, k):
    kk = min(k, x.shape[-1])
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :kk], i[..., :kk].int()


def _assert_bit_equal(got, want):
    gv, gi = got
    wv, wi = want
    assert gv.dtype == wv.dtype and gi.dtype == torch.int32
    assert gv.shape == wv.shape and gi.shape == wi.shape
    assert torch.equal(gi.cpu(), wi.cpu())
    # Bits, not values: -0.0 against +0.0 and NaN payloads count.
    if gv.dtype in (torch.float32, torch.int32):
        assert torch.equal(gv.view(torch.int32).cpu(), wv.view(torch.int32).cpu())
    else:
        assert torch.equal(gv.view(torch.int16).cpu(), wv.view(torch.int16).cpu())


# ----------------------------------------------------------------------
# The route rule and the counters (CPU)
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "device_type, n, k, kernel",
    [
        ("cuda", 57_728, 1_000, True),  # fiqa-bm25.top1000's full row
        ("cuda", 451, 50, True),  # fiqa-bm25.batch's maxima
        ("cuda", 4_000, 1_000, True),  # msmarco's chunk merge
        ("cuda", 5_000, ttopk.MAX_K, True),  # the largest k
        ("cuda", 5_000, ttopk.MAX_K + 1, False),  # above the stage
        ("cuda", 1_000, 1_000, False),  # n = k: nothing to discard
        ("cuda", 10, 1_000, False),  # n < k
        ("cpu", 57_728, 1_000, False),  # the plain version
    ],
)
def test_route_rule(device_type, n, k, kernel):
    assert ttopk.takes_kernel(device_type, n, k) is kernel


def test_cpu_topk_counts_nothing():
    ttopk.reset_launches()
    x = torch.randn(3, 500)
    _assert_bit_equal(ttopk.topk(x, k=7), _sorted_topk(x, 7))
    assert ttopk.LAUNCHES == {"topk_select": 0}
    assert ttopk.SORT_ROUTE == {"cuda": 0}


def test_negative_k_is_refused():
    with pytest.raises(ValueError):
        ttopk.topk(torch.zeros(2, 5), k=-1)


# ----------------------------------------------------------------------
# A model of the kernel's algorithm (CPU)
# ----------------------------------------------------------------------


def _order_keys(x):
    """csrc/topk_select.cu:order_key of float32 entries, as int64."""
    b = x.view(np.uint32).astype(np.int64)
    b = np.where(b == 0x80000000, 0, b)
    keys = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return np.where(np.isnan(x), 0xFFFFFFFF, keys)


def _model_select_words(words, k):
    """csrc/topk_select.cu:select_in_stage: the k largest of distinct
    64-bit words by radix rounds that each count the 11 bits below the
    highest bit their candidates differ in."""
    prefix = pmask = 0
    need = k
    while True:
        match = [w for w in words if w & pmask == prefix]
        lo, hi = min(match), max(match)
        top = (lo ^ hi).bit_length() - 1
        shift = max(0, top - 10)
        hist = np.bincount([(w >> shift) & 2047 for w in match], minlength=2048)
        above, b = 0, 2047
        while above + hist[b] < need:
            above += hist[b]
            b -= 1
        need -= above
        shared = ~((2 << top) - 1) & (2**64 - 1)
        prefix = (lo & shared) | (b << shift)
        pmask = shared | (2047 << shift)
        if hist[b] == need:
            return [w for w in words if w >= prefix]


def _model_topk(x, k, stage, tile):
    """One row through the kernel's steps with a stage of ``stage`` words
    and ordered tiles of ``tile`` entries: (values, columns, branch)."""
    n = x.shape[0]
    key = _order_keys(x)

    def finish(cols):
        words = [(int(key[c]) << 32) | (~int(c) & 0xFFFFFFFF) for c in cols]
        if len(words) > k:
            words = _model_select_words(words, k)
        assert len(words) == k
        top = np.array([~w & 0xFFFFFFFF for w in sorted(words, reverse=True)])
        return x[top], top

    if n <= stage:
        return (*finish(np.arange(n)), "whole row")
    prefix = pmask = n_gt = 0
    need, branch = k, "three digits"
    for shift in (21, 10, 0):
        match = key[(key & pmask) == prefix]
        if match.min() == match.max():
            prefix, branch = int(match.min()), "all equal"
            break
        hist = np.bincount((match >> shift) & 2047, minlength=2048)
        above, b = 0, 2047
        while above + hist[b] < need:
            above += hist[b]
            b -= 1
        n_gt, need, cnt = n_gt + above, need - above, int(hist[b])
        prefix |= b << shift
        pmask |= 2047 << shift
        if n_gt + cnt <= stage:
            cols = np.flatnonzero(key >= prefix)
            assert cols.size == n_gt + cnt
            return (*finish(cols), f"staged after shift {shift}")
    tau, kept, wins, ties = prefix, [], 0, 0
    for start in range(0, n, tile):
        for c in range(start, min(start + tile, n)):
            if key[c] > tau:
                kept.append(c)
                wins += 1
            elif key[c] == tau:
                if ties < need:
                    kept.append(c)
                ties += 1
        if wins == n_gt and ties >= need:
            break
    assert len(kept) == k
    return (*finish(np.array(kept)), f"compacted, {branch}")


def _model_rows():
    rng = np.random.default_rng(25)
    tied = np.round(rng.standard_normal(3_000) * 4).astype(np.float32) / 4
    zeros = np.zeros(3_000, np.float32)
    zeros[rng.choice(3_000, 40, replace=False)] = rng.random(40) + 1
    near = np.float32(1.0) + np.arange(3_000, dtype=np.float32) * 2.0**-23
    cluster = np.full(3_000, 7.0, np.float32)
    cluster[::3] = 7.0 + np.arange(1_000, dtype=np.float32) * 2.0**-20
    cluster[-5:] = 9.0
    signed = np.where(rng.random(3_000) < 0.5, -0.0, 0.0).astype(np.float32)
    signed[rng.choice(3_000, 9, replace=False)] = 2.0
    special = rng.standard_normal(3_000).astype(np.float32)
    special[rng.choice(3_000, 30, replace=False)] = np.nan
    special[rng.choice(3_000, 30, replace=False)] = -np.inf
    special[rng.choice(3_000, 30, replace=False)] = np.inf
    deep = rng.standard_normal(3_000).astype(np.float32)
    deep[:500] = 7.0
    deep[500:530] = 7.0 + np.arange(1, 31, dtype=np.float32) * 2.0**-21
    return {
        "deep tie": rng.permutation(deep),
        "distinct": rng.standard_normal(3_000).astype(np.float32),
        "tied": tied,
        "mostly zero": zeros,
        "all equal": np.full(3_000, 3.5, np.float32),
        "consecutive floats": rng.permutation(near),
        "tie cluster": cluster,
        "signed zeros": signed,
        "nan and inf": special,
        "mostly -inf": np.where(rng.random(3_000) < 0.97, -np.inf,
                                rng.random(3_000)).astype(np.float32),
    }


MODEL_ROWS = _model_rows()


@pytest.mark.parametrize("name", sorted(MODEL_ROWS))
@pytest.mark.parametrize("k", [1, 37, 200])
def test_model_matches_stable_sort(name, k):
    x = MODEL_ROWS[name]
    want_v, want_i = _sorted_topk(torch.from_numpy(x), k)
    for stage, tile in ((64, 16), (512, 128), (4_096, 1_024)):
        if k > stage:  # the kernel's largest k is its stage
            continue
        vals, cols, _ = _model_topk(x, k, stage, tile)
        np.testing.assert_array_equal(cols, want_i.numpy())
        np.testing.assert_array_equal(
            vals.view(np.int32), want_v.numpy().view(np.int32)
        )


def test_model_reaches_every_branch():
    """The rows above take each path of the kernel at a 64-word stage."""
    seen = {
        _model_topk(x, k, 64, 16)[2]
        for x in MODEL_ROWS.values() for k in (1, 37)
    }
    assert {
        "staged after shift 21", "staged after shift 10",
        "staged after shift 0", "compacted, all equal",
        "compacted, three digits",
    } <= seen
    assert _model_topk(MODEL_ROWS["tied"], 37, 4_096, 1_024)[2] == "whole row"


# ----------------------------------------------------------------------
# The kernel on the card
# ----------------------------------------------------------------------

# (the selection, rows, n, k) of the benchmark's cells
CELL_SHAPES = [
    ("fiqa-bm25.top1000 full row", 3_328, 57_728, 1_000),
    ("fiqa-bm25.batch maxima", 3_328, 451, 50),
    ("fiqa-bm25.batch candidates", 3_328, 6_400, 50),
    ("msmarco sweep candidates", 3_496, 128_000, 1_000),
    ("msmarco sweep maxima", 3_496, 17_270, 1_000),
    ("msmarco chunk merge", 3_496, 4_000, 1_000),
    ("nq batch maxima", 1_024, 20_949, 100),
    ("nq batch candidates", 1_024, 12_800, 100),
    ("nq interactive maxima", 1, 20_949, 10),
    ("nq interactive candidates", 1, 1_280, 10),
]


def _scores(rows, n, kind, seed, dev):
    """Seeded (rows, n) float32 scores: ``tied`` rounds to quarters and
    clamps at zero (about half the entries 0, as head scores of documents
    without a query term), ``distinct`` is Gaussian."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, n, generator=g, device=dev)
    if kind == "tied":
        x = (x * 4).round().clamp_min(0) / 4
        x[::7] = 0.0  # some rows all zero
    return x


def _check(x, k):
    before = dict(ttopk.LAUNCHES)
    got = ttopk.topk(x, k=k)
    torch.cuda.synchronize()
    _assert_bit_equal(got, _sorted_topk(x, k))
    return ttopk.LAUNCHES["topk_select"] - before["topk_select"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tied", "distinct"])
@pytest.mark.parametrize("name, rows, n, k", CELL_SHAPES)
def test_kernel_at_cell_shapes(cuda, name, rows, n, k, kind):
    sorts = ttopk.SORT_ROUTE["cuda"]
    x = _scores(rows, n, kind, rows + n + k, cuda)
    assert _check(x, k) == 1
    assert ttopk.SORT_ROUTE["cuda"] == sorts


def _tie_rows(dev):
    """Rows whose k-th value (k = 1,000) is tied far past k: winners spread
    over the whole row, ties in every 2,048-entry tile."""
    rng = np.random.default_rng(3)
    rows = []
    for n in (20_000, 57_728, 4_096, 4_097):
        r = np.ones(n, np.float32)
        r[rng.choice(n, 300, replace=False)] = 5.0 + rng.integers(0, 3, 300)
        r[rng.choice(n, 50, replace=False)] = 0.5
        rows.append(r)
    return [torch.from_numpy(r).to(dev)[None] for r in rows]


@pytest.mark.cuda
def test_kernel_ties_across_tiles(cuda):
    for x in _tie_rows(cuda):
        for k in (1, 299, 300, 301, 1_000, 3_999):
            if k < x.shape[1]:
                assert _check(x, k) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 4_096, 4_097, 50_000])
def test_kernel_all_equal_rows(cuda, n):
    for value in (0.0, -0.0, 2.5, float("-inf")):
        x = torch.full((5, n), value, device=cuda)
        assert _check(x, min(n - 1, 1_000)) == 1


@pytest.mark.cuda
def test_kernel_tie_cluster_needs_three_digits(cuda):
    """10,000 copies of the k-th value among 1,000 distinct neighbours in
    its second digit's bucket: the third digit, then the ordered pass."""
    rng = np.random.default_rng(9)
    r = np.full(12_000, 7.0, np.float32)
    r[:1_000] = 7.0 + np.arange(1, 1_001, dtype=np.float32) * 2.0**-20
    r[1_000:1_500] = 6.9990
    r = rng.permutation(r)
    x = torch.from_numpy(r).to(cuda)[None]
    for k in (500, 1_001, 1_500, ttopk.MAX_K):
        assert _check(x, k) == 1


@pytest.mark.cuda
def test_kernel_signed_zero_inf_nan(cuda):
    rng = np.random.default_rng(11)
    for n in (300, 3_000, 30_000):
        x = np.where(rng.random((6, n)) < 0.5, -0.0, 0.0).astype(np.float32)
        x[:, rng.choice(n, 20, replace=False)] = 1.0
        x[1, rng.choice(n, 40, replace=False)] = np.nan
        x[2, rng.choice(n, 40, replace=False)] = np.inf
        x[3] = -np.inf
        x[3, rng.choice(n, 30, replace=False)] = -1.0
        x[4, rng.choice(n, n // 2, replace=False)] = -np.inf
        x[5] = rng.standard_normal(n)
        x[5, rng.choice(n, 20, replace=False)] = np.nan
        t = torch.from_numpy(x).to(cuda)
        for k in (1, 20, 25, 60, 1_000):
            if k < n:
                assert _check(t, k) == 1


@pytest.mark.cuda
def test_kernel_edges_of_k_and_n(cuda):
    x = _scores(4, 10_000, "tied", 5, cuda)
    for k in (1, 2, ttopk.MAX_K - 1, ttopk.MAX_K):
        assert _check(x, k) == 1
    y = _scores(4, ttopk.MAX_K + 1, "distinct", 6, cuda)
    assert _check(y, ttopk.MAX_K) == 1
    sorts = ttopk.SORT_ROUTE["cuda"]
    for n, k in ((500, 500), (500, 501), (10, 1_000), (10_000, ttopk.MAX_K + 1)):
        assert _check(_scores(3, n, "tied", n, cuda), k) == 0
    assert ttopk.SORT_ROUTE["cuda"] == sorts + 4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 33, 128, 129, 451, 512, 513, 1_024, 1_025])
def test_kernel_warp_rows(cuda, n):
    """Rows of at most 1,024 entries take a warp a row where k is at most
    64 (n = 1,025 and k = 65 the block path beside them)."""
    for kind in ("tied", "distinct"):
        x = _scores(37, n, kind, n + 1, cuda)
        for k in (1, 8, 50, 64, 65):
            if k < n:
                assert _check(x, k) == 1
    rng = np.random.default_rng(n)
    x = np.where(rng.random((4, n)) < 0.5, -0.0, 0.0).astype(np.float32)
    x[1, rng.integers(0, n, 3)] = np.nan
    x[2] = -np.inf
    x[3, rng.integers(0, n, 5)] = 1.0
    t = torch.from_numpy(x).to(cuda)
    assert _check(t, 1) == 1 and _check(t, n // 2 or 1) == 1


@pytest.mark.cuda
def test_kernel_max_k_is_the_sources(cuda):
    from osr_tpu_torch.ops import _build

    assert _build.library("topk_select").osr_topk_select_max_k() == ttopk.MAX_K


@pytest.mark.cuda
@pytest.mark.parametrize("n", [13, 451, 4_099, 6_401, 57_727])
def test_kernel_ragged_widths(cuda, n):
    for kind in ("tied", "distinct"):
        x = _scores(9, n, kind, n, cuda)
        assert _check(x, min(50, n - 1)) == 1


@pytest.mark.cuda
def test_kernel_misaligned_and_strided_rows(cuda):
    base = _scores(7, 20_003, "tied", 2, cuda)
    for off in (1, 2, 3):
        assert _check(base[:, off:off + 19_000], 700) == 1  # row starts off 16 B
        assert _check(base[:, off:off + 3_000], 70) == 1
    assert _check(base[::2, :12_345], 300) == 1  # row stride 2 x 20,003


@pytest.mark.cuda
def test_kernel_3d_and_transposed(cuda):
    x = _scores(6, 40 * 128, "tied", 8, cuda).reshape(6, 40, 128)
    assert _check(x, 8) == 1  # block_topm's (B, G, 128)
    assert _check(x.transpose(1, 2), 5) == 1  # rows of 40, not contiguous
    m = _scores(20_949, 64, "distinct", 9, cuda)
    assert _check(m.t(), 100) == 1  # (G, B) maxima read as (B, G)


@pytest.mark.cuda
def test_kernel_dtypes(cuda):
    x = _scores(5, 9_000, "tied", 10, cuda)
    for dtype in (torch.bfloat16, torch.float16):
        assert _check(x.to(dtype), 100) == 1
    ints = torch.randint(-50, 50, (5, 9_000), device=cuda, dtype=torch.int32)
    ints[0] = torch.iinfo(torch.int32).min
    ints[1, ::3] = torch.iinfo(torch.int32).max
    assert _check(ints, 100) == 1
    with pytest.raises(TypeError):
        ttopk.topk(x.double(), k=10)


@pytest.mark.cuda
def test_kernel_outputs_hold_only_k_columns(cuda):
    x = _scores(8, 4_096, "distinct", 12, cuda)
    vals, idx = ttopk.topk(x, k=50)
    assert vals.untyped_storage().nbytes() == 8 * 50 * 4
    assert idx.untyped_storage().nbytes() == 8 * 50 * 4
    empty = ttopk.topk(x[:0], k=50)
    assert empty[0].shape == empty[1].shape == (0, 50)
