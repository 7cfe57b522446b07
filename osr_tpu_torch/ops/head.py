"""Masked sparse-head scoring: the hand-written Hopper kernels and their
plain PyTorch versions (counterpart of ``osr_tpu/ops/pallas/head.py``).

The dense head of the hybrid index (``index/layout.py``) is scored for a
whole query batch by one contraction over the head width. The per-column
scales fold into the query side (``(A diag(s)) q == A (s q)``), and the
scaled query rounds to bf16 (round to nearest even) before the product,
exactly as ``osr_tpu/ops/pallas/head.py:_pad_operands`` does. int8 and
int4 codes are exact in bf16, products of a bf16 and a code are exact in
f32, and sums accumulate in f32: the host merge's slack bound
(``index/postings.py:merge_tau_slack``) assumes all three.

Wrappers, each with its plain version beside it:

- :func:`masked_head_scores` (int8): launches K1 on a CUDA tensor.
  Replaces ``osr_tpu/ops/pallas/head.py:_head_kernel`` (via
  ``head_scores_pallas``).
- :func:`masked_head_scores_blockmax` (int8 or int4): launches K2 (int8)
  or K3 (int4). Replaces ``_head_blockmax_kernel`` and
  ``_head_blockmax_kernel_i4`` (via ``head_scores_blockmax_pallas``).
- :func:`masked_head_blocktopm` (int8 or int4): launches K4, the per-block
  top-m extraction; the (B, R) scores are never written. Replaces
  ``_make_blocktopm_kernel`` and ``_blocktopm_epilogue`` (via
  ``head_blocktopm_pallas`` and ``masked_head_blocktopm``).

One CUDA source. K1, K2, K3 and both K4s are one kernel template over a
Hopper main loop (``csrc/head_wgmma.cu``), instantiated per head dtype
with three epilogues (scores, scores + block maxima, per-block top-m; the
scores-only one for int8 alone): a TMA ring of head and query tiles, the
codes decoded to bf16 in registers, and ``wgmma`` with the head as its
register operand and f32 accumulators. Within a dtype the epilogues share
the main loop, so K1's scores are bit for bit K2's, and K4's values are
bit for bit the per-block top-m of K2's (K3's) scores. The int8 kernels
read the query columns in their fragments' order: :func:`i8_kernel_query`
permutes them. Bound on an H100 at the bench shape (B=3,328, R=57,728,
F=2,048): 7.87e11 FLOP over 989 TFLOP/s bf16 = 0.7957 ms against 0.27 ms
of bytes, so the tensor cores bound them; K4 per 1M-corpus chunk
(B=2,048, R=500,096): 4.24 ms against 0.46 ms of bytes. A thread block
owns one (128 x 128) output tile, takes the block maxima or top-m inside
the block (no second pass over the (B, R) matrix), and blocks are ordered
so that each head tile stays in L2 while every query tile reads it.
Details at the top of the source.

A wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. ``LAUNCHES`` counts kernel
launches (plain calls are not counted).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from osr_tpu_torch.ops.topk import block_max, block_topm

ROW_TILE = 128  # the kernels' head-row tile: one 128-row pruning block
COL_ALIGN = 16  # the kernels' head-width alignment, in bytes
PTR_ALIGN = 16  # TMA's head alignment, in bytes
BLOCKTOPM_MAX_M = 16  # K4's largest m (csrc/head_wgmma.cu: kMaxM)
I8_STAGE = 128  # int8 head columns per stage of csrc/head_wgmma.cu's ring

LAUNCHES: Dict[str, int] = {
    "head_scores_i8": 0,  # K1
    "head_blockmax_i8": 0,  # K2
    "head_blockmax_i4": 0,  # K3
    "head_blocktopm_i8": 0,  # K4, int8 head
    "head_blocktopm_i4": 0,  # K4, int4 head
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ----------------------------------------------------------------------


def scaled_query(
    qhead: torch.Tensor,  # (B, F) f32 query weights
    head_scales: torch.Tensor,  # (F,) f32
    width: int,  # the head's logical width (>= F), zero-padded
) -> torch.Tensor:
    """(B, width) bf16 query operand: counts x column scales, rounded to
    bf16, zero-padded to the head's logical width."""
    q = (qhead.float() * head_scales.float()[None, :]).to(torch.bfloat16)
    pad = width - q.shape[1]
    if pad < 0:
        raise ValueError(
            f"query width {q.shape[1]} exceeds the head's width {width}"
        )
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
    return q.contiguous()


def logical_width(head: torch.Tensor) -> int:
    """Logical head columns: int8 width, or twice the int4 packed width."""
    return 2 * head.shape[1] if head.dtype == torch.uint8 else head.shape[1]


def decode_head(head: torch.Tensor) -> torch.Tensor:
    """(R, W) f32 codes of an int8 head, or of a block-packed int4 head
    (low nibble of byte c is column c, high nibble column c + packed
    width; codes are unsigned)."""
    if head.dtype == torch.uint8:
        return torch.cat([head & 0xF, head >> 4], dim=1).float()
    return head.float()


class f32_matmul:
    """Context in which CUDA float32 matrix products run in full float32:
    TF32 off for cuBLAS and cuDNN alike, the caller's settings restored
    afterwards."""

    def __enter__(self):
        self._saved = (
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
        )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
        ) = self._saved
        return False


def quantized_head_scores(
    head: torch.Tensor,  # (R, F) int8 or (R, F/2) uint8 int4-packed
    head_scales: torch.Tensor,  # (F,) f32
    qhead: torch.Tensor,  # (B, F) f32
) -> torch.Tensor:
    """(B, R) f32 unmasked head scores, plain: bf16-rounded scaled query,
    exact codes, f32 products and f32 accumulation."""
    q = scaled_query(qhead, head_scales, logical_width(head)).float()
    with f32_matmul():
        return q @ decode_head(head).T


def score_tolerance(
    head: torch.Tensor, head_scales: torch.Tensor, qhead: torch.Tensor
) -> torch.Tensor:
    """(B, R) f32 bound on |kernel - plain| per score: 4 F 2^-24 sum_j
    |q_j w_rj|, the f32 summation-order term of the host merge's slack
    (the products are exact on both sides, only the order of the sums
    differs)."""
    q = scaled_query(qhead, head_scales, logical_width(head)).float()
    with f32_matmul():
        mag = q.abs() @ decode_head(head).abs().T
    return mag.mul_(4 * q.shape[1] * 2.0**-24)


def masked_head_scores_plain(head, head_scales, qhead, valid):
    """Plain twin of K1 (and of K3 without its maxima)."""
    hs = quantized_head_scores(head, head_scales, qhead)
    return hs.masked_fill(~valid[None, :], float("-inf"))


def masked_head_scores_blockmax_plain(head, head_scales, qhead, valid):
    """Plain twin of K2/K3: ((B, R) masked scores, (B, G) block maxima)."""
    hs = masked_head_scores_plain(head, head_scales, qhead, valid)
    return hs, block_max(hs)


def masked_head_blocktopm_plain(head, head_scales, qhead, valid, m):
    """Plain twin of K4: the masked plain scores, -inf past R up to G
    whole blocks, a stable descending sort per block, its first m."""
    hs = masked_head_scores_plain(head, head_scales, qhead, valid)
    return block_topm(hs, m)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------


def _check_operands(head, head_scales, qhead, valid):
    dev = head.device
    for name, t in (
        ("head_scales", head_scales),
        ("qhead", qhead),
        ("valid", valid),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, head on {dev}")
    if head.dtype not in (torch.int8, torch.uint8) or head.dim() != 2:
        raise ValueError(
            f"head must be a 2-D int8 or int4-packed uint8 tensor, got "
            f"{head.dtype} {tuple(head.shape)}"
        )
    if not head.is_contiguous():
        raise ValueError("head must be contiguous")
    # The kernels load the head through TMA, which takes a 16-byte aligned
    # base; a row-chunk view of a head whose width is a multiple of 16 is
    # aligned. Raise rather than copy.
    if head.data_ptr() % PTR_ALIGN:
        raise ValueError(
            f"head starts at an address that is not a multiple of "
            f"{PTR_ALIGN} bytes"
        )
    if head.shape[1] % COL_ALIGN:
        raise ValueError(
            f"head width {head.shape[1]} is not a multiple of {COL_ALIGN}; "
            "pad the columns at upload (retrieval/engine.py:_DeviceIndex)"
        )
    if valid.dtype != torch.bool or valid.shape != (head.shape[0],):
        raise ValueError(
            f"valid must be a ({head.shape[0]},) bool tensor, got "
            f"{valid.dtype} {tuple(valid.shape)}"
        )
    if not valid.is_contiguous():
        raise ValueError("valid must be contiguous")
    if qhead.dtype != torch.float32 or head_scales.dtype != torch.float32:
        raise ValueError("qhead and head_scales must be float32")
    if qhead.dim() != 2 or head_scales.shape != (qhead.shape[1],):
        raise ValueError(
            f"qhead {tuple(qhead.shape)} and head_scales "
            f"{tuple(head_scales.shape)} disagree"
        )
    if qhead.shape[1] > logical_width(head):
        raise ValueError(
            f"qhead has {qhead.shape[1]} columns, the head "
            f"{logical_width(head)}"
        )
    if head.shape[0] >= 2**31 or qhead.shape[0] >= 2**31:
        raise ValueError("kernel dimensions must fit int32")


def i8_stage_order() -> torch.Tensor:
    """(128,) int64: the head column, within one stage of 128, that each
    k position of the int8 kernels' wgmma steps multiplies.

    In ``csrc/head_wgmma.cu`` lane t of a quad loads 16-byte chunks
    2 t + G (G < 2) of its head rows; word j of such a chunk is k-step
    4 G + j, and its byte i the k slot 2 t + (i & 1) + 8 (i >> 1), the
    slots wgmma's A fragment gives the lane. So k position 16 kk + p holds
    column 16 (2 t + G) + 4 j + i, with kk = 4 G + j, t = (p & 7) >> 1 and
    i = (p & 1) + 2 (p >> 3)."""
    k = torch.arange(I8_STAGE)
    kk, p = k // 16, k % 16
    t = (p & 7) >> 1
    i = (p & 1) + 2 * (p >> 3)
    return 16 * (2 * t + kk // 4) + 4 * (kk % 4) + i


@functools.lru_cache(maxsize=None)
def _i8_query_index(width: int, device: torch.device) -> torch.Tensor:
    stages = torch.arange(0, width, I8_STAGE)[:, None]
    return (stages + i8_stage_order()[None, :]).reshape(-1).to(device)


def i8_kernel_query(q: torch.Tensor) -> torch.Tensor:
    """The int8 kernels' query operand: ``q`` (B, W) bf16 zero-padded to
    whole stages of 128 columns, each stage's columns in
    :func:`i8_stage_order`. Only the order of the f32 sums changes."""
    pad = (-q.shape[1]) % I8_STAGE
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
    return q.index_select(1, _i8_query_index(q.shape[1], q.device))


def _launch(lib_name: str, entry: str, name: str, device, *args) -> None:
    """Call the C entry point ``entry`` of ``csrc/<lib_name>.cu`` with
    ``args`` and the current stream; raise on a CUDA error, count the
    launch."""
    from osr_tpu_torch.ops import _build

    lib = _build.library(lib_name)
    stream = torch.cuda.current_stream(device).cuda_stream
    code = getattr(lib, entry)(*args, stream)
    _build.check(lib, code, name)
    LAUNCHES[name] += 1


def _kernel_query(qhead, head_scales, head):
    """``head_wgmma.cu``'s query operand for this head: the scaled bf16
    query, in the int8 kernels' column order for an int8 head."""
    q = scaled_query(qhead, head_scales, logical_width(head))
    return q if head.dtype == torch.uint8 else i8_kernel_query(q)


def masked_head_scores(
    head: torch.Tensor,  # (R, F) int8
    head_scales: torch.Tensor,  # (F,) f32
    qhead: torch.Tensor,  # (B, F) f32 query weights
    valid: torch.Tensor,  # (R,) bool
) -> torch.Tensor:
    """(B, R) f32 masked head scores of an int8 head (K1 on CUDA; bit for
    bit the scores of :func:`masked_head_scores_blockmax` there).

    int8 only, like ``osr_tpu``'s ``masked_head_scores``: an int4 head
    goes through :func:`masked_head_scores_blockmax`."""
    if head.dtype == torch.uint8:
        raise ValueError(
            "masked_head_scores has no int4 kernel; use "
            "masked_head_scores_blockmax"
        )
    if head.device.type == "cpu":
        return masked_head_scores_plain(head, head_scales, qhead, valid)
    if head.device.type != "cuda":
        raise ValueError(f"no kernel for device {head.device}")
    _check_operands(head, head_scales, qhead, valid)
    with torch.cuda.device(head.device):
        q = _kernel_query(qhead, head_scales, head)
        out = torch.empty(
            (q.shape[0], head.shape[0]), dtype=torch.float32,
            device=head.device,
        )
        _launch(
            "head_wgmma", "osr_head_i8_scores", "head_scores_i8",
            head.device, q.data_ptr(), head.data_ptr(), valid.data_ptr(),
            out.data_ptr(), q.shape[0], head.shape[0], head.shape[1],
        )
    return out


def masked_head_scores_blockmax(
    head: torch.Tensor,  # (R, F) int8 or (R, F/2) uint8 int4-packed
    head_scales: torch.Tensor,  # (F,) f32
    qhead: torch.Tensor,  # (B, F) f32 query weights
    valid: torch.Tensor,  # (R,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((B, R) f32 masked scores, (B, G) f32 block maxima), G = ceil(R /
    128); block g covers rows [128 g, 128 g + 128) and rows beyond R are
    -inf (K2 for int8, K3 for int4 on CUDA). The maxima are a transposed
    view of the kernel's (G, B) output."""
    if head.device.type == "cpu":
        return masked_head_scores_blockmax_plain(
            head, head_scales, qhead, valid
        )
    if head.device.type != "cuda":
        raise ValueError(f"no kernel for device {head.device}")
    _check_operands(head, head_scales, qhead, valid)
    dtype = "i4" if head.dtype == torch.uint8 else "i8"
    with torch.cuda.device(head.device):
        q = _kernel_query(qhead, head_scales, head)
        b, r = q.shape[0], head.shape[0]
        g = -(-r // ROW_TILE)
        out = torch.empty((b, r), dtype=torch.float32, device=head.device)
        bmax = torch.empty((g, b), dtype=torch.float32, device=head.device)
        _launch(
            "head_wgmma", f"osr_head_{dtype}_blockmax",
            f"head_blockmax_{dtype}", head.device, q.data_ptr(),
            head.data_ptr(), valid.data_ptr(), out.data_ptr(),
            bmax.data_ptr(), b, r, head.shape[1],
        )
    return out, bmax.T


def masked_head_blocktopm(
    head: torch.Tensor,  # (R, F) int8 or (R, F/2) uint8 int4-packed
    head_scales: torch.Tensor,  # (F,) f32
    qhead: torch.Tensor,  # (B, F) f32 query weights
    valid: torch.Tensor,  # (R,) bool
    m: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((B, G, m) f32 values, (B, G, m) int32 rows), G = ceil(R / 128): each
    128-row block's m largest masked scores in descending order, ties to
    the lower row, rows counted from 0 (K4 on CUDA, for m up to
    ``BLOCKTOPM_MAX_M``). Rows past R are -inf; the row of a -inf value
    is the next free row of its block, as a stable sort orders them."""
    if not 1 <= m <= ROW_TILE:
        raise ValueError(f"m must be in [1, {ROW_TILE}], got {m}")
    if head.device.type == "cpu":
        return masked_head_blocktopm_plain(
            head, head_scales, qhead, valid, m
        )
    if head.device.type != "cuda":
        raise ValueError(f"no kernel for device {head.device}")
    if m > BLOCKTOPM_MAX_M:
        raise ValueError(
            f"the block top-m kernel takes m <= {BLOCKTOPM_MAX_M}, got {m}"
        )
    _check_operands(head, head_scales, qhead, valid)
    dtype = "i4" if head.dtype == torch.uint8 else "i8"
    with torch.cuda.device(head.device):
        q = _kernel_query(qhead, head_scales, head)
        b, r = q.shape[0], head.shape[0]
        g = -(-r // ROW_TILE)
        vals = torch.empty((b, g, m), dtype=torch.float32, device=head.device)
        rows = torch.empty((b, g, m), dtype=torch.int32, device=head.device)
        _launch(
            "head_wgmma", f"osr_head_{dtype}_blocktopm",
            f"head_blocktopm_{dtype}", head.device, q.data_ptr(),
            head.data_ptr(), valid.data_ptr(), vals.data_ptr(),
            rows.data_ptr(), b, r, head.shape[1], m,
        )
    return vals, rows
