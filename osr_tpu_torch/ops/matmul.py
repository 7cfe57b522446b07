"""Quantized dense similarity: the hand-written Hopper kernels and their
plain PyTorch versions (counterpart of ``osr_tpu/ops/pallas/matmul.py``).

Both compute the dequantized (B, N) f32 similarity of int8 queries with an
int8 corpus (K5) or an int4 corpus of signed nibbles (K6):
``(float(q8 @ d8.T) * q_scales[:, None]) * d_scales[None, :]``, the
integer sum exact and the two multiplies in that order.

Wrappers, each with its plain version beside it:

- :func:`int8_similarity` launches K5 on a CUDA tensor. Replaces
  ``osr_tpu/ops/pallas/matmul.py:_kernel`` (via ``int8_similarity_pallas``).
- :func:`int4_similarity` launches K6. Replaces ``_kernel_i4`` (via
  ``int4_similarity_pallas``).
- :func:`int8_similarity_blockmax` and :func:`int4_similarity_blockmax`
  launch the same kernels with their block maxima: K5/K6's epilogue also
  writes the (B, G) maximum of each 128-column block, G = ceil(N / 128),
  what ``topk.block_max`` takes of the scores, so the exact selection
  (``topk.block_topk_from_max``) never re-reads the (B, N) matrix for it.

Both kernels are one template in ``csrc/similarity_wgmma.cu``, on the
corpus dtype: one persistent block per SM walks the (128 x 128) output
tiles; a TMA ring feeds integer ``wgmma`` (K5 reads both operands from
shared memory; K6 decodes the corpus nibbles into its register operand),
and each tile leaves through a shared staging tile and a TMA store that
overlaps the next tile's main loop. At the dense path's shape (B=1,024,
N=1,000,000, D=768) on an H100 both are bound by bytes: the (B, N) f32
output alone is 4.10 GB, 1.22 ms of the 1.45 ms (int8) or 1.34 ms (int4)
bound, against 0.79 ms of int8 tensor-core work. Design notes at the top
of the source.

TMA needs 16-byte row strides and bases. So :func:`int8_kernel_operands`
zero-pads the corpus and the queries to D rounded up to 16 where D is not
a multiple of 16, and :func:`int4_kernel_operands` pads a packed width
D/2 off 16 bytes and places the query's high half at the padded offset; a
base off 16 bytes is copied too. Zero columns leave the integer sums
unchanged. Each copy is a per-call copy, counted in ``PAD_COPIES``; every
width D (K5) and every even D (K6) is taken.

The plain versions compute the integer products in float64, exact while
the sums stay below 2^53 (PyTorch has no integer matrix product on CUDA).
A wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. ``LAUNCHES`` counts kernel
launches (plain calls are not counted): ``int8_similarity`` every K5
launch, ``int8_similarity_blockmax`` those of them that wrote the block
maxima too (K6 likewise).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from osr_tpu_torch.ops.topk import block_max

LAUNCHES: Dict[str, int] = {
    "int8_similarity": 0,  # K5
    "int4_similarity": 0,  # K6
    "int8_similarity_blockmax": 0,  # K5 launches that wrote block maxima
    "int4_similarity_blockmax": 0,  # K6 likewise
}
# Operand copies the K5 and K6 wrappers made (int8_kernel_operands,
# int4_kernel_operands): the padded corpus, and the padded (K6: placed)
# query.
PAD_COPIES: Dict[str, int] = {"corpus": 0, "query": 0}
TMA_ALIGN = 16  # the operands' row-width and base alignment, in bytes


def reset_launches() -> None:
    """Set the launch counts and the operand-copy counts to 0."""
    for counts in (LAUNCHES, PAD_COPIES):
        for name in counts:
            counts[name] = 0


# ----------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ----------------------------------------------------------------------


def unpack_int4_signed(packed: torch.Tensor) -> torch.Tensor:
    """Decode block-packed signed int4 (low nibble of byte c is column c,
    high nibble column c + W) to (..., 2 W) int8 codes: ``((v & 0xF) ^ 8)
    - 8`` sign-extends a two's-complement nibble."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, D) x (N, D) integer codes -> (B, N) int32 sums of products,
    exact (float64 products and sums of 8-bit codes are exact)."""
    return (a.double() @ b.double().T).to(torch.int32)


def int8_similarity_plain(q8, d8, q_scales, d_scales) -> torch.Tensor:
    """Plain twin of K5: (B, N) f32 ``(acc * q_scales) * d_scales``."""
    acc = exact_matmul(q8, d8)
    return acc.float() * q_scales[:, None] * d_scales[None, :]


def int4_similarity_plain(q8, d_packed, q_scales, d_scales) -> torch.Tensor:
    """Plain twin of K6: K5's plain version on the decoded corpus."""
    return int8_similarity_plain(
        q8, unpack_int4_signed(d_packed), q_scales, d_scales
    )


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------


def _check_operands(q8, docs, q_scales, d_scales, int4: bool) -> None:
    dev = q8.device
    for name, t in (("docs", docs), ("q_scales", q_scales),
                    ("d_scales", d_scales)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q8 on {dev}")
    want = torch.uint8 if int4 else torch.int8
    if q8.dtype != torch.int8 or q8.dim() != 2:
        raise ValueError(
            f"q8 must be a 2-D int8 tensor, got {q8.dtype} {tuple(q8.shape)}"
        )
    if docs.dtype != want or docs.dim() != 2:
        raise ValueError(
            f"docs must be a 2-D {want} tensor, got {docs.dtype} "
            f"{tuple(docs.shape)}"
        )
    width = 2 * docs.shape[1] if int4 else docs.shape[1]
    if width != q8.shape[1]:
        raise ValueError(
            f"docs hold {width} logical columns, q8 {q8.shape[1]}"
        )
    for name, t, n in (("q_scales", q_scales, q8.shape[0]),
                       ("d_scales", d_scales, docs.shape[0])):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(
                f"{name} must be a ({n},) float32 tensor, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    for name, t in (("q8", q8), ("docs", docs), ("q_scales", q_scales),
                    ("d_scales", d_scales)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(q8.shape[0], docs.shape[0], q8.shape[1]) >= 2**31:
        raise ValueError("kernel dimensions must fit int32")


def _round_up(width: int) -> int:
    return -(-width // TMA_ALIGN) * TMA_ALIGN


def _needs_copy(t: torch.Tensor, width: int, padded: int) -> bool:
    return padded != width or t.data_ptr() % TMA_ALIGN != 0


def _zero_padded(t: torch.Tensor, width: int) -> torch.Tensor:
    """A (rows, width) zero copy of t with t's columns first."""
    out = t.new_zeros((t.shape[0], width))
    out[:, : t.shape[1]] = t
    return out


def int8_kernel_operands(q8: torch.Tensor, d8: torch.Tensor):
    """K5's operands: ((B, DP) int8 queries, (N, DP) int8 corpus, DP), DP
    the width D rounded up to ``TMA_ALIGN``.

    Both are zero-padded to DP columns, so the integer sums are unchanged.
    At DP = D with 16-byte aligned bases the operands are the inputs
    themselves; otherwise each copy is counted in ``PAD_COPIES``."""
    d = d8.shape[1]
    dp = _round_up(d)
    if _needs_copy(d8, d, dp):
        d8 = _zero_padded(d8, dp)
        PAD_COPIES["corpus"] += 1
    if _needs_copy(q8, d, dp):
        q8 = _zero_padded(q8, dp)
        PAD_COPIES["query"] += 1
    return q8, d8, dp


def int4_kernel_operands(q8: torch.Tensor, d_packed: torch.Tensor):
    """K6's operands: ((B, 2 HP) int8 queries, (N, HP) uint8 corpus, HP),
    HP the packed width D/2 rounded up to ``TMA_ALIGN``.

    The corpus is zero-padded to HP bytes a row (a zero byte decodes to
    two 0 codes), and the queries' columns [D/2, D) move to [HP, HP + D/2)
    to meet the padded corpus's high nibbles, zeros elsewhere; so the
    integer sums are unchanged. At HP = D/2 with 16-byte aligned bases the
    operands are the inputs themselves; otherwise each copy is counted in
    ``PAD_COPIES``."""
    h = d_packed.shape[1]
    hp = _round_up(h)
    if _needs_copy(d_packed, h, hp):
        d_packed = _zero_padded(d_packed, hp)
        PAD_COPIES["corpus"] += 1
    if _needs_copy(q8, h, hp):
        placed = q8.new_zeros((q8.shape[0], 2 * hp))
        placed[:, :h] = q8[:, :h]
        placed[:, hp : hp + h] = q8[:, h:]
        q8 = placed
        PAD_COPIES["query"] += 1
    return q8, d_packed, hp


def _similarity(q8, docs, q_scales, d_scales, int4: bool, blockmax: bool):
    """The (B, N) scores, and with ``blockmax`` their (B, G) block
    maxima beside them."""
    name = "int4_similarity" if int4 else "int8_similarity"
    if q8.device.type == "cpu":
        plain = int4_similarity_plain if int4 else int8_similarity_plain
        out = plain(q8, docs, q_scales, d_scales)
        return (out, block_max(out)) if blockmax else out
    if q8.device.type != "cuda":
        raise ValueError(f"no kernel for device {q8.device}")
    _check_operands(q8, docs, q_scales, d_scales, int4)
    b, n = q8.shape[0], docs.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=q8.device)
    # The kernel writes the maxima (G, B), a tile's 128 queries contiguous;
    # the caller gets the (B, G) view.
    maxima = (
        torch.empty((-(-n // 128), b), dtype=torch.float32, device=q8.device)
        if blockmax else None
    )
    if out.numel() == 0:
        return (out, maxima.T) if blockmax else out
    from osr_tpu_torch.ops import _build

    with torch.cuda.device(q8.device):
        stream = torch.cuda.current_stream(q8.device).cuda_stream
        lib = _build.library("similarity_wgmma")
        if int4:
            q, d, width = int4_kernel_operands(q8, docs)
        else:
            q, d, width = int8_kernel_operands(q8, docs)
        ptrs = [q.data_ptr(), d.data_ptr(), q_scales.data_ptr(),
                d_scales.data_ptr(), out.data_ptr()]
        entry = "osr_similarity_" + ("i4" if int4 else "i8")
        if blockmax:
            entry += "_blockmax"
            ptrs.append(maxima.data_ptr())
        code = getattr(lib, entry)(*ptrs, b, n, width, stream)
        _build.check(lib, code, name)
    LAUNCHES[name] += 1
    if blockmax:
        LAUNCHES[name + "_blockmax"] += 1
        return out, maxima.T
    return out


def int8_similarity(
    q8: torch.Tensor,  # (B, D) int8
    d8: torch.Tensor,  # (N, D) int8
    q_scales: torch.Tensor,  # (B,) f32
    d_scales: torch.Tensor,  # (N,) f32
) -> torch.Tensor:
    """(B, N) f32 dequantized similarity of an int8 corpus (K5 on CUDA)."""
    return _similarity(q8, d8, q_scales, d_scales, int4=False, blockmax=False)


def int4_similarity(
    q8: torch.Tensor,  # (B, D) int8
    d_packed: torch.Tensor,  # (N, D/2) uint8, signed nibbles, block-packed
    q_scales: torch.Tensor,  # (B,) f32
    d_scales: torch.Tensor,  # (N,) f32
) -> torch.Tensor:
    """(B, N) f32 dequantized similarity of an int4 corpus (K6 on CUDA)."""
    return _similarity(q8, d_packed, q_scales, d_scales, int4=True,
                       blockmax=False)


def int8_similarity_blockmax(
    q8: torch.Tensor,  # (B, D) int8
    d8: torch.Tensor,  # (N, D) int8
    q_scales: torch.Tensor,  # (B,) f32
    d_scales: torch.Tensor,  # (N,) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((B, N) f32 similarity, (B, G) f32 maxima of its 128-column
    blocks), G = ceil(N / 128): K5 writing both on CUDA (the maxima a
    transposed view of the kernel's (G, B) array); on the CPU the plain
    scores and ``topk.block_max`` of them."""
    return _similarity(q8, d8, q_scales, d_scales, int4=False, blockmax=True)


def int4_similarity_blockmax(
    q8: torch.Tensor,  # (B, D) int8
    d_packed: torch.Tensor,  # (N, D/2) uint8, signed nibbles, block-packed
    q_scales: torch.Tensor,  # (B,) f32
    d_scales: torch.Tensor,  # (N,) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_similarity_blockmax` of an int4 corpus (K6 on CUDA)."""
    return _similarity(q8, d_packed, q_scales, d_scales, int4=True,
                       blockmax=True)
