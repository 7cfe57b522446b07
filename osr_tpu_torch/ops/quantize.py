"""Embedding quantization and quantized dense search (counterpart of
``osr_tpu/ops/quantize.py``).

- symmetric per-row int8: absmax -> codes in [-127, 127], scale absmax/127;
- per-row and per-(row, column-group) int4, two signed codes per byte,
  block-packed (low nibble of byte c is column c, high nibble c + D/2);
- asymmetric per-row uint8: [min, max] -> [0, 255] with a zero offset;
- dense search: quantize the queries, score, exact top-k.

:func:`quantize_symmetric` and :func:`dequantize_symmetric` go through the
wrappers of ``ops/quantize_kernels.py``: a CUDA tensor launches K7 / K8,
a CPU tensor takes their plain versions. Everything else here is plain
PyTorch on any device, as ``osr_tpu`` leaves it to XLA. Integer products
are exact (``ops/matmul.py:exact_matmul``) and float32 products run with
TF32 off. ``osr_tpu``'s XLA evaluates a division by a constant (``/ 127``,
``/ 7``, ``/ 255``) as a multiply by its f32 reciprocal; K7, its plain
version and the plain quantizers here do the same
(``quantize_kernels.recip_mul``), so their codes and scales equal
``osr_tpu``'s bit for bit. The NumPy twins divide, as ``osr_tpu``'s own
do: their scales may differ from the device quantizers' by one ulp.

Results travel as (f32 values, int32 ids): ``osr_tpu``'s f32-packed result
(``_pack_result``) is a transfer workaround the port does not carry.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from osr_tpu_torch.ops import quantize_kernels as qk
from osr_tpu_torch.ops.head import f32_matmul
from osr_tpu_torch.ops.matmul import (
    exact_matmul,
    int8_similarity_plain,
    unpack_int4_signed,
)
from osr_tpu_torch.ops.topk import block_topk, topk

_EPS = qk.EPS
# Candidate widths from which selection takes the block-pruned path.
BLOCK_SELECT_MIN_COLS = 16 * 128


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


# ----------------------------------------------------------------------
# Quantizers
# ----------------------------------------------------------------------


def quantize_symmetric(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: (values int8 (..., D), scales
    f32 (...)) with ``x ~= values * scales[..., None]`` (K7 on CUDA)."""
    values, scales = qk.quantize_symmetric(_as_rows(x.float()))
    return values.reshape(x.shape), scales.reshape(x.shape[:-1])


def dequantize_symmetric(
    values: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """``values * scales[..., None]`` in f32 (K8 on CUDA)."""
    out = qk.dequantize_symmetric(
        _as_rows(values), scales.reshape(-1).float().contiguous()
    )
    return out.reshape(values.shape)


def _pack_int4(codes: torch.Tensor) -> torch.Tensor:
    half = codes.shape[-1] // 2
    lo = codes[..., :half] & 0xF
    hi = codes[..., half:] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def quantize_symmetric_int4(
    x: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int4 quantization, block-packed two codes a byte:
    (packed uint8 (..., D/2), scales f32 (...)) with ``x ~=
    unpack_int4_signed(packed) * scales[..., None]``. Codes are signed
    nibbles in [-7, 7] (two's complement); D must be even."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"int4 packing needs an even dim (got {d})")
    x = x.float()
    absmax = x.abs().amax(dim=-1).clamp_min(_EPS)
    scales = qk.recip_mul(absmax, 7.0)
    codes = torch.round(x / scales[..., None]).clamp(-7, 7).to(torch.int32)
    return _pack_int4(codes), scales


def quantize_symmetric_int4_grouped(
    x: torch.Tensor, *, group_size: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, column-group) symmetric int4 quantization: one absmax per
    ``group_size`` contiguous columns. Returns (packed uint8 (N, D/2),
    scales f32 (N, D/group_size)), packed as
    :func:`quantize_symmetric_int4`. D must be even and divisible by
    ``group_size``."""
    d = x.shape[-1]
    if d % 2 or d % group_size:
        raise ValueError(
            f"dim {d} must be even and divisible by group_size="
            f"{group_size}"
        )
    g = d // group_size
    xg = x.float().reshape(*x.shape[:-1], g, group_size)
    absmax = xg.abs().amax(dim=-1).clamp_min(_EPS)
    scales = qk.recip_mul(absmax, 7.0)
    codes = (
        torch.round(xg / scales[..., None])
        .clamp(-7, 7)
        .to(torch.int32)
        .reshape(*x.shape[:-1], d)
    )
    return _pack_int4(codes), scales


def quantize_asymmetric(
    x: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row asymmetric uint8 quantization: (values uint8 (..., D),
    scales f32 (...), mins f32 (...)) with ``x ~= values * scales + mins``
    per row."""
    x = x.float()
    mins = x.amin(dim=-1)
    maxs = x.amax(dim=-1)
    scales = qk.recip_mul(maxs - mins, 255.0).clamp_min(_EPS)
    values = torch.round(
        (x - mins[..., None]) / scales[..., None]
    ).clamp(0, 255).to(torch.uint8)
    return values, scales, mins


def dequantize_asymmetric(
    values: torch.Tensor, scales: torch.Tensor, mins: torch.Tensor
) -> torch.Tensor:
    """``values * scales + mins`` per row in f32, as one fused
    multiply-add per element, as ``osr_tpu``'s XLA fuses it on the CPU."""
    return torch.addcmul(mins[..., None], values.float(), scales[..., None])


# NumPy twins for host-side pre-quantization
# (DenseSearchEngine.from_quantized): at corpus scale the f32 matrix never
# has to exist on the device. Identical to osr_tpu's.


def quantize_symmetric_np(x) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy twin of :func:`quantize_symmetric`."""
    x = np.asarray(x, np.float32)
    absmax = np.maximum(np.abs(x).max(axis=-1), _EPS)
    scales = (absmax / 127.0).astype(np.float32)
    values = np.round(x / scales[..., None]).astype(np.int8)
    return values, scales


def _pack_int4_np(codes: np.ndarray) -> np.ndarray:
    half = codes.shape[-1] // 2
    lo = codes[..., :half] & 0xF
    hi = codes[..., half:] & 0xF
    return (lo | (hi << 4)).astype(np.uint8)


def quantize_symmetric_int4_np(x) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy twin of :func:`quantize_symmetric_int4`."""
    x = np.asarray(x, np.float32)
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"int4 packing needs an even dim (got {d})")
    absmax = np.maximum(np.abs(x).max(axis=-1), _EPS)
    scales = (absmax / 7.0).astype(np.float32)
    codes = np.clip(np.round(x / scales[..., None]), -7, 7).astype(np.int32)
    return _pack_int4_np(codes), scales


def quantize_symmetric_int4_grouped_np(
    x, *, group_size: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy twin of :func:`quantize_symmetric_int4_grouped`."""
    x = np.asarray(x, np.float32)
    d = x.shape[-1]
    if d % 2 or d % group_size:
        raise ValueError(
            f"dim {d} must be even and divisible by group_size="
            f"{group_size}"
        )
    g = d // group_size
    xg = x.reshape(*x.shape[:-1], g, group_size)
    absmax = np.maximum(np.abs(xg).max(axis=-1), _EPS)
    scales = (absmax / 7.0).astype(np.float32)
    codes = (
        np.clip(np.round(xg / scales[..., None]), -7, 7)
        .astype(np.int32)
        .reshape(*x.shape[:-1], d)
    )
    return _pack_int4_np(codes), scales


# ----------------------------------------------------------------------
# Similarity
# ----------------------------------------------------------------------


def int8_matmul(q_int8: torch.Tensor, d_int8: torch.Tensor) -> torch.Tensor:
    """(B, D) x (N, D) integer codes -> (B, N) int32, exact."""
    return exact_matmul(q_int8, d_int8)


def int8_dot_product_batch(
    q_int8: torch.Tensor,
    d_int8: torch.Tensor,
    q_scales: torch.Tensor,
    d_scales: torch.Tensor,
) -> torch.Tensor:
    """Dequantized similarity matrix (B, N) f32: the exact integer product
    and the rank-1 rescale (K5's plain version)."""
    return int8_similarity_plain(q_int8, d_int8, q_scales, d_scales)


def int8_cosine_similarity(
    q_int8: torch.Tensor,
    d_int8: torch.Tensor,
    q_scales: torch.Tensor,
    d_scales: torch.Tensor,
) -> torch.Tensor:
    """Cosine similarity from int8 inputs: the dequantized dot over the
    product of the dequantized norms."""
    dots = int8_dot_product_batch(q_int8, d_int8, q_scales, d_scales)
    qn = torch.linalg.vector_norm(
        q_int8.float() * q_scales[:, None], dim=-1
    )
    dn = torch.linalg.vector_norm(
        d_int8.float() * d_scales[:, None], dim=-1
    )
    return dots / torch.clamp_min(qn[:, None] * dn[None, :], _EPS)


# ----------------------------------------------------------------------
# Search: (B, k) f32 scores and int32 doc rows, ties to the lower row
# ----------------------------------------------------------------------


def _select_topk(
    sims: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the similarity matrix: block-max-pruned at 2,048
    columns and more, one stable sort below (``osr_tpu``'s crossover)."""
    kk = min(k, sims.shape[-1])
    if sims.shape[-1] >= BLOCK_SELECT_MIN_COLS:
        return block_topk(sims, k=kk)
    return topk(sims, k=kk)


def int8_scores_symmetric(
    queries_fp32: torch.Tensor,  # (B, D)
    docs_int8: torch.Tensor,  # (N, D) int8
    doc_scales: torch.Tensor,  # (N,)
) -> torch.Tensor:
    """The (B, N) f32 scores of :func:`int8_search_symmetric`."""
    q_int8, q_scales = quantize_symmetric(queries_fp32)
    return int8_dot_product_batch(q_int8, docs_int8, q_scales, doc_scales)


def int8_search_symmetric(
    queries_fp32: torch.Tensor,  # (B, D)
    docs_int8: torch.Tensor,  # (N, D) int8
    doc_scales: torch.Tensor,  # (N,)
    *,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize the queries symmetrically, score exactly, top-k."""
    return _select_topk(
        int8_scores_symmetric(queries_fp32, docs_int8, doc_scales), k
    )


def int4_scores_symmetric(
    queries_fp32: torch.Tensor,  # (B, D)
    docs_packed: torch.Tensor,  # (N, D/2) uint8, signed nibbles
    doc_scales: torch.Tensor,  # (N,)
) -> torch.Tensor:
    """The (B, N) f32 scores of :func:`int4_search_symmetric`."""
    q_int8, q_scales = quantize_symmetric(queries_fp32)
    return int8_dot_product_batch(
        q_int8, unpack_int4_signed(docs_packed), q_scales, doc_scales
    )


def int4_search_symmetric(
    queries_fp32: torch.Tensor,  # (B, D)
    docs_packed: torch.Tensor,  # (N, D/2) uint8, signed nibbles
    doc_scales: torch.Tensor,  # (N,)
    *,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int4 corpus search: int8 queries against the decoded corpus."""
    return _select_topk(
        int4_scores_symmetric(queries_fp32, docs_packed, doc_scales), k
    )


def int4_search_symmetric_grouped(
    queries_fp32: torch.Tensor,  # (B, D)
    docs_packed: torch.Tensor,  # (N, D/2) uint8, signed nibbles
    doc_scales: torch.Tensor,  # (N, G) per-(row, group) scales
    *,
    k: int,
    group_size: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise int4 search (:func:`int4_scores_symmetric_grouped`),
    top-k."""
    return _select_topk(
        int4_scores_symmetric_grouped(
            queries_fp32, docs_packed, doc_scales, group_size=group_size
        ),
        k,
    )


def int4_scores_symmetric_grouped(
    queries_fp32: torch.Tensor,  # (B, D)
    docs_packed: torch.Tensor,  # (N, D/2) uint8, signed nibbles
    doc_scales: torch.Tensor,  # (N, G) per-(row, group) scales
    *,
    group_size: int = 128,
) -> torch.Tensor:
    """Group-wise int4 scores, (B, N) f32. Per-group doc scales do not
    fold into a rank-1 epilogue, so the contraction runs per group, (G, B,
    Dg) x (G, N, Dg) -> (G, B, N) in f32, then sum_g acc[g] * scales[:,
    g]. Queries round to bf16, as ``osr_tpu`` rounds them."""
    b, d = queries_fp32.shape
    g = d // group_size
    codes = unpack_int4_signed(docs_packed)
    n = codes.shape[0]
    qg = (
        queries_fp32.to(torch.bfloat16).float()
        .reshape(b, g, group_size).transpose(0, 1)
    )
    cg = codes.float().reshape(n, g, group_size).transpose(0, 1)
    with f32_matmul():
        acc = torch.bmm(qg, cg.transpose(1, 2))  # (G, B, N)
        return torch.einsum("gbn,ng->bn", acc, doc_scales.float())


def int8_search_asymmetric(
    queries_fp32: torch.Tensor,  # (B, D)
    docs_u8: torch.Tensor,  # (N, D) uint8
    doc_scales: torch.Tensor,  # (N,)
    doc_mins: torch.Tensor,  # (N,)
    *,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric quantized search (:func:`int8_scores_asymmetric`),
    top-k."""
    return _select_topk(
        int8_scores_asymmetric(queries_fp32, docs_u8, doc_scales, doc_mins), k
    )


def int8_scores_asymmetric(
    queries_fp32: torch.Tensor,  # (B, D)
    docs_u8: torch.Tensor,  # (N, D) uint8
    doc_scales: torch.Tensor,  # (N,)
    doc_mins: torch.Tensor,  # (N,)
) -> torch.Tensor:
    """Asymmetric quantized scores, (B, N) f32. With q = uq*qs + qm and
    d = ud*ds + dm per row, q.d expands into one exact integer product
    plus rank-1 terms:

        q.d = qs*ds*(uq.ud) + qs*dm*sum(uq) + ds*qm*sum(ud) + D*qm*dm
    """
    dim = queries_fp32.shape[-1]
    uq, qs, qm = quantize_asymmetric(queries_fp32)
    acc = exact_matmul(uq, docs_u8).float()
    sum_uq = uq.float().sum(dim=-1)  # (B,), exact below 2^24
    sum_ud = docs_u8.float().sum(dim=-1)  # (N,)
    return (
        acc * qs[:, None] * doc_scales[None, :]
        + (qs * sum_uq)[:, None] * doc_mins[None, :]
        + qm[:, None] * (doc_scales * sum_ud)[None, :]
        + dim * qm[:, None] * doc_mins[None, :]
    )


def fp_scores(queries: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """Full-precision scores: one f32 product (TF32 off), (B, N)."""
    with f32_matmul():
        return queries.float() @ docs.float().T


def fp_search(
    queries: torch.Tensor, docs: torch.Tensor, *, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-precision dense search: :func:`fp_scores`, top-k."""
    return _select_topk(fp_scores(queries, docs), k)
