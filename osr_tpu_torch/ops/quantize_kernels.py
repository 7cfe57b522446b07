"""Per-row symmetric int8 quantization and dequantization: the
hand-written Hopper kernels and their plain PyTorch versions (counterpart
of ``osr_tpu/ops/pallas/quantize.py``).

- :func:`quantize_symmetric` launches K7 on a CUDA tensor: ``scale =
  max(absmax, 1e-8) * f32(1/127)`` per row, then codes ``round(x / scale)``
  (half to even), or, with ``stochastic=True``, ``floor(s) + (u <
  frac(s))`` clipped to [-127, 127]. Replaces
  ``osr_tpu/ops/pallas/quantize.py:_quant_kernel`` and
  ``_quant_kernel_stochastic`` (via ``quantize_symmetric_pallas``).
- :func:`dequantize_symmetric` launches K8: ``values * scale[row]``.
  Replaces ``_dequant_kernel`` (via ``dequantize_symmetric_pallas``).

Both live in ``csrc/quantize.cu``. They are bound by bytes: at 1M x 768 on
an H100 each moves 3.84 GB, 1.15 ms at 3.35 TB/s. Each gives a row to one
warp. K8 runs one wave of blocks whose warps walk rows at the grid's warp
stride; lane l converts the 4 codes of word l + 32 i (one 32-bit load,
one streaming f32 x 4 store), so each warp store instruction writes 512
contiguous bytes; a width off 4 codes, or a base off 4 (values) or 16
(output) bytes, takes a scalar loop of the same arithmetic.

Stochastic rounding cannot reproduce the TPU's per-core PRNG. Its 32 bits
per element come from a counter-based hash of (seed, row, column),
:func:`stochastic_bits`, which the kernel and the plain version compute
alike, so the two agree bit for bit. The seed is the caller's, or is drawn
from an explicit ``torch.Generator``.

The scale is ``osr_tpu``'s as its XLA computes ``absmax / 127.0``: a
multiply by the reciprocal of 127 rounded to f32 (:func:`recip_mul`), on
both sides. The codes divide by the scale tensor, an IEEE division on
both sides, as XLA divides by a tensor. So codes and scales equal the
kernel's and ``osr_tpu``'s bit for bit. A
wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. ``LAUNCHES`` counts kernel
launches (plain calls are not counted).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

EPS = 1e-8
_M32 = 0xFFFFFFFF
_PLAIN_ROWS = 1 << 16  # rows per slice of the plain stochastic version

LAUNCHES: Dict[str, int] = {
    "quantize_symmetric": 0,  # K7
    "quantize_symmetric_stochastic": 0,  # K7, stochastic rounding
    "dequantize_symmetric": 0,  # K8
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ----------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), in two 16-bit halves of
    c so that no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's fmix32 finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def stochastic_bits(
    seed: int, rows: torch.Tensor, cols: torch.Tensor
) -> torch.Tensor:
    """(len(rows), len(cols)) int64 tensor of the 32 random bits of each
    element: ``fmix32(fmix32(seed ^ row * 0x9E3779B1) ^ col)`` mod 2^32,
    as ``csrc/quantize.cu`` computes them."""
    key = _fmix32((seed & _M32) ^ _mul32(rows.long() & _M32, 0x9E3779B1))
    return _fmix32(key[:, None] ^ (cols.long() & _M32)[None, :])


def recip_mul(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as ``osr_tpu``'s XLA evaluates it for a constant c: ``x``
    times the reciprocal of c rounded to f32."""
    return x * float(np.float32(1.0) / np.float32(c))


def row_scales(x: torch.Tensor) -> torch.Tensor:
    """(N,) f32 ``max(absmax, 1e-8) * f32(1/127)`` of each row."""
    return recip_mul(x.abs().amax(dim=-1).clamp_min(EPS), 127.0)


def quantize_symmetric_plain(
    x: torch.Tensor, *, stochastic: bool = False, seed: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K7: ((N, D) int8 codes, (N,) f32 scales)."""
    scales = row_scales(x)
    if not stochastic:
        return torch.round(x / scales[:, None]).to(torch.int8), scales
    values = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    cols = torch.arange(x.shape[1], device=x.device)
    for r0 in range(0, x.shape[0], _PLAIN_ROWS):
        r1 = min(r0 + _PLAIN_ROWS, x.shape[0])
        s = x[r0:r1] / scales[r0:r1, None]
        fl = torch.floor(s)
        rows = torch.arange(r0, r1, device=x.device)
        u = (stochastic_bits(seed, rows, cols) >> 8).float() * 2.0**-24
        rounded = fl + (u < s - fl).float()
        values[r0:r1] = rounded.clamp(-127.0, 127.0).to(torch.int8)
    return values, scales


def dequantize_symmetric_plain(
    values: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """Plain twin of K8: (N, D) f32 ``values * scales[:, None]``."""
    return values.float() * scales[:, None]


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------


def _check_2d(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype != dtype or t.dim() != 2:
        raise ValueError(
            f"{name} must be a 2-D {dtype} tensor, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.shape[1] < 1:
        raise ValueError(f"{name} has no columns")
    if max(t.shape) >= 2**31:
        raise ValueError("kernel dimensions must fit int32")


def _lib():
    from osr_tpu_torch.ops import _build

    return _build, _build.library("quantize")


def quantize_symmetric(
    x: torch.Tensor,  # (N, D) f32
    *,
    stochastic: bool = False,
    seed: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: ((N, D) int8, (N,) f32), with
    ``x ~= values * scales[:, None]`` (K7 on CUDA).

    ``stochastic=True`` rounds up with probability frac(x / scale), from
    ``seed``, or, when it is None, from a seed drawn from ``generator``
    (the default CPU generator when that is None too)."""
    if stochastic and seed is None:
        seed = int(
            torch.randint(
                0, 2**32, (1,), generator=generator,
                device=generator.device if generator is not None else None,
            ).item()
        )
    seed = 0 if seed is None else int(seed) & _M32
    if x.device.type == "cpu":
        return quantize_symmetric_plain(x, stochastic=stochastic, seed=seed)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_2d("x", x, torch.float32)
    name = "quantize_symmetric_stochastic" if stochastic else (
        "quantize_symmetric"
    )
    n, d = x.shape
    values = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return values, scales
    build, lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.osr_quantize_symmetric(
            x.data_ptr(), values.data_ptr(), scales.data_ptr(), n, d,
            int(stochastic), seed,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        build.check(lib, code, name)
    LAUNCHES[name] += 1
    return values, scales


def dequantize_symmetric(
    values: torch.Tensor,  # (N, D) int8
    scales: torch.Tensor,  # (N,) f32
) -> torch.Tensor:
    """(N, D) f32 ``values * scales[:, None]`` (K8 on CUDA)."""
    if values.device.type == "cpu":
        return dequantize_symmetric_plain(values, scales)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    _check_2d("values", values, torch.int8)
    n, d = values.shape
    if scales.device != values.device:
        raise ValueError(f"scales are on {scales.device}, values on "
                         f"{values.device}")
    if scales.dtype != torch.float32 or scales.shape != (n,):
        raise ValueError(
            f"scales must be a ({n},) float32 tensor, got {scales.dtype} "
            f"{tuple(scales.shape)}"
        )
    if not scales.is_contiguous():
        raise ValueError("scales must be contiguous")
    out = torch.empty((n, d), dtype=torch.float32, device=values.device)
    if n == 0:
        return out
    build, lib = _lib()
    with torch.cuda.device(values.device):
        code = lib.osr_dequantize_symmetric(
            values.data_ptr(), scales.data_ptr(), out.data_ptr(), n, d,
            torch.cuda.current_stream(values.device).cuda_stream,
        )
        build.check(lib, code, "dequantize_symmetric")
    LAUNCHES["dequantize_symmetric"] += 1
    return out
