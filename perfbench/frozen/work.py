"""Frozen operation and byte counts, and the H100's peaks.

``PEAK_*`` and :func:`head_work` are copies of
``osr_tpu_torch/bench/common.py`` at commit 7b0e7eb585b0 (published peaks
of one H100 SXM at its 700 W limit, dense rates; one K1-K3 launch with each
input read once and each output written once). :func:`similarity_work`
counts one K5 (int8) launch in the same style. :func:`roofline_pct` is the
share of a kernel's least possible time in its measured time."""

from __future__ import annotations

from typing import Tuple

# Published peaks of one H100 SXM at its 700 W limit (dense rates).
PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores
PEAK_INT8_OPS = 1979e12  # int8 tensor cores
PEAK_F32_OPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def head_work(
    b: int, r: int, width: int, head_bytes: int, blockmax: bool = True
) -> Tuple[float, int]:
    """(operations, bytes) of one head kernel launch, K1-K3: a (b, width)
    bf16 query times the (r, width) head, each input read once (head,
    query, row mask), each output written once ((b, r) f32 scores, and
    for K2/K3 the (r/128, b) f32 block maxima)."""
    flops = 2.0 * b * r * width
    nbytes = head_bytes + 2 * b * width + r + 4 * b * r
    if blockmax:
        nbytes += 4 * b * (-(-r // 128))
    return flops, nbytes


def similarity_work(b: int, n: int, d: int) -> Tuple[float, int]:
    """(operations, bytes) of one K5 launch: a (b, d) int8 query times the
    (n, d) int8 corpus, each input read once (both operands and their f32
    row scales), the (b, n) f32 scores written once."""
    ops = 2.0 * b * n * d
    nbytes = b * d + n * d + 4 * (b + n) + 4 * b * n
    return ops, nbytes


def bound_s(ops: float, nbytes: int, peak_ops: float) -> Tuple[float, str]:
    """The least time one launch could take, and which side bounds it."""
    compute, memory = ops / peak_ops, nbytes / PEAK_BYTES
    return (compute, "compute") if compute >= memory else (memory, "bytes")


def roofline_pct(ops: float, nbytes: int, peak_ops: float,
                 seconds_per_launch: float) -> float:
    """100 x the least time over the measured time of one launch."""
    return 100.0 * bound_s(ops, nbytes, peak_ops)[0] / seconds_per_launch
