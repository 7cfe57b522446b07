"""Plain symmetric int8 dense retrieval: the reference of the dense cells.

It quantizes the corpus rows and the queries as the configuration states
(per row: scale ``max(max |x|, 1e-8) * f32(1/127)``, codes ``round(x /
scale)``, half to even, in float32), multiplies the codes exactly and
scales the sums in float64. The corpus comes block by block from the
benchmark's generator, so the whole score matrix never exists at once."""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes as float64, scales as float64) of (n, d) float32 rows."""
    scale = x.abs().amax(dim=1).clamp_min(1e-8) * RECIP_127
    codes = torch.round(x / scale[:, None])
    return codes.double(), scale.double()


def search(
    queries: np.ndarray,  # (S, d) float32
    port_rows: np.ndarray,  # (S, m) int64 rows the program returned; -1 none
    blocks: Callable[[], object],  # yields (first row, (n, d) f32 block)
    k: int,
    device,
) -> Tuple[np.ndarray, np.ndarray]:
    """(the reference's top-k scores (S, k) float64, descending; the
    reference's score of each row the program returned (S, m), NaN where
    a row is -1 or out of range)."""
    q8, qs = quantize_rows(torch.from_numpy(queries).to(device))
    s = q8.shape[0]
    top = torch.full((s, 0), float("-inf"), dtype=torch.float64,
                     device=device)
    rows = torch.from_numpy(port_rows).to(device)
    of_port = torch.full(rows.shape, float("nan"), dtype=torch.float64,
                         device=device)
    for lo, x in blocks():
        d8, ds = quantize_rows(x)
        sc = (q8 @ d8.T) * qs[:, None] * ds[None, :]
        top = torch.cat([top, sc.topk(min(k, sc.shape[1]), dim=1).values], 1)
        top = top.topk(min(k, top.shape[1]), dim=1).values
        inside = (rows >= lo) & (rows < lo + sc.shape[1])
        local = (rows - lo).clamp(0, sc.shape[1] - 1)
        of_port = torch.where(inside, sc.gather(1, local), of_port)
    return top.cpu().numpy(), of_port.cpu().numpy()
