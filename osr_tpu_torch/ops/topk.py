"""Exact top-k selection with ``lax.top_k``'s tie order (counterpart of
``osr_tpu/ops/topk.py``).

``lax.top_k`` breaks ties toward the lower index, and the exactness and
bit-identity arguments of the reference depend on it (``osr_tpu/ops/
topk.py:129-133``, ``osr_tpu/index/postings.py:merge_host``).
``torch.topk`` does not specify its tie order, so every selection here is
a stable descending sort that keeps the first k: equal values stay in
index order.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk(scores: torch.Tensor, *, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact descending top-k along the last axis: (values, int32 indices);
    ties resolve to the lower index."""
    kk = min(k, scores.shape[-1])
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :kk], idx[..., :kk].int()


def block_max(scores: torch.Tensor, block_cols: int = 128) -> torch.Tensor:
    """(B, G) maxima of each ``block_cols``-column block, G = ceil(R /
    block_cols); columns beyond R count as -inf. A ragged last block is
    reduced on its own, so the (B, R) matrix is never copied."""
    b, r = scores.shape
    full = r - r % block_cols
    maxima = scores[:, :full].reshape(b, full // block_cols, block_cols).amax(2)
    if full == r:
        return maxima
    return torch.cat([maxima, scores[:, full:].amax(dim=1, keepdim=True)], 1)


def block_topk(
    scores: torch.Tensor,  # (B, R)
    *,
    k: int,
    block_cols: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k per query via block-max pruning: reduce each 128-column
    block to its max, keep the k best blocks, select within them.

    Exactness: a true top-k member with score s lies in a block whose max
    is >= s; were that block not selected, k selected blocks would each
    hold a document scoring >= s, ranking it k+1-th at best."""
    return block_topk_from_max(
        scores, block_max(scores, block_cols), k=k, block_cols=block_cols
    )


def block_topk_from_max(
    scores: torch.Tensor,  # (B, R)
    maxima: torch.Tensor,  # (B, G) per-block maxima, G = ceil(R / 128)
    *,
    k: int,
    block_cols: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`block_topk` with the block maxima supplied by the caller (the
    head kernels K2/K3 reduce them inside the matmul's thread blocks).

    Candidates are laid out block-rank-major, lane-minor, as in the
    reference, so the stable final sort reproduces ``lax.top_k``'s order
    among ties. Returns (values (B, k'), int32 rows (B, k'))."""
    b, r = scores.shape
    kk = min(k, r)
    g = -(-r // block_cols)
    if maxima.shape[1] != g:
        raise ValueError(f"maxima have {maxima.shape[1]} blocks, expected {g}")
    nb = min(kk, g)
    _, top_blocks = topk(maxima, k=nb)  # (B, nb)
    # Candidate columns of the chosen blocks; lanes past R (a ragged last
    # block) read column R - 1 and are set to -inf, as padding would be.
    lanes = torch.arange(block_cols, device=scores.device)
    cols = (top_blocks.long()[:, :, None] * block_cols + lanes).reshape(b, -1)
    cand = torch.gather(scores, 1, cols.clamp_max(r - 1))
    if r % block_cols:
        cand = cand.masked_fill(cols >= r, float("-inf"))
    vals, pos = topk(cand, k=kk)
    return vals, torch.gather(cols, 1, pos.long()).int()
