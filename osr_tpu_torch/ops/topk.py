"""Exact top-k selection with ``lax.top_k``'s tie order (counterpart of
``osr_tpu/ops/topk.py``).

``lax.top_k`` breaks ties toward the lower index, and the exactness and
bit-identity arguments of the reference depend on it (``osr_tpu/ops/
topk.py:129-133``, ``osr_tpu/index/postings.py:merge_host``).
``torch.topk`` does not specify its tie order, so every selection here is
a stable descending sort that keeps the first k: equal values stay in
index order.

``osr_tpu``'s per-block narrowing (``block_topk_narrow``) has no
counterpart: it is bit-identical to :func:`block_topk_from_max`, which the
port runs in its place (no ``lax.cond`` to mirror, so no host sync and no
second branch).

:func:`fast_topk`, :func:`merge_topk` and :func:`approx_topk_threshold`
are the selection variants the benchmark suites time
(``benchmarks/suites.py:TopKSuite``); they give ``osr_tpu``'s indices as
well as its values, ties included.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def topk(scores: torch.Tensor, *, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact descending top-k along the last axis: (values, int32 indices);
    ties resolve to the lower index."""
    kk = min(k, scores.shape[-1])
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :kk], idx[..., :kk].int()


def fast_topk(
    scores: torch.Tensor, *, k: int, overfetch: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage top-k: the ``overfetch * k`` best of a bfloat16 copy,
    then the exact f32 top-k of those candidates. Returned values are the
    f32 scores. Both stages are stable sorts, so ties go to the lower
    position, as ``lax.top_k``'s do in ``osr_tpu``."""
    n = scores.shape[-1]
    kk = min(k, n)
    _, coarse = topk(scores.to(torch.bfloat16), k=min(kk * overfetch, n))
    vals, pos = topk(torch.gather(scores, -1, coarse.long()), k=kk)
    return vals, torch.gather(coarse, -1, pos.long())


def merge_topk(
    scores_parts: Sequence[torch.Tensor],  # each (B, k_i)
    ids_parts: Sequence[torch.Tensor],  # each (B, k_i) global ids
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k of concatenated partial top-k results: (values, ids).
    Ties go to the lower position in the concatenation, not to the lower
    id."""
    top, pos = topk(torch.cat(list(scores_parts), dim=-1), k=k)
    return top, torch.gather(torch.cat(list(ids_parts), dim=-1), -1, pos.long())


def approx_topk_threshold(
    scores: torch.Tensor, *, k: int, sample_stride: int = 64
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampling-threshold top-k: estimate the k-th value from every
    ``sample_stride``-th score, mask scores below it less one (population)
    standard deviation of the sample, then select exactly. With fewer than
    4 k samples the selection is exact from the start."""
    n = scores.shape[-1]
    kk = min(k, n)
    sample = scores[..., ::sample_stride]
    m = sample.shape[-1]
    if m < 4 * kk:
        return topk(scores, k=kk)
    sk = min(max(1, (kk * m) // n + 1), m)
    thresh = topk(sample, k=sk)[0][..., -1:]
    margin = torch.std(sample, dim=-1, keepdim=True, correction=0)
    masked = torch.where(scores >= thresh - margin, scores, float("-inf"))
    return topk(masked, k=kk)


def block_topm(
    scores: torch.Tensor, m: int, block_cols: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each ``block_cols``-column block's m largest scores: ((B, G, m)
    values, (B, G, m) int32 columns), G = ceil(R / block_cols), columns
    past R counted as -inf. A stable descending sort per block, so ties go
    to the lower column and equal values come out in column order."""
    b, r = scores.shape
    g = -(-r // block_cols)
    pad = g * block_cols - r
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    vals, lanes = topk(scores.reshape(b, g, block_cols), k=m)
    base = torch.arange(g, dtype=torch.int32, device=scores.device) * block_cols
    return vals, lanes + base[None, :, None]


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


def blocktopm_topk(
    vals: torch.Tensor,  # (B, G, m) per-block top-m values, desc per block
    rows: torch.Tensor,  # (B, G, m) int32 rows
    *,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-k from per-block top-m candidates (K4's output,
    ``ops/head.py:masked_head_blocktopm``; ``osr_tpu/ops/topk.py:
    blocktopm_topk``). Returns (values (B, k'), int32 rows (B, k'),
    unsafe: a 0-dim bool tensor on the device).

    The top-k blocks by their maxima (``vals[..., 0]``), then the top-k of
    their k * m candidates, block-rank-major: the block set and tie order
    of :func:`block_topk_from_max`. ``unsafe`` is set when some selected
    block's m-th value reaches the k-th value tau and is positive. With it
    clear, every document the narrowing missed scores below tau or at most
    0, and the engines keep only positive scores, so their results equal
    the full-width path's. With it set the caller must re-run the
    full-width program: the full score matrix was never written."""
    b, g, m = vals.shape
    nb = min(k, g)
    kk = min(k, g * m, nb * m)
    _, top_blocks = topk(vals[:, :, 0], k=nb)  # (B, nb)
    idx = top_blocks.long()[:, :, None].expand(b, nb, m)
    cand_v = torch.gather(vals, 1, idx).reshape(b, nb * m)
    cand_r = torch.gather(rows, 1, idx).reshape(b, nb * m)
    top, pos = topk(cand_v, k=kk)
    top_rows = torch.gather(cand_r, 1, pos.long())
    mth = torch.gather(vals[:, :, -1], 1, top_blocks.long())
    unsafe = ((mth >= top[:, -1:]) & (mth > 0.0)).any()
    return top, top_rows, unsafe
