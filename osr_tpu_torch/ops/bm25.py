"""Batched sparse scoring: the device step of a search batch (counterpart
of ``osr_tpu/ops/bm25.py``).

The hybrid index (``index/layout.py``) splits each document's weights into
a dense head over the F most common terms and a postings tail. The device
step scores the head for the whole batch and selects its exact top-k; the
host scores the tail and merges (``index/postings.py:merge_host``). The
exactness of that split is argued in :func:`fused_search`.

Head scoring per head dtype:

- int8 / int4: on a CUDA device the hand-written kernels of
  ``ops/head.py`` (K1, K2, K3, and K4 for :func:`fused_search_extract`);
  elsewhere, or with ``head_backend='torch'``, their plain PyTorch
  versions.
- bf16 / f32: a plain float32 product on every device (TF32 off), as
  ``osr_tpu`` runs XLA there; no Pallas kernel exists for these modes.

The selections: exact and block-pruned (which also serves ``osr_tpu``'s
narrowed and ``approx`` modes, see :func:`fused_search`), the extraction
path and the merge of row chunks (:func:`merge_chunks`). Rows travel as
int32 tensors and results leave the device through the engine's pinned
buffers; nothing here packs rows into floats.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from osr_tpu_torch.ops import head as head_ops
from osr_tpu_torch.ops.topk import (
    block_max,
    block_topk_from_max,
    blocktopm_topk,
    topk,
)

NEG_INF = float("-inf")

# Block-pruned selection pays off only where the head has many more
# 128-row blocks than the k it must keep (osr_tpu/ops/bm25.py:189-191).
BLOCK_PRUNE_MIN_ROWS = 4096


def block_prune_applies(rows: int, k: int) -> bool:
    """Whether the block-pruned selection (and the extraction kernel) runs
    for ``rows`` head rows at depth ``k``."""
    return rows >= BLOCK_PRUNE_MIN_ROWS and rows // 128 > 2 * min(k, rows)


def scatter_query_head(
    term_ids: torch.Tensor,  # (B, Q) int32; ids outside [0, F) are dropped
    term_weights: torch.Tensor,  # (B, Q) float32, padded with 0
    *,
    head_terms: int,
) -> torch.Tensor:
    """Scatter padded sparse queries into a dense (B, F) float32 matrix.

    Padding and tail ids (>= F) land in one spare column that is cut off,
    so the scatter needs no data-dependent mask (no device sync)."""
    b = term_ids.shape[0]
    ids = term_ids.long()
    ids = torch.where((ids >= 0) & (ids < head_terms), ids, head_terms)
    qw = torch.zeros(
        (b, head_terms + 1), dtype=torch.float32, device=term_ids.device
    )
    qw.scatter_add_(1, ids, term_weights.float())
    return qw[:, :head_terms]


def head_scores(
    head: torch.Tensor,  # (R, F) int8 | (R, F/2) uint8 | bf16 | f32
    head_scales: Optional[torch.Tensor],  # (F,) f32 for int8/int4
    qhead: torch.Tensor,  # (B, F) f32 query weights
) -> torch.Tensor:
    """(B, R) f32 unmasked head scores, plain PyTorch.

    int8/int4: scaled queries round to bf16, codes are exact, f32
    products and sums (``ops/head.py:quantized_head_scores``). bf16: the
    stored bf16 weights against bf16-rounded query weights, products and
    sums in f32. f32: full float32 (``osr_tpu`` runs HIGHEST precision)."""
    if head.shape[1] == 0:
        return torch.zeros(
            (qhead.shape[0], head.shape[0]), dtype=torch.float32,
            device=head.device,
        )
    if head.dtype in (torch.int8, torch.uint8):
        return head_ops.quantized_head_scores(head, head_scales, qhead)
    if head.dtype == torch.bfloat16:
        q = qhead.to(torch.bfloat16).float()
    else:
        q = qhead.float()
    w = head.float()
    if w.shape[1] > q.shape[1]:  # head columns padded at upload
        q = torch.nn.functional.pad(q, (0, w.shape[1] - q.shape[1]))
    with head_ops.f32_matmul():
        return q @ w.T


def head_step_scores(
    q_head_ids: torch.Tensor,  # (B, Qh) int32, padding >= head_terms
    q_head_weights: torch.Tensor,  # (B, Qh) f32
    head: torch.Tensor,  # (R, F) on the search device
    head_scales: Optional[torch.Tensor],  # (F,) or None
    valid: torch.Tensor,  # (R,) bool
    *,
    head_terms: int,
    head_backend: str,  # 'cuda' | 'torch'
    with_block_max: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The scoring half of :func:`fused_search`: ((B, R) f32 head scores
    with invalid rows at -inf, (B, G) per-128-row block maxima or None).

    ``head_backend='cuda'`` scores an int8/int4 head on a CUDA device with
    the kernels: K2 (int8) or K3 (int4), whose maxima come with the scores,
    where ``with_block_max`` asks for them or the head is int4 (K3 has no
    scores-only form), else K1. 'torch' runs the plain version and reduces
    the maxima from its scores when asked."""
    qhead = scatter_query_head(
        q_head_ids, q_head_weights, head_terms=head_terms
    )
    quantized = head.dtype in (torch.int8, torch.uint8)
    bmax = None
    if head_backend == "cuda":
        if not quantized or head.device.type != "cuda":
            raise ValueError(
                "head_backend='cuda' needs an int8 or int4 head on a CUDA "
                f"device (got {head.dtype} on {head.device})"
            )
        if with_block_max or head.dtype == torch.uint8:
            hs, bmax = head_ops.masked_head_scores_blockmax(
                head, head_scales, qhead, valid
            )
        else:
            hs = head_ops.masked_head_scores(head, head_scales, qhead, valid)
    elif head_backend == "torch":
        hs = head_scores(head, head_scales, qhead)
        hs = hs.masked_fill(~valid[None, :], NEG_INF)
    else:
        raise ValueError(f"Unknown head_backend: {head_backend}")
    if with_block_max and bmax is None:
        bmax = block_max(hs)
    return hs, bmax


def fused_search(
    q_head_ids: torch.Tensor,  # (B, Qh) int32, padding >= head_terms
    q_head_weights: torch.Tensor,  # (B, Qh) f32
    cand_flat_rows: torch.Tensor,  # (M,) int32 candidate rows, query-major
    cand_flat_cols: torch.Tensor,  # (M,) int32 owning query per candidate
    head: torch.Tensor,  # (R, F) on the search device
    head_scales: Optional[torch.Tensor],  # (F,) or None
    valid: torch.Tensor,  # (R,) bool
    *,
    head_terms: int,
    k: int,
    head_backend: str,  # 'cuda' | 'torch'
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batched device step.

    Returns (head_top_scores (B, k') f32, head_top_rows (B, k') int32,
    cand_head_scores (M,) f32), k' = min(k, R). ``head_backend='cuda'``
    scores an int8/int4 head on a CUDA device with the kernels, 'torch'
    with the plain version (the engine chooses; :func:`head_step_scores`).

    The selection is the exact block-pruned one wherever it applies
    (:func:`block_prune_applies`), else one exact sort. ``osr_tpu``'s
    narrowed selection (``narrow_m``) is bit-identical to it, and its
    ``approx`` mode (``lax.approx_max_k``, which has no CUDA counterpart)
    is served by it exactly, so neither has a program of its own here.

    Exactness of the host merge (proof, as in ``osr_tpu``): tail weights
    are strictly positive (non-positive-IDF terms live in the head), so a
    document's total is at least its head score. A document neither
    tail-touched nor in the head top-k is outscored by all k head-top
    documents, so it cannot be in the true top-k. Head-top entries that
    are tail-touched carry a head-only score; the merge masks them and
    takes their exact totals from the candidate channel.
    """
    kk = min(k, head.shape[0])
    use_block_prune = block_prune_applies(head.shape[0], kk)
    hs, bmax = head_step_scores(
        q_head_ids, q_head_weights, head, head_scales, valid,
        head_terms=head_terms, head_backend=head_backend,
        with_block_max=use_block_prune,
    )
    if use_block_prune:
        head_top, head_rows = block_topk_from_max(hs, bmax, k=kk)
    else:
        head_top, head_rows = topk(hs, k=kk)
    cand_head = hs[cand_flat_cols.long(), cand_flat_rows.long()]
    return head_top, head_rows, cand_head


def head_step_blocktopm(
    q_head_ids: torch.Tensor,  # (B, Qh) int32, padding >= head_terms
    q_head_weights: torch.Tensor,  # (B, Qh) f32
    head: torch.Tensor,  # (R, F) int8 or (R, F/2) uint8 int4-packed
    head_scales: torch.Tensor,  # (F,) f32
    valid: torch.Tensor,  # (R,) bool
    *,
    head_terms: int,
    narrow_m: int = 8,
    head_backend: str,  # 'cuda' (K4) | 'torch' (its plain twin)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The extraction half of :func:`fused_search_extract`: each 128-row
    block's top ``narrow_m`` ((B, G, m) values, (B, G, m) int32 rows),
    from K4 on the card or its plain twin."""
    qhead = scatter_query_head(
        q_head_ids, q_head_weights, head_terms=head_terms
    )
    if head_backend == "cuda":
        return head_ops.masked_head_blocktopm(
            head, head_scales, qhead, valid, m=narrow_m
        )
    if head_backend == "torch":
        return head_ops.masked_head_blocktopm_plain(
            head, head_scales, qhead, valid, narrow_m
        )
    raise ValueError(f"Unknown head_backend: {head_backend}")


def fused_search_extract(
    q_head_ids: torch.Tensor,  # (B, Qh) int32, padding >= head_terms
    q_head_weights: torch.Tensor,  # (B, Qh) f32
    head: torch.Tensor,  # (R, F) int8 or (R, F/2) uint8 int4-packed
    head_scales: torch.Tensor,  # (F,) f32
    valid: torch.Tensor,  # (R,) bool
    *,
    head_terms: int,
    k: int,
    narrow_m: int = 8,
    head_backend: str,  # 'cuda' (K4) | 'torch' (its plain twin)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The extraction variant of the device step, for the host-merge path
    (``osr_tpu/ops/bm25.py:fused_search_extract``).

    K4 extracts each 128-row block's top ``narrow_m`` (value, row) in the
    matmul's epilogue, so the (B, R) score matrix is never written; the
    selection finishes over the (B, G, m) candidates
    (:func:`~osr_tpu_torch.ops.topk.blocktopm_topk`). Returns (top (B,
    k') f32, rows (B, k') int32, unsafe: a 0-dim bool tensor). When unsafe
    is set the caller must re-run the standard program; when it is clear,
    the engine's final results equal the standard program's."""
    vals, rows = head_step_blocktopm(
        q_head_ids, q_head_weights, head, head_scales, valid,
        head_terms=head_terms, narrow_m=narrow_m, head_backend=head_backend,
    )
    return blocktopm_topk(vals, rows, k=k)


def merge_chunks(
    vals: torch.Tensor,  # (C, B, k) per-chunk top-k values
    rows: torch.Tensor,  # (C, B, k) int32 chunk-local rows
    bases: torch.Tensor,  # (C,) int64 first row of each chunk
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-row-chunk top-k lists into one (B, k) top-k
    (``osr_tpu/ops/bm25.py:merge_packed_chunks``). Every global top-k
    document is in its own chunk's top-k, so the union holds the global
    top-k. Candidates are chunk-major and the selection is stable, so
    ties resolve toward the lower chunk, then the chunk's own order.
    Rows stay integers: int32 out, while every row is below 2^31."""
    c, b, k = vals.shape
    glob = rows.long() + bases.to(rows.device)[:, None, None]
    flat_v = vals.permute(1, 0, 2).reshape(b, c * k)
    flat_r = glob.permute(1, 0, 2).reshape(b, c * k)
    top, pos = topk(flat_v, k=k)
    return top, torch.gather(flat_r, 1, pos.long()).int()


def dense_head_scores(
    q_head_ids: torch.Tensor,
    q_head_weights: torch.Tensor,
    head: torch.Tensor,
    head_scales: Optional[torch.Tensor],
    *,
    head_terms: int,
) -> torch.Tensor:
    """(B, R) head scores for the oracle/score_all path (host adds tail)."""
    qhead = scatter_query_head(
        q_head_ids, q_head_weights, head_terms=head_terms
    )
    return head_scores(head, head_scales, qhead)
