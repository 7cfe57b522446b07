"""Host-side tail scoring and the exact final merge (counterpart of
``osr_tpu/index/postings.py``).

Per batch:

1. :func:`tail_candidates_flat` walks the query batch's tail postings,
   sums duplicate (query, row) contributions and emits a flat query-major
   candidate list (rows unique and ascending per query).
2. The device step (``ops/bm25.py:fused_search``) scores the head and
   selects its top-k; on the device-merge path it also gathers the
   candidates' head scores.
3. :func:`merge_host`: totals = head + tail per candidate, head-top
   entries that are tail-touched are masked, exact top-k per query.

Each step runs in the port's C++ host runtime (``native.py``) when it is
available; the NumPy bodies here are the reference and give the same
results.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from osr_tpu_torch import native
from osr_tpu_torch.index.layout import bf16_round, bf16_to_f32, unpack_int4

@dataclasses.dataclass
class FlatCandidates:
    """Query-major flat candidate list (optional padding at the end)."""

    rows: np.ndarray  # (M,) int32 document rows, ascending within a query
    cols: np.ndarray  # (M,) int32 owning query index
    tail: np.ndarray  # (M,) float32 summed tail contributions
    ptr: np.ndarray  # (B+1,) int64 per-query segment offsets
    total: int  # entries (M)


def _empty_candidates(batch_size: int) -> FlatCandidates:
    return FlatCandidates(
        rows=np.zeros(0, dtype=np.int32),
        cols=np.zeros(0, dtype=np.int32),
        tail=np.zeros(0, dtype=np.float32),
        ptr=np.zeros(batch_size + 1, dtype=np.int64),
        total=0,
    )


def tail_candidates_flat(
    post_ptr: np.ndarray,  # (T+1,) int64
    post_rows: np.ndarray,  # (nnz,) int32
    post_weights: np.ndarray,  # (nnz,) float32
    tail_ids: np.ndarray,  # (Nt,) int32 tail-LOCAL ids (t - F), flat
    tail_counts: np.ndarray,  # (Nt,) float32 query term counts, flat
    tail_ptr: np.ndarray,  # (nq+1,) int64 per-query segments
    batch_size: int,
    num_rows: int,
    use_native: bool = True,
) -> FlatCandidates:
    """Tail scorer: flat (query, row) candidates with summed contributions.
    Arrays have exactly ``total`` entries (``osr_tpu`` pads them to a width
    menu so its compiled device program is reused; the port has no such
    cache to feed)."""
    nq = len(tail_ptr) - 1
    if nq > batch_size:
        raise ValueError(f"{nq} queries exceed batch size {batch_size}")
    if len(tail_ids) == 0:
        return _empty_candidates(batch_size)

    if use_native and native.available():
        rows, cols, tail, qptr, total = native.tail_candidates_native(
            post_ptr, post_rows, post_weights, tail_ids, tail_counts, tail_ptr,
        )
        ptr = np.zeros(batch_size + 1, dtype=np.int64)
        ptr[: nq + 1] = qptr
        ptr[nq + 1 :] = qptr[-1]
        return FlatCandidates(
            rows[:total], cols[:total], tail[:total], ptr, total
        )

    qi = np.repeat(np.arange(nq, dtype=np.int64), np.diff(tail_ptr))
    tl = np.asarray(tail_ids, dtype=np.int64)
    ct = np.asarray(tail_counts, dtype=np.float32)
    starts = post_ptr[tl]
    df = (post_ptr[tl + 1] - starts).astype(np.int64)
    total_postings = int(df.sum())
    if total_postings == 0:
        return _empty_candidates(batch_size)
    ends = np.cumsum(df)
    flat = np.arange(total_postings, dtype=np.int64)
    flat += np.repeat(starts - (ends - df), df)
    rows = post_rows[flat].astype(np.int64)
    vals = post_weights[flat] * np.repeat(ct, df)
    qidx = np.repeat(qi, df)
    # unique() sorts by (query, row): query-major, rows ascending.
    key = qidx * np.int64(num_rows + 1) + rows
    ukey, inv = np.unique(key, return_inverse=True)
    sums = np.bincount(inv, weights=vals).astype(np.float32)
    uq = (ukey // (num_rows + 1)).astype(np.int32)
    urow = (ukey % (num_rows + 1)).astype(np.int32)
    ptr = np.zeros(batch_size + 1, dtype=np.int64)
    np.cumsum(np.bincount(uq, minlength=batch_size), out=ptr[1:])
    return FlatCandidates(urow, uq, sums, ptr, int(ukey.shape[0]))


def _head_values(head: np.ndarray, head_dtype: str) -> np.ndarray:
    """Head entries as float32 (bf16 heads are uint16 bit patterns)."""
    if head_dtype == "bf16":
        return bf16_to_f32(head)
    return np.asarray(head, dtype=np.float32)


def cand_head_scores_host(
    head: np.ndarray,  # (R, F) int8 | bf16 bits (uint16) | f32
    head_dtype: str,
    head_scales: Optional[np.ndarray],  # (F,) f32 for int8
    cand: FlatCandidates,
    head_flat_ids: np.ndarray,  # (Nh,) int32 per-query head terms, flat
    head_flat_counts: np.ndarray,  # (Nh,) float32
    head_ptr: np.ndarray,  # (nq+1,) int64
    use_native: bool = True,
    head_t: Optional[np.ndarray] = None,  # (F, R) int8 term-major copy
) -> np.ndarray:
    """Head scores of the flat candidates from the host-resident head,
    with the device's numerics: scaled query weights round to bf16 and
    products sum in f32 (``ops/head.py``)."""
    total = cand.total
    if total == 0:
        return np.zeros(0, dtype=np.float32)
    if use_native and native.available():
        if head_t is not None and head_dtype == "int8":
            return native.cand_head_dot_t_native(
                head_t, head_scales, cand.rows, cand.ptr, total,
                head_flat_ids, head_flat_counts, head_ptr,
            )
        return native.cand_head_dot_native(
            head, head_dtype, head_scales, cand.rows, cand.cols, total,
            head_flat_ids, head_flat_counts, head_ptr,
        )
    nq = len(head_ptr) - 1
    n_head = np.diff(head_ptr)
    qh_max = int(n_head.max(initial=0))
    if qh_max == 0:
        return np.zeros(total, dtype=np.float32)
    tid_pad = np.zeros((nq, qh_max), dtype=np.int64)
    cnt_pad = np.zeros((nq, qh_max), dtype=np.float32)
    rows_r = np.repeat(np.arange(nq, dtype=np.int64), n_head)
    cols_r = np.arange(len(head_flat_ids), dtype=np.int64) - np.repeat(
        head_ptr[:-1], n_head
    )
    tid_pad[rows_r, cols_r] = head_flat_ids
    cnt_pad[rows_r, cols_r] = head_flat_counts
    q = cand.cols[:total].astype(np.int64)
    w = _head_values(head[cand.rows[:total][:, None], tid_pad[q]], head_dtype)
    if head_dtype == "int8" and head_scales is not None:
        return (w * bf16_round(cnt_pad[q] * head_scales[tid_pad[q]])).sum(
            axis=1
        ).astype(np.float32)
    return (w * cnt_pad[q]).sum(axis=1).astype(np.float32)


def prepare_host_merge(layout, want_head_t: bool = True):
    """Host-side state for the exact merge: the host head view (int4
    unpacked once to the int8 codes the device multiplies), an optional
    term-major int8 copy for the streaming candidate scorer, and the
    per-head-term slack bound of :func:`merge_tau_slack`.

    Returns ``(host_head, host_head_dtype, head_t, slack_per_term)``."""
    host_head = layout.head
    host_head_dtype = layout.head_dtype
    if layout.head_dtype == "int4":
        host_head = unpack_int4(layout.head, layout.head_terms)
        host_head_dtype = "int8"
    head_t = None
    if want_head_t and host_head_dtype == "int8" and native.available():
        head_t = native.transpose_i8_native(host_head)
    # Per-term bound on the device/host head-dot discrepancy: the device
    # rounds each scaled query weight to bf16 (half-ulp 2^-8) and both
    # sides accumulate F f32 terms; head terms can mix signs, so the bound
    # scales with max|w| * scale per term, never with the score.
    ht = max(int(layout.head_terms), 1)
    if host_head_dtype == "int8":
        rel = 2.0**-8 + 4.0 * ht * 2.0**-24
        wmax = 15.0 if layout.head_dtype == "int4" else 127.0
        # |scale|: int4 scales carry the column's sign, and a negative
        # slack would let the merge prefilter drop real candidates
        # (osr_tpu multiplies by the signed scale; a deliberate divergence).
        slack = (
            rel * wmax * np.abs(np.asarray(layout.head_scales, np.float32))
        ).astype(np.float32)
    else:
        rel = (
            2.0**-8 + 4.0 * ht * 2.0**-24
            if host_head_dtype == "bf16"
            else 2.0**-22 + 4.0 * ht * 2.0**-24
        )
        hmax = np.zeros(host_head.shape[1], dtype=np.float32)
        for lo in range(0, host_head.shape[0], 65536):
            blk = np.abs(_head_values(host_head[lo : lo + 65536], host_head_dtype))
            np.maximum(hmax, blk.max(axis=0, initial=0.0), out=hmax)
        slack = (rel * hmax).astype(np.float32)
    return host_head, host_head_dtype, head_t, slack


def merge_tau_slack(
    slack_per_term: np.ndarray,  # (F,) f32 per-head-term error bound
    head_flat_ids: np.ndarray,  # (Nh,) int32
    head_flat_counts: np.ndarray,  # (Nh,) float32
    head_ptr: np.ndarray,  # (nq+1,)
) -> np.ndarray:
    """Per-query upper bound on |device head score - host head score|:
    ``slack_q = sum_j |count_j| * slack_per_term[id_j]``. Sound under sign
    cancellation because it scales with sum(|terms|), not with |score|."""
    contrib = np.abs(head_flat_counts.astype(np.float32)) * slack_per_term[
        head_flat_ids
    ]
    csum = np.concatenate([[0.0], np.cumsum(contrib, dtype=np.float64)])
    ptr = np.asarray(head_ptr, dtype=np.int64)
    return (csum[ptr[1:]] - csum[ptr[:-1]]).astype(np.float32)


def filter_candidates_by_tau(
    cand: FlatCandidates,
    head_scores: np.ndarray,  # (B, k) device head top-k scores (desc)
    head_rows: np.ndarray,  # (B, k) int32 device head top-k rows
    k: int,
    tau_slack: np.ndarray,  # (B,) f32 device/host head rounding bound
    num_rows: int,
) -> FlatCandidates:
    """Exact pre-head-dot candidate filter for large candidate loads.

    A candidate outside the device head top-k has a reported total of at
    most tau0 + slack_q + tail (tau0 = the k-th head-only score); the
    k-th best reported total is at least tau_lb, the k-th largest of the
    head-top documents' lower bounds head_i - slack_q + tail_i. Candidates
    with tail < tau_lb - tau0 - slack_q cannot reach the final top-k and
    are dropped; candidates whose row is in the head top-k are kept."""
    b, kh = head_scores.shape
    total = cand.total
    if total == 0 or kh < k:
        return cand
    nq = len(cand.ptr) - 1
    tails = cand.tail[:total]
    cols = cand.cols[:total]
    rows = cand.rows[:total]
    key_flat = cols.astype(np.int64) * np.int64(num_rows + 1) + rows
    bq = min(b, nq)
    head_keys = (
        np.repeat(np.arange(bq, dtype=np.int64), kh) * np.int64(num_rows + 1)
        + head_rows[:bq].ravel()
    )
    pos = np.searchsorted(key_flat, head_keys)
    in_b = pos < total
    touched = np.zeros(bq * kh, dtype=bool)
    touched[in_b] = key_flat[pos[in_b]] == head_keys[in_b]
    top_tail = np.zeros(bq * kh, dtype=np.float32)
    top_tail[touched] = tails[pos[touched]]
    top_tail = top_tail.reshape(bq, kh)
    slack = np.asarray(tau_slack, dtype=np.float32)
    if len(slack) < bq:
        slack = np.concatenate(
            [slack, np.full(bq - len(slack), np.inf, np.float32)]
        )
    slack = slack[:bq]
    with np.errstate(invalid="ignore"):
        lb_totals = head_scores[:bq].astype(np.float32) - slack[:, None] + top_tail
        tau_lb = -np.partition(-lb_totals, k - 1, axis=1)[:, k - 1]
        tau0 = head_scores[:bq, k - 1].astype(np.float32)
        theta = tau_lb - tau0 - slack - 1e-6
    theta = np.where(np.isfinite(theta), theta, -np.inf)
    theta_full = np.full(nq, -np.inf, dtype=np.float32)
    theta_full[:bq] = theta
    keep = tails >= theta_full[cols]
    keep[pos[touched]] = True
    if keep.all():
        return cand
    new_cols = cols[keep]
    ptr = np.zeros(nq + 1, dtype=np.int64)
    np.cumsum(np.bincount(new_cols, minlength=nq), out=ptr[1:])
    return FlatCandidates(
        rows[keep], new_cols, tails[keep], ptr, int(new_cols.shape[0])
    )


def merge_host(
    head_scores: np.ndarray,  # (B, k) device head top-k scores
    head_rows: np.ndarray,  # (B, k) int32 device head top-k rows
    cand: FlatCandidates,
    cand_head: np.ndarray,  # (>= total,) candidate head scores
    num_rows: int,
    k: int,
    use_native: bool = True,
    tau_slack: Optional[np.ndarray] = None,  # (B,) f32; None = no prefilter
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact final top-k per query: (head top-k) UNION (candidate totals).

    Tail-touched head-top entries are masked (the candidate channel holds
    their exact totals). ``tau_slack`` enables the candidate prefilter with
    a sound per-query rounding bound; pass zeros when ``cand_head`` comes
    from the same device score matrix as ``head_scores``. Ties keep the
    head-top order first, then candidate order (a stable sort)."""
    b, kh = head_scores.shape
    total = cand.total
    totals = cand_head[:total].astype(np.float32) + cand.tail[:total]
    if tau_slack is not None and len(tau_slack) < b:
        # Bucket-padded queries have -inf heads: their slack is moot.
        tau_slack = np.concatenate(
            [tau_slack, np.full(b - len(tau_slack), np.inf, np.float32)]
        )
    if use_native and native.available():
        ptr = cand.ptr
        if len(ptr) != b + 1:
            ptr = np.concatenate(
                [ptr, np.full(b + 1 - len(ptr), ptr[-1], ptr.dtype)]
            )
        return native.merge_topk_native(
            np.asarray(head_scores), np.asarray(head_rows),
            cand.rows, totals, ptr, total, k, tau_slack=tau_slack,
        )

    key_flat = (
        cand.cols[:total].astype(np.int64) * np.int64(num_rows + 1)
        + cand.rows[:total]
    )
    head_keys = (
        np.repeat(np.arange(b, dtype=np.int64), kh) * np.int64(num_rows + 1)
        + head_rows.ravel()
    )
    pos = np.searchsorted(key_flat, head_keys)
    touched = np.zeros(b * kh, dtype=bool)
    in_b = pos < total
    touched[in_b] = key_flat[pos[in_b]] == head_keys[in_b]
    head_masked = np.where(
        touched.reshape(b, kh), -np.inf, head_scores
    ).astype(np.float32)

    cols_t = cand.cols[:total]
    rows_t = cand.rows[:total]
    if total and kh >= k and tau_slack is not None:
        # The final k-th total is >= tau0, the k-th head-only score.
        tau0 = head_scores[:, k - 1]
        cand_tau = tau0 - tau_slack.astype(np.float32) - 1e-6
        tau = np.where(np.isfinite(cand_tau), cand_tau, -np.inf).astype(
            np.float32
        )
        keep = totals >= tau[cols_t]
        totals = totals[keep]
        cols_t = cols_t[keep]
        rows_t = rows_t[keep]
        total = int(keep.sum())

    cmax = int(np.bincount(cols_t, minlength=b).max(initial=0)) if total else 0
    cand_s = np.full((b, cmax), -np.inf, dtype=np.float32)
    cand_r = np.zeros((b, cmax), dtype=np.int32)
    if total:
        seg_ptr = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(np.bincount(cols_t, minlength=b), out=seg_ptr[1:])
        col = np.arange(total, dtype=np.int64) - seg_ptr[cols_t]
        cand_s[cols_t, col] = totals
        cand_r[cols_t, col] = rows_t
    all_s = np.concatenate([head_masked, cand_s], axis=1)
    all_r = np.concatenate([head_rows.astype(np.int32), cand_r], axis=1)
    kk = min(k, all_s.shape[1])
    if kk < all_s.shape[1]:
        part = np.argpartition(-all_s, kk - 1, axis=1)[:, :kk]
    else:
        part = np.broadcast_to(np.arange(all_s.shape[1]), (b, all_s.shape[1]))
    part_s = np.take_along_axis(all_s, part, axis=1)
    order = np.argsort(-part_s, axis=1, kind="stable")
    top_s = np.take_along_axis(part_s, order, axis=1)
    top_r = np.take_along_axis(
        np.take_along_axis(all_r, part, axis=1), order, axis=1
    )
    if top_s.shape[1] < k:
        # Fixed (B, k) contract: pad with (-inf, row 0) sentinels.
        pad = k - top_s.shape[1]
        top_s = np.pad(top_s, ((0, 0), (0, pad)), constant_values=-np.inf)
        top_r = np.pad(top_r, ((0, 0), (0, pad)))
    return top_s, top_r


def dense_tail_scores(
    post_ptr: np.ndarray,
    post_rows: np.ndarray,
    post_weights: np.ndarray,
    tail_ids: np.ndarray,  # (Nt,) int32 LOCAL ids, flat
    tail_counts: np.ndarray,
    tail_ptr: np.ndarray,  # (nq+1,)
    num_rows: int,
) -> np.ndarray:
    """(nq, num_rows) dense tail score matrix: the oracle/score_all path."""
    nq = len(tail_ptr) - 1
    out = np.zeros((nq, num_rows), dtype=np.float32)
    for q in range(nq):
        lo, hi = int(tail_ptr[q]), int(tail_ptr[q + 1])
        for t, cnt in zip(tail_ids[lo:hi], tail_counts[lo:hi]):
            a, z = int(post_ptr[t]), int(post_ptr[t + 1])
            np.add.at(out[q], post_rows[a:z], post_weights[a:z] * float(cnt))
    return out
