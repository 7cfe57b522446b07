"""The host stages of a sparse batch at corpus scale, and how much of the
tail walk a MaxScore term skip could save (counterpart of
``tools/profile_host_scale.py``).

Loads an index written by ``python -m osr_tpu_torch.bench scaling
--save-index DIR`` and runs only the host stages over ``--queries``
seed-42 queries, one batch; no device is touched. Reports, with the
script's names:

1. Each stage's wall time: encode, tail walk (``tail_candidates_flat``),
   candidate head dot (``cand_head_scores_host``) and merge, per query,
   plus the one-time ``prepare_host_merge`` (int4 unpack, term-major
   transpose).
2. The potential of a MaxScore term-level skip: per query, theta =
   tau_final - tau0 - slack, the budget a document outside the head
   top-k must clear from tail terms alone, and the share of postings in
   the tail terms whose upper bounds (max weight x query count, cheapest
   first) sum below theta. The estimates are restricted to candidates
   (no device): tau0_est, the k-th best candidate head score, is at most
   the true tau0 (theta over-estimated), and tau_final_est, the k-th
   best candidate total, at most the true tau_final (theta
   under-estimated).

Every count and estimate equals the script's on an int8 dump
(``tests/test_torch_bench_stages.py``) but ``postings_per_q_mean``: here
it is the mean over queries of the postings their tail terms hold. The
script summed per query with ``np.add.reduceat``, which counts a query
without tail terms as the next query's first term and raises where the
last query has none. On an int4 dump ``theta_*``,
``skip_fraction_of_postings``, ``cand_tail_ge_theta_frac`` and
``postings_per_q_after_skip`` may differ from the script's: the port's
merge slack multiplies by |scale| where ``osr_tpu`` multiplies by the
signed int4 scale (a deliberate divergence), so its slack is at
least ``osr_tpu``'s and its theta at most.

On a machine with a CUDA card the host stages must take the port's host
runtime (``common.check_host_runtime``), as the sparse engines do on the
card; without a card, or with ``--cpu``, they take it when it loads and
the NumPy bodies otherwise, as the tests do. The row adds
``host_runtime`` ("native" or "numpy"), ``kernel_launches`` (none: no
kernel runs) and ``device`` (the card's name and power limit, or
"cpu"). Prints JSON as its last line.

Usage: python -m osr_tpu_torch.bench profile-host-scale --load-index DIR
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from osr_tpu_torch.bench.common import (
    check_host_runtime,
    device_name,
    launched,
    log,
    reset_all_launches,
)

METRIC = "host_stage_ms_and_term_skip"
KEYS = (
    "metric", "num_docs", "head_terms", "head_dtype", "max_tail_df",
    "num_queries", "prepare_host_merge_s", "encode_ms_per_q",
    "walk_ms_per_q", "cand_head_ms_per_q", "merge_ms_per_q",
    "host_total_ms_per_q", "postings_per_q_mean", "candidates_per_q_mean",
    "cand_head_ns_per_gather", "theta_median", "theta_p10",
    "theta_finite_frac", "skip_fraction_of_postings",
    "cand_tail_ge_theta_frac", "postings_per_q_after_skip", "analysis_s",
    "host_runtime", "kernel_launches", "device",
)


def run(
    load_index: str,
    *,
    queries: int = 256,
    topk: int = 50,
    device="cpu",
) -> Dict[str, object]:
    """The row. ``device`` names the card for the row (the stages run on
    the host); on ``cuda`` the host runtime is required."""
    from osr_tpu_torch import native
    from osr_tpu_torch.bench.scaling import load_index as load
    from osr_tpu_torch.index.postings import (
        cand_head_scores_host,
        merge_host,
        merge_tau_slack,
        prepare_host_merge,
        tail_candidates_flat,
    )
    from osr_tpu_torch.index.tokenizer import Tokenizer
    from osr_tpu_torch.retrieval.encoding import (
        QueryEncoder,
        encode_query_batch,
    )
    from osr_tpu_torch.testing import SyntheticDataGenerator

    dev = torch.device(device)
    if dev.type == "cuda":
        check_host_runtime()
    runtime = "native" if native.available() else "numpy"
    reset_all_launches()
    t0 = time.perf_counter()
    index, _ = load(load_index)
    lay = index.layout
    log(f"loaded {lay.num_docs} docs F={lay.head_terms} ({lay.head_dtype}) "
        f"tail_nnz={lay.tail_nnz} max_tail_df={lay.max_tail_df} in "
        f"{time.perf_counter() - t0:.1f}s; host runtime {runtime}")

    texts = list(
        SyntheticDataGenerator(seed=42).queries(
            queries, lay.vocab_size, avg_terms=11, word_prefix="t",
            min_terms=2,
        ).values()
    )

    t0 = time.perf_counter()
    host_head, host_head_dtype, head_t, slack_per_term = prepare_host_merge(
        lay, want_head_t=True
    )
    prep_s = time.perf_counter() - t0
    log(f"prepare_host_merge: {prep_s:.1f}s")

    enc_obj = QueryEncoder(Tokenizer(index.vocabulary))
    nq = len(texts)
    t0 = time.perf_counter()
    enc = encode_query_batch(enc_obj, texts, nq, lay.head_terms)
    encode_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cand = tail_candidates_flat(
        lay.post_ptr, lay.post_rows, lay.post_weights,
        enc.tail_ids, enc.tail_counts, enc.tail_ptr,
        nq, num_rows=lay.num_rows,
    )
    walk_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cand_head = cand_head_scores_host(
        host_head, host_head_dtype, lay.head_scales, cand,
        enc.head_flat_ids, enc.head_flat_counts, enc.head_ptr,
        head_t=head_t,
    )
    cand_head_s = time.perf_counter() - t0

    # A head top-k restricted to the candidates: enough to time the merge
    # and estimate theta (the biases are in the module docstring).
    k = topk
    total = cand.total
    head_s_pad = np.full((nq, k), -np.inf, dtype=np.float32)
    head_r_pad = np.zeros((nq, k), dtype=np.int32)
    totals = cand_head[:total] + cand.tail[:total]
    tau_final_est = np.full(nq, -np.inf, dtype=np.float32)
    for q in range(nq):
        lo, hi = int(cand.ptr[q]), int(cand.ptr[q + 1])
        if hi == lo:
            continue
        ch = cand_head[lo:hi]
        kk = min(k, hi - lo)
        sel = np.argpartition(-ch, kk - 1)[:kk]
        order = np.argsort(-ch[sel])
        head_s_pad[q, :kk] = ch[sel][order]
        head_r_pad[q, :kk] = cand.rows[lo:hi][sel][order]
        tt = totals[lo:hi]
        tau_final_est[q] = np.partition(-tt, kk - 1)[kk - 1] * -1.0

    t0 = time.perf_counter()
    tau_slack = merge_tau_slack(
        slack_per_term, enc.head_flat_ids, enc.head_flat_counts,
        enc.head_ptr,
    )
    merge_host(
        head_s_pad, head_r_pad, cand, cand_head, lay.num_rows, k,
        tau_slack=tau_slack,
    )
    merge_s = time.perf_counter() - t0

    # --- term-level skip potential (MaxScore split) ---
    t0 = time.perf_counter()
    df = np.diff(lay.post_ptr)
    m_t = np.zeros(len(df), dtype=np.float32)
    nzt = df > 0
    if nzt.any():
        m_t[nzt] = np.maximum.reduceat(
            lay.post_weights, lay.post_ptr[:-1][nzt].astype(np.int64)
        )
    tau0_est = head_s_pad[:, k - 1]
    with np.errstate(invalid="ignore"):
        theta = tau_final_est - tau0_est - tau_slack[:nq]
    finite_theta = theta[np.isfinite(theta)]
    if len(finite_theta) == 0:
        finite_theta = np.zeros(1, dtype=np.float32)
    saved = np.zeros(nq, dtype=np.float64)
    walked = np.zeros(nq, dtype=np.float64)
    for q in range(nq):
        lo, hi = int(enc.tail_ptr[q]), int(enc.tail_ptr[q + 1])
        tids = enc.tail_ids[lo:hi]
        u = m_t[tids] * enc.tail_counts[lo:hi]
        dfs = df[tids].astype(np.float64)
        walked[q] = dfs.sum()
        if not np.isfinite(theta[q]) or theta[q] <= 0:
            continue
        order = np.argsort(u)  # ascending: cheapest bounds first
        csum = np.cumsum(u[order])
        n_skip = int(np.searchsorted(csum, theta[q], side="left"))
        saved[q] = dfs[order][:n_skip].sum()
    # A document outside the head top-k needs tail >= theta to enter the
    # final top-k: the share of candidates an exact post-walk filter keeps.
    kept = [
        (cand.tail[int(cand.ptr[q]) : int(cand.ptr[q + 1])] >= theta[q]).mean()
        if np.isfinite(theta[q]) and cand.ptr[q + 1] > cand.ptr[q]
        else 1.0
        for q in range(nq)
    ]
    analysis_s = time.perf_counter() - t0

    row = {
        "metric": METRIC,
        "num_docs": lay.num_docs,
        "head_terms": lay.head_terms,
        "head_dtype": lay.head_dtype,
        "max_tail_df": lay.max_tail_df,
        "num_queries": nq,
        "prepare_host_merge_s": round(prep_s, 4),
        "encode_ms_per_q": round(1000 * encode_s / nq, 4),
        "walk_ms_per_q": round(1000 * walk_s / nq, 4),
        "cand_head_ms_per_q": round(1000 * cand_head_s / nq, 4),
        "merge_ms_per_q": round(1000 * merge_s / nq, 4),
        "host_total_ms_per_q": round(
            1000 * (encode_s + walk_s + cand_head_s + merge_s) / nq, 4
        ),
        "postings_per_q_mean": round(float(walked.mean()), 1),
        "candidates_per_q_mean": round(total / nq, 1),
        "cand_head_ns_per_gather": round(
            1e9 * cand_head_s
            / max(1, total * max(1.0, np.diff(enc.head_ptr).mean())),
            2,
        ),
        "theta_median": round(float(np.median(finite_theta)), 3),
        "theta_p10": round(float(np.percentile(finite_theta, 10)), 3),
        "theta_finite_frac": round(float(np.isfinite(theta).mean()), 3),
        "skip_fraction_of_postings": round(
            float(saved.sum() / max(walked.sum(), 1)), 4
        ),
        "cand_tail_ge_theta_frac": round(float(np.mean(kept)), 4),
        "postings_per_q_after_skip": round(float((walked - saved).mean()), 1),
        "analysis_s": round(analysis_s, 4),
        "host_runtime": runtime,
        "kernel_launches": launched(),
        "device": device_name(dev),
    }
    log("host stages: " + ", ".join(f"{k} {row[k]}" for k in KEYS[6:12]))
    return row


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench profile-host-scale",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--load-index", required=True)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--topk", type=int, default=50)
    ap.add_argument("--cpu", action="store_true",
                    help="do not require the host runtime (NumPy bodies "
                    "where it does not load)")
    args = ap.parse_args(argv)
    on_card = torch.cuda.is_available() and not args.cpu
    row = run(args.load_index, queries=args.queries, topk=args.topk,
              device="cuda" if on_card else "cpu")
    print(json.dumps(row), flush=True)
    return 0
