"""The comparison that decides ``correct``: each answer the program gave,
judged by what the reference says of the same query.

For one answer (the program's rows in its order, with its scores), with
the reference's top-k scores and the reference's score of each row the
program returned, each divided by the query's scale (the most that any
document's score could move, as the cell's traffic driver states it):

- ``score_gap``: the widest distance between a score the program returned
  and the reference's score of that row;
- ``rank_gap``: the widest distance by which the reference's score of the
  program's i-th row lies below the reference's i-th best score. A row
  that is missing, repeated, out of range, or returned past k counts as
  ``BIG``. Where the program keeps only positive scores, positions past
  the reference's last positive score are 0 on both sides.

``unanswered`` counts the sampled answers that never came."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

BIG = 1e6


def answer_gaps(rows: Sequence[int], scores: Sequence[float],
                ref_of_rows: Sequence[float], ref_top: np.ndarray,
                norm: float, positive_only: bool):
    """(score_gap, rank_gap) of one answer."""
    k = len(ref_top)
    floor = 0.0 if positive_only else -np.inf
    top = np.where(np.isfinite(ref_top), ref_top, floor)
    if positive_only:
        top = np.maximum(top, 0.0)
    norm = float(norm) if norm > 0 else 1.0
    rows = list(rows)
    if len(rows) > k or len(set(rows)) != len(rows):
        return BIG, BIG
    ref_of_rows = np.asarray(ref_of_rows, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    if not np.all(np.isfinite(ref_of_rows)):
        return BIG, BIG
    got = np.full(k, floor)
    got[:len(rows)] = ref_of_rows
    with np.errstate(invalid="ignore"):
        gaps = (top - got) / norm
    rank = float(np.nan_to_num(gaps, nan=BIG, posinf=BIG).max(initial=0.0))
    score = float(np.abs(scores - ref_of_rows).max(initial=0.0)) / norm
    return min(score, BIG), min(max(rank, 0.0), BIG)


def judge(answers: List[tuple], positive_only: bool) -> Dict[str, float]:
    """The numbers compared over ``answers``: each (rows, scores,
    reference's scores of rows, reference's top-k, query scale), or None
    for an answer that never came."""
    score_gap = rank_gap = 0.0
    unanswered = 0
    for a in answers:
        if a is None:
            unanswered += 1
            continue
        s, r = answer_gaps(*a, positive_only=positive_only)
        score_gap, rank_gap = max(score_gap, s), max(rank_gap, r)
    return {"score_gap": score_gap, "rank_gap": rank_gap,
            "unanswered": float(unanswered)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit. ``unanswered`` and ``failed`` have the limit 0."""
    checks = {}
    ok = True
    for name, value in numbers.items():
        limit = float(limits.get(name, 0.0))
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, checks
