"""Generation quality metrics: ROUGE-1/2/L, BLEU, token-overlap faithfulness
(counterpart of ``osr_tpu/metrics/generation.py``).

Capability parity with reference rag_system/pipeline/evaluate_generation.py
(ROUGE via LCS/n-gram overlap :48-121, sentence BLEU with brevity penalty
:124-163, faithfulness as answer-token coverage by contexts :166-189,
normalization = lowercase, strip punctuation, collapse whitespace :26-45).

Implementation differences: ROUGE-L's LCS uses an O(min(m,n))-space two-row
DP instead of a quadratic table; BLEU's geometric mean runs over non-empty
n-gram orders only.
"""

from __future__ import annotations

import math
import re
import string
from collections import Counter
from typing import Any, Dict, List, Mapping, Sequence


_PUNCT_TABLE = str.maketrans("", "", string.punctuation)
_WS = re.compile(r"\s+")


def normalize_text(text: str) -> str:
    if not text:
        return ""
    return _WS.sub(" ", text.lower().translate(_PUNCT_TABLE)).strip()


def gen_tokenize(text: str) -> List[str]:
    return normalize_text(text).split()


def _lcs_length(a: List[str], b: List[str]) -> int:
    """Longest-common-subsequence length, two-row DP (O(min(m,n)) memory)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        row = [0]
        for j, y in enumerate(b, start=1):
            if x == y:
                row.append(prev[j - 1] + 1)
            else:
                row.append(max(prev[j], row[j - 1]))
        prev = row
    return prev[-1]


def _prf(overlap: int, pred_n: int, ref_n: int) -> Dict[str, float]:
    p = overlap / pred_n if pred_n else 0.0
    r = overlap / ref_n if ref_n else 0.0
    f1 = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return {"f1": f1, "precision": p, "recall": r}


def rouge_l(pred: str, ref: str) -> Dict[str, float]:
    pt, rt = gen_tokenize(pred), gen_tokenize(ref)
    if not pt and not rt:
        return {"f1": 1.0, "precision": 1.0, "recall": 1.0}
    if not pt or not rt:
        return {"f1": 0.0, "precision": 0.0, "recall": 0.0}
    return _prf(_lcs_length(pt, rt), len(pt), len(rt))


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def rouge_n(pred: str, ref: str, n: int = 1) -> Dict[str, float]:
    pt, rt = gen_tokenize(pred), gen_tokenize(ref)
    if not pt and not rt:
        return {"f1": 1.0, "precision": 1.0, "recall": 1.0}
    if not pt or not rt:
        return {"f1": 0.0, "precision": 0.0, "recall": 0.0}
    pn, rn = _ngrams(pt, n), _ngrams(rt, n)
    if not pn or not rn:
        return {"f1": 0.0, "precision": 0.0, "recall": 0.0}
    overlap = sum((pn & rn).values())
    return _prf(overlap, sum(pn.values()), sum(rn.values()))


def bleu(pred: str, ref: str, max_n: int = 4) -> float:
    """Sentence-level BLEU with brevity penalty (reference semantics:
    bp = min(1, len_pred/len_ref); geometric mean over n-gram precisions)."""
    pt, rt = gen_tokenize(pred), gen_tokenize(ref)
    if not pt or not rt:
        return 0.0
    bp = min(1.0, len(pt) / len(rt))
    log_sum, orders = 0.0, 0
    for n in range(1, max_n + 1):
        pn, rn = _ngrams(pt, n), _ngrams(rt, n)
        if not pn:
            continue
        orders += 1
        precision = sum((pn & rn).values()) / sum(pn.values())
        if precision == 0.0:
            return 0.0
        log_sum += math.log(precision)
    if orders == 0:
        return 0.0
    return bp * math.exp(log_sum / orders)


def faithfulness(pred: str, contexts: Sequence[str]) -> Dict[str, Any]:
    """Token-overlap faithfulness: what fraction of answer tokens appear in
    retrieved contexts (reference evaluate_generation.py:166-189)."""
    if not pred or not contexts:
        return {
            "faithfulness_score": 0.0,
            "supporting_contexts": 0,
            "total_contexts": len(contexts),
        }
    pred_tokens = set(gen_tokenize(pred))
    supporting, total_overlap = 0, 0
    for ctx in contexts:
        overlap = len(pred_tokens & set(gen_tokenize(ctx)))
        if overlap:
            supporting += 1
            total_overlap += overlap
    score = total_overlap / len(pred_tokens) if pred_tokens else 0.0
    return {
        "faithfulness_score": min(1.0, score),
        "supporting_contexts": supporting,
        "total_contexts": len(contexts),
    }


def evaluate_generation(
    predictions: Sequence[Mapping[str, Any]],
    references: Mapping[str, str],
) -> Dict[str, Any]:
    """Aggregate generation metrics over prediction records.

    Prediction records carry ``qid``, ``answer`` and optional ``contexts``
    (list of {'docid', 'text'} dicts) — the pipeline's prediction format
    (reference evaluate_rag_pipeline.py:803-812).
    """
    if not predictions:
        return {"error": "No predictions provided"}
    if not references:
        return {"error": "No references provided"}

    scores = {"rouge_l": [], "rouge_1": [], "rouge_2": [], "bleu": [], "faithfulness": []}
    evaluated = 0
    missing = 0
    for pred in predictions:
        qid = pred.get("qid")
        if not qid:
            continue
        if qid not in references:
            missing += 1
            continue
        answer = pred.get("answer", "")
        ref = references[qid]
        if not answer or not ref:
            continue
        scores["rouge_l"].append(rouge_l(answer, ref)["f1"])
        scores["rouge_1"].append(rouge_n(answer, ref, 1)["f1"])
        scores["rouge_2"].append(rouge_n(answer, ref, 2)["f1"])
        scores["bleu"].append(bleu(answer, ref))
        ctx_texts = [
            c["text"]
            for c in pred.get("contexts", [])
            if isinstance(c, Mapping) and "text" in c
        ]
        scores["faithfulness"].append(
            faithfulness(answer, ctx_texts)["faithfulness_score"]
        )
        evaluated += 1

    if evaluated == 0:
        return {"error": "No valid prediction-reference pairs found"}

    mean = lambda xs: sum(xs) / len(xs) if xs else 0.0
    return {
        "total_predictions": len(predictions),
        "evaluated_predictions": evaluated,
        "missing_references": missing,
        **{name: mean(vals) for name, vals in scores.items()},
        "individual_scores": scores,
    }
