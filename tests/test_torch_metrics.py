"""The port's metrics (osr_tpu_torch/metrics/), mirrored from
tests/test_metrics.py on both packages, and from
tests/test_reference_metrics_replay.py: every IR metric against that
file's brute-force trec_eval implementations and against osr_tpu's, on
seeded ranked lists shaped like the reference's committed FiQA run (648
queries, top 100, tied scores included). Results must be equal (IR
metrics to 1e-12, generation metrics exactly)."""

import importlib
import math

import numpy as np
import pytest

from tests.test_reference_metrics_replay import (
    _brute_map,
    _brute_ndcg,
    _brute_precision,
    _brute_recall,
    _constructed_qrels,
)

PACKAGES = ("osr_tpu", "osr_tpu_torch")


@pytest.fixture(params=PACKAGES)
def m(request):
    """Both packages' metric functions, under one namespace."""
    ir = importlib.import_module(f"{request.param}.metrics.ir")
    gen = importlib.import_module(f"{request.param}.metrics.generation")

    class NS:
        pass

    ns = NS()
    for mod in (ir, gen):
        for name in dir(mod):
            setattr(ns, name, getattr(mod, name))
    return ns


def test_ndcg_hand_computed(m):
    results = {"q1": {"d1": 3.0, "d2": 2.0, "d3": 1.0}}
    qrels = {"q1": {"d1": 1, "d3": 2}}
    idcg = 2 + 1 / math.log2(3)
    assert m.ndcg_at_k(results, qrels, 10) == pytest.approx(2.0 / idcg)


def test_ndcg_tie_break_desc_doc_id(m):
    results = {"q1": {"a": 1.0, "b": 1.0}}
    assert m.ndcg_at_k(results, {"q1": {"b": 1}}, 1) == pytest.approx(1.0)
    assert m.ndcg_at_k(results, {"q1": {"a": 1}}, 1) == pytest.approx(0.0)


def test_zero_relevant_query_dropped_everywhere(m):
    results = {"q1": {"d1": 1.0}, "q2": {"d1": 1.0}}
    qrels = {"q1": {"d1": 1}, "q2": {"dX": 0}}
    assert m.ndcg_at_k(results, qrels, 10) == pytest.approx(1.0)
    assert m.map_at_k(results, qrels, 10) == pytest.approx(1.0)
    assert m.precision_at_k(results, qrels, 1) == pytest.approx(1.0)
    assert m.recall_at_k(results, qrels, 10) == pytest.approx(1.0)


def test_map_normalized_by_total_relevant(m):
    results = {"q1": {"d1": 1.0}}
    qrels = {"q1": {"d1": 1, "d2": 1, "d3": 1}}
    assert m.map_at_k(results, qrels, 10) == pytest.approx(1 / 3)


def test_map_recall_precision(m):
    results = {"q1": {"d1": 3.0, "d2": 2.0, "d3": 1.0, "d4": 0.5}}
    qrels = {"q1": {"d1": 1, "d3": 1, "d9": 1}}
    assert m.map_at_k(results, qrels, 10) == pytest.approx((1 + 2 / 3) / 3)
    assert m.recall_at_k(results, qrels, 10) == pytest.approx(2 / 3)
    assert m.precision_at_k(results, qrels, 2) == pytest.approx(1 / 2)
    assert m.recall_at_k(results, qrels, 1) == pytest.approx(1 / 3)


def test_evaluate_retrieval_keys(m):
    results = {"q1": {"d1": 1.0}}
    qrels = {"q1": {"d1": 1}}
    out = m.evaluate_retrieval(results, qrels, k_values=(10, 100))
    assert set(out) == {
        "ndcg@10", "map@10", "recall@10", "p@10",
        "ndcg@100", "map@100", "recall@100", "p@100",
    }
    assert out["ndcg@10"] == pytest.approx(1.0)
    assert out["recall@10"] == pytest.approx(1.0)


def test_query_missing_from_results_skipped(m):
    assert m.ndcg_at_k({}, {"q1": {"d1": 1}}, 10) == 0.0


def test_rouge_l(m):
    assert m.rouge_l("the cat sat", "the cat sat")["f1"] == pytest.approx(1.0)
    r = m.rouge_l("a b c d", "a x c y")
    assert r["precision"] == pytest.approx(0.5)
    assert r["recall"] == pytest.approx(0.5)
    assert m.rouge_l("", "")["f1"] == 1.0
    assert m.rouge_l("x", "")["f1"] == 0.0
    assert m.rouge_l("The CAT, sat!", "the cat sat")["f1"] == pytest.approx(1.0)


def test_rouge_n(m):
    assert m.rouge_n("a b c", "a b d", n=1)["precision"] == pytest.approx(2 / 3)
    assert m.rouge_n("a b c", "a b d", n=2)["precision"] == pytest.approx(1 / 2)


def test_bleu(m):
    assert m.bleu("the cat sat on the mat", "the cat sat on the mat") == pytest.approx(1.0)
    assert m.bleu("completely different words here", "the cat sat") == 0.0
    assert m.bleu("the cat", "the cat sat on the mat") < 1.0


def test_faithfulness(m):
    f = m.faithfulness("the cat sat", ["the cat sat on a mat", "dogs bark"])
    assert f["faithfulness_score"] == pytest.approx(1.0)
    assert f["supporting_contexts"] == 1
    assert m.faithfulness("unrelated answer", ["the cat sat"])["faithfulness_score"] == 0.0


def test_evaluate_generation(m):
    preds = [
        {"qid": "q1", "answer": "the cat sat",
         "contexts": [{"docid": "d1", "text": "the cat sat on a mat"}]},
        {"qid": "q2", "answer": "no ref for me"},
    ]
    refs = {"q1": "the cat sat"}
    out = m.evaluate_generation(preds, refs)
    assert out["evaluated_predictions"] == 1
    assert out["missing_references"] == 1
    assert out["rouge_l"] == pytest.approx(1.0)
    assert out["bleu"] == pytest.approx(1.0)
    assert m.evaluate_generation([], refs)["error"]
    assert m.evaluate_generation(preds, {})["error"]


# ---------------------------------------------------------------------------
# Replay: seeded ranked lists shaped like the reference's committed run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranked_lists():
    """648 queries x up to 100 scored docs; scores rounded to 2 decimals
    so ties occur, and a few empty lists."""
    rng = np.random.RandomState(5)
    out = {}
    for q in range(648):
        n = 0 if q % 97 == 0 else int(rng.randint(1, 101))
        docs = rng.choice(5_000, size=n, replace=False)
        out[f"q{q}"] = {
            f"d{d}": float(round(s, 2)) for d, s in zip(docs, rng.gamma(2.0, 3.0, n))
        }
    return out


@pytest.mark.parametrize("k", [1, 10, 100])
def test_ir_metrics_match_bruteforce_and_osr_tpu(ranked_lists, k):
    from osr_tpu.metrics import ir as want
    from osr_tpu_torch.metrics import ir as got

    qrels = _constructed_qrels(ranked_lists)
    for name, brute in (
        ("ndcg_at_k", _brute_ndcg),
        ("map_at_k", _brute_map),
        ("recall_at_k", _brute_recall),
        ("precision_at_k", _brute_precision),
    ):
        value = getattr(got, name)(ranked_lists, qrels, k)
        assert value == getattr(want, name)(ranked_lists, qrels, k)
        assert value == pytest.approx(brute(ranked_lists, qrels, k), abs=1e-12)


def test_generation_metrics_match_osr_tpu(ranked_lists):
    from osr_tpu.metrics.generation import evaluate_generation as want
    from osr_tpu_torch.metrics.generation import evaluate_generation as got

    rng = np.random.RandomState(9)
    words = ["the", "fund", "bond", "rate", "etf", "tax", "pays", "a", "of", "."]
    preds, refs = [], {}
    for i in range(200):
        answer = " ".join(rng.choice(words, rng.randint(0, 15)))
        preds.append({"qid": f"q{i}", "answer": answer, "contexts": [
            {"docid": "d", "text": " ".join(rng.choice(words, 12))}]})
        if i % 7:
            refs[f"q{i}"] = " ".join(rng.choice(words, rng.randint(1, 15)))
    assert got(preds, refs) == want(preds, refs)
