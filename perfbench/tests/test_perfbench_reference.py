"""The plain references against brute force at a small size, and the
comparison on answers made wrong on purpose."""

import re
from collections import Counter

import numpy as np
import pytest
import torch

from perfbench import compare
from perfbench.frozen import zipf
from perfbench.reference import dense_int8
from perfbench.reference.sparse_bm25 import SparseReference


def brute_bm25(texts, query, k1, b, head_terms):
    """Dict-and-loop BM25 over an int8 head, in float64."""
    docs = [Counter(re.findall(r"\b\w+\b", t.lower())) for t in texts]
    lengths = [sum(d.values()) for d in docs]
    n, avgdl = len(docs), sum(lengths) / len(docs)
    df = Counter(t for d in docs for t in d)
    order = sorted(df, key=lambda t: (-df[t], t))
    idf = {t: float(np.log((n - df[t] + 0.5) / (df[t] + 0.5))) for t in df}
    f = max(min(head_terms, len(order)), sum(idf[t] <= 0 for t in order))
    head = set(order[:f])
    w = [{t: float(np.float32(idf[t] * tf * (k1 + 1)
                              / (tf + k1 * (1 - b + b * lengths[i] / avgdl))))
          for t, tf in d.items()} for i, d in enumerate(docs)]
    scale = {}
    for t in head:
        m = np.float32(max(abs(x[t]) for x in w if t in x))
        scale[t] = np.float32(m / np.float32(127.0)) if m > 0 else 1.0
    q = Counter(t for t in re.findall(r"\b\w+\b", query.lower()) if t in df)
    out = np.zeros(n)
    for i, x in enumerate(w):
        for t, c in q.items():
            if t not in x:
                continue
            if t in head:
                code = np.clip(np.rint(np.float32(x[t]) / scale[t]), -127, 127)
                out[i] += c * float(scale[t]) * float(code)
            else:
                out[i] += c * x[t]
    return out


def test_sparse_reference_equals_brute_force():
    corpus = zipf.zipf_corpus(11, 300, 2000, avg_len=40, word_prefix="t",
                              min_len=5)
    texts = [d["text"] for d in corpus.values()]
    queries = list(zipf.queries(12, 20, 2000, avg_terms=6, word_prefix="t",
                                min_terms=2).values())
    queries.append("T3 t3, t17 zzz")  # case, punctuation, a repeat, OOV
    ref = SparseReference(texts, k1=1.2, b=0.75, head_terms=64)
    got = ref.scores(queries).numpy()
    for j, q in enumerate(queries):
        want = brute_bm25(texts, q, 1.2, 0.75, 64)
        np.testing.assert_allclose(got[j], want, rtol=1e-12, atol=1e-12)
        assert ref.scale(q) >= np.abs(got[j]).max()


def test_dense_reference_equals_float64_dot():
    g = torch.Generator().manual_seed(5)
    docs = torch.randn((1000, 48), generator=g)
    queries = torch.randn((7, 48), generator=g).numpy()
    d8, ds = dense_int8.quantize_rows(docs)
    assert d8.abs().max() <= 127
    q8, qs = dense_int8.quantize_rows(torch.from_numpy(queries))
    full = (q8 @ d8.T) * qs[:, None] * ds[None, :]
    port = np.array([[3, 999, -1]] * 7)

    def blocks():
        for lo in range(0, 1000, 300):
            yield lo, docs[lo:lo + 300]

    top, of_port = dense_int8.search(queries, port, blocks, 5, "cpu")
    np.testing.assert_array_equal(top, full.topk(5, dim=1).values.numpy())
    np.testing.assert_array_equal(of_port[:, :2], full[:, [3, 999]].numpy())
    assert np.isnan(of_port[:, 2]).all()
    # K7's rule: codes are round(x / scale), half to even, in float32.
    x = torch.tensor([[127.0, 0.5, 1.5, -2.5]])
    assert dense_int8.quantize_rows(x)[0].tolist() == [[127, 0, 2, -2]]


TOP = np.array([5.0, 4.0, 3.0])


@pytest.mark.parametrize("rows, scores, ref, want", [
    ([0, 1, 2], [5.0, 4.0, 3.0], [5.0, 4.0, 3.0], (0.0, 0.0)),
    ([0, 1], [5.0, 4.0], [5.0, 4.0], (0.0, compare.BIG)),  # one missing
    ([0, 1, 9], [5.0, 4.0, 3.0], [5.0, 4.0, 1.0], (2.0 / 10, 2.0 / 10)),
    ([0, 0, 2], [5.0, 5.0, 3.0], [5.0, 5.0, 3.0], (compare.BIG,) * 2),
    ([0, 1, 2], [5.0, 4.0, 3.5], [5.0, 4.0, 3.0], (0.5 / 10, 0.0)),
    ([0, 1, 2, 3], [5.0, 4.0, 3.0, 2.0], [5.0, 4.0, 3.0, 2.0],
     (compare.BIG,) * 2),  # past k
    ([0, 1, 7], [5.0, 4.0, 3.0], [5.0, 4.0, np.nan], (compare.BIG,) * 2),
])
def test_answer_gaps(rows, scores, ref, want):
    got = compare.answer_gaps(rows, scores, ref, TOP, 10.0,
                              positive_only=False)
    assert got == pytest.approx(want)


def test_positive_only_pads_with_zero():
    top = np.array([2.0, -np.inf, -np.inf])  # one positive score
    assert compare.answer_gaps([4], [2.0], [2.0], top, 2.0, True) == (0, 0)
    assert compare.answer_gaps([], [], [], top, 2.0, True) == (0.0, 1.0)
    ok, checks = compare.verdict({"rank_gap": 0.5, "failed": 0.0},
                                 {"rank_gap": 0.4})
    assert not ok and checks["failed"] == {"value": 0.0, "limit": 0.0}
