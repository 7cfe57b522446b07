"""The port's result-dict assembler (osr_tpu_torch/retrieval/results.py):
the cases of tests/test_results_assembly.py against the per-element
oracle, each also run through osr_tpu's assembler on the same inputs,
which must give equal dicts with the same insertion order."""

import numpy as np

from osr_tpu.retrieval import results as jres
from osr_tpu_torch.retrieval.results import (
    as_object_names,
    assemble_result_dicts,
)


def _oracle(doc_ids, ids, scores, mask):
    out = []
    for row in range(ids.shape[0]):
        d = {}
        for i, s, m in zip(ids[row], scores[row], mask[row]):
            if m:
                d[doc_ids[int(i)]] = float(s)
        out.append(d)
    return out


def _both(doc_ids, ids, scores, mask):
    """The port's dicts, after checking osr_tpu's equal to them with the
    same key order."""
    got = assemble_result_dicts(as_object_names(doc_ids), ids, scores, mask)
    want = jres.assemble_result_dicts(
        jres.as_object_names(doc_ids), ids, scores, mask
    )
    assert got == want
    assert [list(d.items()) for d in got] == [list(d.items()) for d in want]
    return got


def test_matches_oracle_random():
    rng = np.random.default_rng(42)
    n, b, k = 200, 17, 10
    doc_ids = [f"doc{i}" for i in range(n)]
    ids = rng.integers(0, n, (b, k)).astype(np.int32)
    scores = rng.standard_normal((b, k)).astype(np.float32)
    mask = scores > 0
    assert _both(doc_ids, ids, scores, mask) == _oracle(
        doc_ids, ids, scores, mask
    )


def test_empty_mask_rows_and_all_masked():
    doc_ids = ["a", "b", "c"]
    ids = np.array([[0, 1], [2, 2]], dtype=np.int32)
    scores = np.array([[1.0, 2.0], [3.0, 4.0]], dtype=np.float32)
    none = np.zeros((2, 2), dtype=bool)
    assert _both(doc_ids, ids, scores, none) == [{}, {}]
    all_on = np.ones((2, 2), dtype=bool)
    got = _both(doc_ids, ids, scores, all_on)
    assert got == [{"a": 1.0, "b": 2.0}, {"c": 4.0}]  # later dup wins


def test_insertion_order_is_row_major():
    doc_ids = ["x", "y", "z"]
    ids = np.array([[2, 0, 1]], dtype=np.int32)
    scores = np.array([[9.0, 8.0, 7.0]], dtype=np.float32)
    mask = np.ones((1, 3), dtype=bool)
    (d,) = _both(doc_ids, ids, scores, mask)
    assert list(d.items()) == [("z", 9.0), ("x", 8.0), ("y", 7.0)]


def test_float_conversion_matches_tolist():
    # f32 -> Python float must equal np.float32.tolist() semantics.
    doc_ids = ["a"]
    s = np.array([[np.float32(0.1)]], dtype=np.float32)
    ids = np.zeros((1, 1), dtype=np.int32)
    (d,) = _both(doc_ids, ids, s, np.ones((1, 1), bool))
    assert d["a"] == s.tolist()[0][0]


def test_as_object_names_passthrough():
    arr = np.array(["a", "b"], dtype=object)
    assert as_object_names(arr) is arr
    assert jres.as_object_names(arr) is arr
    lst = as_object_names(["a", "b"])
    assert lst.dtype == object and lst.tolist() == ["a", "b"]
    want = jres.as_object_names(["a", "b"])
    assert want.dtype == lst.dtype and want.tolist() == lst.tolist()
