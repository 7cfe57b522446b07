"""The pieces of the row-chunked sparse cells (``msmarco-bm25.top1000``)
and of ``fiqa-bm25.batch``: their readers on canned records, the corpus
made in bulk, the reference built in blocks against the plain one, the
``sparse_counted`` driver's counters on the CPU, and both cells resolving
through ``cell.py``."""

import numpy as np
import pytest
import torch

from perfbench import cell as C
from perfbench import gen_sparse, run
from perfbench.frozen import work, zipf
from perfbench.reference.sparse_bm25 import SparseReference
from perfbench.reference.sparse_bm25_bulk import BulkSparseReference

K2_NAME = "void head_wgmma_kernel<true, 0>(CUtensorMap_st, CUtensorMap_st, ...)"
K2_MANGLED = "_Z17head_wgmma_kernelILb1ELi0EEv14CUtensorMap_st"
K1_NAME = "void head_wgmma_kernel<true, 2>(CUtensorMap_st, CUtensorMap_st, ...)"
SORT = "void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<...>"
COPY = "Memcpy DtoH (Device -> Pinned)"
FIQA = {"batch": 3328, "rows": 57728, "head_width": 2048,
        "head_bytes": 57728 * 2048}
MSMARCO = {"batch": 3496, "rows": 8841856, "head_width": 2048,
           "head_bytes": 8841856 * 2048}
SEED = 2**33 + 17
NEW_CELLS = ["fiqa-bm25.batch", "msmarco-bm25.top1000"]


def record(ops, counters=None, whole=True, completed=6980, shapes=MSMARCO):
    window = {"completed": completed, "elapsed_s": 10.0}
    if counters is not None:
        window["counters"] = counters
    return {"setup_s": 150.0, "window": window, "shapes": shapes,
            "trace": {"window_s": 10.0, "busy_s": 1.0, "ops": ops,
                      "spans": {}, "idle": {}},
            "trace_is_window": whole}


def bound(shapes, blockmax):
    ops, nbytes = work.head_work(shapes["batch"], shapes["rows"],
                                 shapes["head_width"], shapes["head_bytes"],
                                 blockmax=blockmax)
    return work.bound_s(ops, nbytes, work.PEAK_BF16_FLOPS)[0]


# Readers ------------------------------------------------------------------


@pytest.mark.parametrize("name", [K2_NAME, K2_MANGLED])
def test_k2_roofline(name):
    # Two launches, each at twice the least time: 50%.
    t = bound(FIQA, True)
    r = record({name: [2, 4 * t], K1_NAME: [1, 1.0]}, shapes=FIQA)
    assert C.reader("k2_roofline")(r) == pytest.approx(50.0)
    assert C.reader("k2_roofline")(record({K1_NAME: [2, 1.0]},
                                          shapes=FIQA)) is None
    assert C.reader("k2_roofline")({"trace": None, "shapes": FIQA}) is None


def test_head_roofline_counts_the_whole_head_a_batch():
    read = C.reader("head_roofline.msmarco")
    c = {"queries": 13960, "batches": 4, "chunk_sweeps": 16}
    # K2 in 16 sweeps over 4 batches, at twice the least time a batch.
    t = bound(MSMARCO, True)
    r = record({K2_NAME: [16, 8 * t], SORT: [32, 1.0]}, counters=c)
    assert read(r) == pytest.approx(50.0)
    # K1 (the parent's plan) is counted without the block maxima.
    t1 = bound(MSMARCO, False)
    r = record({K1_NAME: [168, 4 * t1]}, counters=c)
    assert read(r) == pytest.approx(100.0)
    assert read(record({SORT: [1, 1.0]}, counters=c)) is None
    assert read(record({K2_NAME: [16, 1.0]})) is None  # no counters
    assert read(record({K2_NAME: [16, 1.0]}, counters=c,
                       whole=False)) is None


def test_chunk_sweeps_a_batch():
    read = C.reader("chunk_sweeps.msmarco")
    c = {"queries": 13960, "batches": 4, "chunk_sweeps": 16}
    assert read(record({}, counters=c)) == 4.0
    assert read(record({}, counters={**c, "chunk_sweeps": 0})) == 0.0
    # the parent's engine has no such counter
    assert read(record({}, counters={"queries": 13960, "batches": 4})) is None
    assert read(record({}, counters={**c, "batches": 0})) is None
    assert read(record({})) is None


def test_select_us_leaves_out_the_head_kernels_and_copies():
    read = C.reader("select_us.msmarco")
    ops = {K2_NAME: [16, 0.9], K1_NAME: [1, 0.1], COPY: [4, 0.05],
           "Memset (Device)": [2, 0.01], SORT: [32, 0.6],
           "void at::native::gather<...>": [16, 0.098]}
    # 0.698 s over 6,980 queries
    assert read(record(ops)) == pytest.approx(1e6 * 0.698 / 6980)
    assert read(record(ops, whole=False)) is None
    assert read(record({K2_NAME: [16, 0.9]})) is None
    assert read(record(ops, completed=0)) is None


# The corpus made in bulk --------------------------------------------------


def test_bulk_corpus_follows_the_frozen_law():
    c = gen_sparse.corpus(SEED, 20_000, 5_000, 56.45, 5, "t", "cpu")
    assert list(c)[:2] == ["doc0", "doc1"] and len(c) == 20_000
    texts = list(c.values())
    lengths = np.array([len(t.split(" ")) for t in texts])
    want = gen_sparse.doc_lengths(SEED, 20_000, 56.45, 5)
    np.testing.assert_array_equal(lengths, want)
    assert lengths.min() >= 5 and abs(lengths.mean() - 55.98) < 0.8
    words = " ".join(texts).split(" ")
    assert all(w.startswith("t") and w[1:].isdigit() for w in words[:5000])
    ranks = np.array([int(w[1:]) for w in words])
    assert ranks.max() <= 5_000
    # Zipf's law: rank 1 ("t0") takes 1 / H(5,000) of the tokens.
    h = (1.0 / np.arange(1, 5_001)).sum()
    assert np.mean(ranks == 0) == pytest.approx(1.0 / h, rel=0.03)
    assert np.mean(ranks == 9) == pytest.approx(0.1 / h, rel=0.1)
    again = gen_sparse.corpus(SEED, 20_000, 5_000, 56.45, 5, "t", "cpu")
    assert again == c
    other = gen_sparse.corpus(SEED + 1, 20_000, 5_000, 56.45, 5, "t", "cpu")
    assert other != c


def test_bulk_corpus_is_the_same_in_blocks():
    whole = [t for _, b in gen_sparse.blocks(3, 2_500, 700, 20, 5, "w",
                                             "cpu", block_docs=2_500)
             for t in b]
    split = [t for _, b in gen_sparse.blocks(3, 2_500, 700, 20, 5, "w",
                                             "cpu", block_docs=1_000)
             for t in b]
    assert [len(t.split()) for t in whole] == [len(t.split()) for t in split]
    assert all(w.startswith("w") for t in split[:50] for w in t.split())


# The reference built in blocks --------------------------------------------


def test_bulk_reference_equals_the_plain_reference():
    texts = list(gen_sparse.corpus(7, 6_000, 3_000, 40, 5, "t",
                                   "cpu").values())
    texts[3] = "Hello, WORLD t5 T5 x_y 12 ab"  # case, punctuation
    texts[4] = ""
    plain = SparseReference(texts, k1=0.82, b=0.68, head_terms=256)
    bulk = BulkSparseReference(texts, k1=0.82, b=0.68, head_terms=256,
                               block_docs=2_500)
    assert bulk.head_terms == plain.head_terms
    assert torch.equal(bulk.ptr, plain.ptr)
    assert torch.equal(bulk.docs, plain.docs)
    assert torch.equal(bulk.values, plain.values)
    np.testing.assert_array_equal(bulk.term_max, plain.term_max)
    queries = list(zipf.queries(3, 40, 3_000, avg_terms=6, word_prefix="t",
                                min_terms=1).values())
    queries += ["world HELLO zz t5 t5 averylongtoken", ""]
    assert torch.equal(bulk.scores(queries), plain.scores(queries))
    assert [bulk.scale(q) for q in queries] == [plain.scale(q)
                                                for q in queries]


@pytest.mark.parametrize("text", ["café t1", "t1 abcdefghi"])
def test_bulk_reference_refuses_what_it_cannot_hold(text):
    with pytest.raises(ValueError):
        BulkSparseReference(["t1 t2", text], k1=1.2, b=0.75, head_terms=4)


# The cells ----------------------------------------------------------------


def shrink_sparse(cell, num_docs):
    c = cell.config
    c["corpus"].update(num_docs=num_docs, vocab=12000)
    c["index"]["head_terms"] = 512
    c["engine"]["batch_sizes"] = [128]
    cell.traffic.update(queries_per_call=256, query_sets=2)
    return cell


@pytest.mark.parametrize("name", NEW_CELLS)
def test_new_cells_resolve(name):
    bench = C.load_bench()
    cell = C.Cell(bench, name)
    assert [m["name"] for m in cell.end_to_end] == ["sparse_device_us",
                                                    "setup_s"]
    layer = {m["name"] for m in cell.per_layer}
    assert {"sparse_qps.host", "device_idle_pct.sparse"} <= layer
    if name == "fiqa-bm25.batch":
        assert cell.traffic["driver"] == "sparse_search"
        assert cell.traffic["query_sets"] * 0.21 > 10  # no set repeats
        assert "k2_roofline" in layer
    else:
        assert cell.traffic["driver"] == "sparse_counted"
        assert cell.config["corpus"]["num_docs"] == 8_841_823
        assert cell.config["engine"] == {"batch_sizes": [3496],
                                         "cache_queries": False}
        assert {"head_roofline.msmarco", "chunk_sweeps.msmarco",
                "select_us.msmarco"} <= layer
    assert cell.traffic["top_k"] == (50 if "batch" in name else 1000)


def test_sparse_counted_counts_the_window_on_the_cpu():
    cell = shrink_sparse(C.Cell(C.load_bench(), "msmarco-bm25.top1000"),
                         3000)
    line = run.execute(cell, SEED, 1.0, True, device="cpu")
    assert line["correct"], line["checks"]
    # the CPU gives no device trace: no device metric reads; the counters'
    # does (the CPU engine plans no chunks: 0 sweeps a batch)
    assert line["metrics"]["chunk_sweeps.msmarco"]["value"] == 0.0
    assert "head_roofline.msmarco" not in line["metrics"]


def test_sparse_counted_window_record():
    from perfbench.drivers import sparse_counted
    from perfbench.trace import Tracer

    cell = shrink_sparse(C.Cell(C.load_bench(), "msmarco-bm25.top1000"),
                         3000)
    drv = sparse_counted.Driver(cell.config, cell.traffic, SEED,
                                torch.device("cpu"))
    w = drv.window(0.5, Tracer(False, 0.0, 1.0, torch.device("cpu")))
    c = w["counters"]
    assert c["queries"] == w["completed"] == 256 * w["calls"]
    assert c["batches"] == 2 * w["calls"] and c["chunk_sweeps"] == 0
    assert c["tail_candidates"] > 0
    drv.release()
    numbers = drv.numbers()
    assert numbers["unanswered"] == 0 and numbers["score_gap"] < 0.008


@pytest.mark.parametrize("name", NEW_CELLS)
def test_new_cells_control_is_not_correct(name):
    cell = shrink_sparse(C.Cell(C.load_bench(), name), 3000)
    line = run.execute(cell, SEED, 1.0, False, device="cpu", control=True)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", NEW_CELLS)
def test_fault_in_new_cells_is_not_correct(monkeypatch, name, kind):
    """``test_perfbench_runs.py``'s planted sparse faults, in the new
    cells (its table of faults names the cells it had)."""
    from perfbench.tests.test_perfbench_runs import sparse_fault

    cls, attr, broken = sparse_fault(kind)
    cell = shrink_sparse(C.Cell(C.load_bench(), name), 3000)
    monkeypatch.setattr(cls, attr, broken)
    line = run.execute(cell, SEED, 1.0, False, device="cpu")
    assert not line["correct"], (kind, line["checks"])
