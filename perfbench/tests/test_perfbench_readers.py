"""Each metric's reader on a canned trace summary: the values worked out by
hand, and nothing where the trace has nothing to read."""

import pytest

from perfbench import cell as C
from perfbench import trace as T

K2_NAME = "void head_wgmma_kernel<true, 0>(CUtensorMap, CUtensorMap, ...)"
K1_NAME = "_Z17head_wgmma_kernelILb1ELi2EEv14CUtensorMap_st"
K5_NAME = "void similarity_wgmma_kernel<false, true>(CUtensorMap, ...)"
K7_NAME = "void quantize_rows_kernel<false, true>(float const*, ...)"
SORT = "void at::native::bitonicSortKVInPlace<...>"


def record(ops, spans=None, busy=0.5, window=2.0, shapes=None):
    return {"setup_s": 12.5,
            "window": {"completed": 1000, "elapsed_s": 4.0},
            "shapes": shapes or {},
            "trace": {"window_s": window, "busy_s": busy, "ops": ops,
                      "spans": spans or {}, "idle": {}}}


SPARSE = {"batch": 3328, "rows": 57728, "head_width": 2048,
          "head_bytes": 57728 * 2048}
DENSE = {"batch": 1024, "docs": 2_681_468, "dim": 768}


def test_end_to_end_readers():
    r = record({})
    assert C.reader("setup_s")(r) == 12.5
    assert C.reader("sparse_qps.host")(r) == 250.0
    assert C.reader("dense_qps")(r) == 250.0
    assert C.reader("dense_request_ms")(r) == 4.0


def test_device_time_a_query_needs_the_whole_window_traced():
    # 0.5 s of device time over 1,000 queries = 500 us a query.
    r = {**record({}, busy=0.5), "trace_is_window": True}
    assert C.reader("sparse_device_us")(r) == pytest.approx(500.0)
    assert C.reader("sparse_device_us")(record({}, busy=0.5)) is None
    r = {**record({}, busy=0.0), "trace_is_window": True}
    assert C.reader("sparse_device_us")(r) is None


@pytest.mark.parametrize("name", ["device_idle_pct.sparse",
                                  "device_idle_pct.dense",
                                  "device_idle_pct.interactive"])
def test_idle(name):
    assert C.reader(name)(record({}, busy=0.5, window=2.0)) == 75.0
    assert C.reader(name)(record({}, busy=0.0)) is None
    assert C.reader(name)({"trace": None}) is None


def test_k2_and_k1_rooflines():
    # K1 reads its own launches only: K2's (the block-max variant) are not
    # K1's. 0.795671 ms of bf16 work in 0.795671 ms a launch = 100%.
    r = record({K2_NAME: [4, 4 * 1.591342e-3], SORT: [4, 1e-3]},
               shapes=SPARSE)
    assert C.reader("k1_roofline")(r) is None
    r = record({K1_NAME: [2, 2 * 0.795671e-3]}, shapes=SPARSE)
    assert C.reader("k1_roofline")(r) == pytest.approx(100.0, rel=1e-5)


def test_k5_roofline_and_selection():
    ops = {K5_NAME: [10, 10 * 7.793538e-3], K7_NAME: [10, 0.01],
           SORT: [20, 0.1], "Memcpy HtoD (Pinned -> Device)": [10, 0.5]}
    r = record(ops, spans={"dispatch": 10, "collect": 10}, shapes=DENSE)
    assert C.reader("k5_roofline")(r) == pytest.approx(50.0, rel=1e-5)
    # Only the sort counts: 0.1 s over 10 batches.
    assert C.reader("select_ms.dense")(r) == pytest.approx(10.0)
    assert C.reader("select_ms.dense")(record(ops, shapes=DENSE)) is None


def test_reduce_events():
    # Stretch 0-1000 ns; device busy 100-300 and 250-400 (union 300 ns)
    # and 600-700; host spans: search 0-500, collect 500-900.
    ev = [(T.STRETCH, False, 0, 1000, True),
          (T.PREFIX + "search", False, 0, 500, True),
          (T.PREFIX + "collect", False, 500, 900, True),
          (T.PREFIX + "search", True, 0, 500, True),
          ("k_a", True, 100, 300, False), ("k_b", True, 250, 400, False),
          ("k_a", True, 600, 700, False), ("cpu_op", False, 10, 20, False)]
    s = T.reduce_events(ev)
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx(400e-9)
    assert s["ops"] == {"k_a": [2, pytest.approx(300e-9)],
                        "k_b": [1, pytest.approx(150e-9)]}
    assert s["spans"] == {"search": 1, "collect": 1}
    assert s["idle"]["search"] == pytest.approx(200e-9)
    assert s["idle"]["collect"] == pytest.approx(300e-9)
    assert s["idle"][T.HARNESS] == pytest.approx(100e-9)
    b = T.breakdown(s)
    assert b["device_ops"][0][0] == "k_a"
    assert [n for n, _ in b["idle_gaps"]] == ["collect", "search",
                                             T.HARNESS]
