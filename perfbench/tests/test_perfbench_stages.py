"""The program's spans in a trace (``perfbench/stages.py``): the reduction
worked out by hand on synthetic events, the readers on hand-built
records, and the tool end to end on the CPU at tiny sizes (and on the
card, marked ``cuda``)."""

import pytest

from perfbench import stages as S
from perfbench import trace as T


def ev(name, dev, s, e, ann=False, thread=1):
    return (name, dev, s, e, ann, thread)


# Stretch 0-1000 ns. Host, thread 1: perfbench.search 0-800 > osr.sparse.
# search 50-750 > encode 60-100, merge 400-700. Device: a kernel 100-300,
# a copy 650-900, and the device copy of the merge span (an annotation).
NESTED = [
    ev(T.STRETCH, False, 0, 1000, True),
    ev(T.PREFIX + "search", False, 0, 800, True),
    ev("osr.sparse.search", False, 50, 750, True),
    ev("osr.sparse.encode", False, 60, 100, True),
    ev("osr.sparse.merge", False, 400, 700, True),
    ev("osr.sparse.merge", True, 400, 700, True),
    ev("kernel", True, 100, 300),
    ev("Memcpy DtoH", True, 650, 900),
    ev("aten::sort", False, 420, 480),
]


def test_osr_device_annotations_stay_out_of_busy():
    with_copy = T.reduce_events([e[:5] for e in NESTED])
    without = T.reduce_events([e[:5] for e in NESTED
                                if not (e[0].startswith("osr.") and e[1])])
    assert with_copy == without
    assert with_copy["busy_s"] == pytest.approx(450e-9)
    assert set(with_copy["ops"]) == {"kernel", "Memcpy DtoH"}
    assert with_copy["spans"] == {"search": 1}


def test_self_and_idle_time_of_nested_spans():
    out = S.reduce_program(NESTED)
    p = out["program"]
    assert set(p) == {"osr.sparse.search", "osr.sparse.encode",
                      "osr.sparse.merge"}
    # search 50-750 less encode (40) and merge (300): 360 ns of self time
    # (50-60, 100-400, 700-750), of it the kernel's 100-300 and the
    # copy's 700-750 busy.
    assert p["osr.sparse.search"]["self_s"] == pytest.approx(360e-9)
    assert p["osr.sparse.search"]["idle_s"] == pytest.approx(110e-9)
    assert p["osr.sparse.search"]["total_s"] == pytest.approx(700e-9)
    assert p["osr.sparse.encode"]["self_s"] == pytest.approx(40e-9)
    assert p["osr.sparse.encode"]["idle_s"] == pytest.approx(40e-9)
    # merge 400-700: the copy covers 650-700; its device annotation and the
    # host op inside it count as nothing.
    assert p["osr.sparse.merge"]["self_s"] == pytest.approx(300e-9)
    assert p["osr.sparse.merge"]["idle_s"] == pytest.approx(250e-9)
    assert p["osr.sparse.merge"]["count"] == 1
    assert p["osr.sparse.merge"]["durations_s"] == [pytest.approx(300e-9)]
    # Innermost attribution: the benchmark's search keeps 0-50 and
    # 750-800 (50 of it busy); the harness 800-1000 less the copy's
    # 800-900.
    idle = out["idle"]
    assert idle["search"] == pytest.approx(50e-9)
    assert idle["osr.sparse.search"] == pytest.approx(110e-9)
    assert idle["osr.sparse.merge"] == pytest.approx(250e-9)
    assert idle["osr.sparse.encode"] == pytest.approx(40e-9)
    assert idle[T.HARNESS] == pytest.approx(100e-9)
    # Every idle nanosecond goes to exactly one place.
    assert sum(idle.values()) == pytest.approx(1e-6 - 450e-9)
    assert S.idle_gaps(idle)[0] == ["osr.sparse.merge",
                                    pytest.approx(250e-9)]


def test_without_program_spans_idle_is_reduce_events():
    """Unnested benchmark spans alone: the innermost span is the only
    one, so the attribution is ``trace.reduce_events``'s."""
    events = [ev(T.STRETCH, False, 0, 1000, True),
              ev(T.PREFIX + "dispatch", False, 0, 500, True),
              ev(T.PREFIX + "collect", False, 500, 900, True),
              ev(T.PREFIX + "dispatch", True, 0, 500, True),
              ev("k_a", True, 100, 300), ev("k_b", True, 250, 400),
              ev("k_a", True, 600, 700), ev("cpu_op", False, 10, 20)]
    want = T.reduce_events([e[:5] for e in events])["idle"]
    got = S.reduce_program(events)
    assert got["program"] == {}
    assert got["idle"] == pytest.approx(want)


def test_spans_on_two_threads_nest_apart():
    events = [ev(T.STRETCH, False, 0, 1000, True),
              ev("osr.dense.search", False, 0, 600, True, thread=1),
              ev("osr.dense.wait", False, 100, 400, True, thread=2),
              ev("kernel", True, 500, 550)]
    p = S.reduce_program(events)["program"]
    assert p["osr.dense.search"]["self_s"] == pytest.approx(600e-9)
    assert p["osr.dense.wait"]["self_s"] == pytest.approx(300e-9)
    assert p["osr.dense.search"]["idle_s"] == pytest.approx(550e-9)


def span(total, self_s=None, count=1, durations=None):
    return {"count": count, "total_s": total,
            "self_s": total if self_s is None else self_s, "idle_s": 0.0,
            "durations_s": durations or [total / count] * count}


def record(program, busy=0.01, whole=True, counters=None):
    window = {"completed": 1000, "elapsed_s": 2.0}
    if counters is not None:
        window["counters"] = counters
    return {"window": window, "trace_is_window": whole,
            "trace": {"window_s": 2.0, "busy_s": busy, "ops": {},
                      "spans": {}, "idle": {}, "program": program}}


SPARSE_READERS = {
    "encode_us.sparse": "osr.sparse.encode",
    "tail_walk_us.sparse": "osr.sparse.tail_walk",
    "cand_dots_us.sparse": "osr.sparse.cand_dots",
    "merge_us.sparse": "osr.sparse.merge",
    "dicts_us.sparse": "osr.sparse.dicts",
    "device_wait_us.sparse": "osr.sparse.wait",
}


@pytest.mark.parametrize("name", sorted(SPARSE_READERS))
def test_sparse_stage_reader(name):
    read = S.READERS[name][0]
    # 0.02 s of self time over the window's 1,000 queries = 20 us a query.
    program = {SPARSE_READERS[name]: span(0.05, self_s=0.02)}
    assert read(record(program)) == pytest.approx(20.0)
    assert read(record({})) is None
    assert read(record(program, busy=0.0)) is None
    assert read(record(program, whole=False)) is None
    assert read({"window": {"completed": 1000}, "trace": None}) is None


def test_interactive_readers():
    program = {
        "osr.dense.search": span(1.5, count=1000,
                                 durations=[1e-3] * 950 + [2e-3] * 50),
        "osr.dense.dispatch": span(0.2, self_s=0.15, count=1000),
        "osr.dense.wait": span(0.9, count=1000),
        "osr.dense.dicts": span(0.03, count=1000),
    }
    r = record(program, whole=False)

    def read(name, rec=r):
        return S.READERS[name][0](rec)

    assert read("dispatch_us.interactive") == pytest.approx(200.0)
    assert read("device_wait_us.interactive") == pytest.approx(900.0)
    assert read("dicts_us.interactive") == pytest.approx(30.0)
    assert read("request_p95_ms.interactive") == pytest.approx(1.05)
    for name in ("dispatch_us.interactive", "device_wait_us.interactive",
                 "dicts_us.interactive", "request_p95_ms.interactive"):
        assert read(name, record(program, busy=0.0)) is None
        assert read(name, record({})) is None
    no_search = {k: v for k, v in program.items() if k != "osr.dense.search"}
    assert read("dicts_us.interactive", record(no_search)) is None


def test_candidates_per_query():
    read = S.READERS["candidates_per_query.sparse"][0]
    c = {"queries": 6648, "batches": 2, "tail_candidates": 6648 * 272,
         "redispatches": 0}
    assert read(record({}, counters=c)) == pytest.approx(272.0)
    assert read(record({})) is None
    assert read(record({}, counters={**c, "queries": 0})) is None


@pytest.mark.parametrize("name", ["fiqa-bm25.top1000",
                                  "nq-contriever-int8.interactive"])
def test_tool_on_the_cpu(tiny_cell, name):
    """A tiny run on the CPU: the program's spans are in the trace, no
    device operation is, so only the counter's reader reads."""
    line = S.run_cell(tiny_cell(name), 2**33 + 17, 1.0, device="cpu")
    assert line["busy_s"] == 0.0 and line["device"] == "cpu"
    if name.startswith("fiqa"):
        p = line["program"]
        calls = line["window"]["calls"]
        assert p["osr.sparse.search"]["count"] == calls
        # 256 queries a call in batches of 128: two of each stage a call.
        for stage in ("encode", "tail_walk", "dispatch", "cand_dots",
                      "wait", "merge", "dicts"):
            assert p["osr.sparse." + stage]["count"] == 2 * calls, stage
        c = line["window"]["counters"]
        assert c["queries"] == line["window"]["completed"]
        assert c["batches"] == 2 * calls
        assert set(line["values"]) == {"candidates_per_query.sparse"}
    else:
        p = line["program"]
        assert p["osr.dense.search"]["count"] == line["spans"]["search"]
        assert "counters" not in line["window"]
        assert line["values"] == {}
    names = [n for n, _ in line["idle_gaps"]]
    assert any(n.startswith("osr.") for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fiqa-bm25.top1000",
                                  "nq-contriever-int8.interactive"])
def test_tool_on_the_card(card, tiny_cell, name):
    """A tiny run on the card: every reader of the cell reads."""
    line = S.run_cell(tiny_cell(name), 2**33 + 17, 2.0, device="cuda")
    assert line["busy_s"] > 0
    want = {n for n, (_, _, where) in S.READERS.items() if where == name}
    assert set(line["values"]) == want
