"""Flight control of the port's run_pipelined
(osr_tpu_torch/retrieval/pipeline_util.py): the cases of
tests/test_pipeline_util.py, each also run through osr_tpu's
run_pipelined on the same inputs, which must dispatch and collect the same
chunks in the same order with the same number in flight."""

import pytest

from osr_tpu.retrieval.pipeline_util import run_pipelined as jax_run
from osr_tpu_torch.retrieval.pipeline_util import run_pipelined


def _trace(run, pending, chunk_size, depth):
    """The (event, chunk, chunks in flight) sequence of one run."""
    events, outstanding = [], []

    def dispatch(chunk):
        outstanding.append(tuple(chunk))
        events.append(("d", tuple(chunk), len(outstanding)))
        return tuple(chunk)

    def collect(chunk, handle):
        assert tuple(chunk) == handle
        outstanding.remove(handle)
        events.append(("c", handle, len(outstanding)))

    run(pending, chunk_size, dispatch, collect, depth=depth)
    assert not outstanding
    return events


def test_all_items_dispatched_and_collected_in_order():
    events = []
    collected = []
    run_pipelined(
        list(range(10)),
        3,
        lambda chunk: events.append(("d", tuple(chunk))) or tuple(chunk),
        lambda chunk, h: collected.append((tuple(chunk), h)),
        depth=1,
    )
    assert [h for _, h in collected] == [
        (0, 1, 2), (3, 4, 5), (6, 7, 8), (9,),
    ]
    # chunk passed to collect equals the dispatched chunk
    assert all(c == h for c, h in collected)
    assert _trace(run_pipelined, list(range(10)), 3, 1) == _trace(
        jax_run, list(range(10)), 3, 1
    )


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
def test_depth_bounds_in_flight(depth):
    """At most depth+1 chunks may be un-collected at any dispatch, as in
    osr_tpu."""
    outstanding = []
    max_seen = 0

    def dispatch(chunk):
        outstanding.append(chunk)
        nonlocal max_seen
        max_seen = max(max_seen, len(outstanding))
        return None

    run_pipelined(
        list(range(20)),
        2,
        dispatch,
        lambda chunk, h: outstanding.remove(chunk),
        depth=depth,
    )
    assert not outstanding
    assert max_seen == depth + 1  # collect fires after the next dispatch
    got = _trace(run_pipelined, list(range(20)), 2, depth)
    assert got == _trace(jax_run, list(range(20)), 2, depth)
    assert max(n for e, _, n in got if e == "d") == depth + 1


def test_empty_pending_is_noop():
    run_pipelined([], 4, lambda c: 1 / 0, lambda c, h: 1 / 0)
    assert _trace(run_pipelined, [], 4, 4) == _trace(jax_run, [], 4, 4) == []
