"""Bounded dispatch/collect pipelining (counterpart of
``osr_tpu/retrieval/pipeline_util.py``): chunk the pending queries by the
largest batch size, launch each chunk's device step asynchronously, and
collect a chunk once more than ``depth`` are in flight, so host work
(tokenize, tail postings, candidate head dots, merge) overlaps device work
without unbounded device memory."""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, TypeVar

T = TypeVar("T")


def run_pipelined(
    pending: Sequence[T],
    chunk_size: int,
    dispatch: Callable[[List[T]], object],
    collect: Callable[[List[T], object], None],
    depth: int = 4,
) -> None:
    """Dispatch ``pending`` in ``chunk_size`` chunks, collecting each chunk
    once more than ``depth`` are in flight (and all of them at the end)."""
    in_flight: List[Tuple[List[T], object]] = []
    for i in range(0, len(pending), chunk_size):
        chunk = list(pending[i : i + chunk_size])
        in_flight.append((chunk, dispatch(chunk)))
        if len(in_flight) > depth:
            collect(*in_flight.pop(0))
    while in_flight:
        collect(*in_flight.pop(0))
