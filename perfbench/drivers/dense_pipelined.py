"""Driver ``dense_pipelined``: a closed loop of one client driving
``DenseSearchEngine.dispatch_vectors`` / ``collect_vectors`` over fixed
batches of the query pool, with ``ahead`` batches dispatched before the
oldest is collected, as ``HybridRetriever`` does.

Traffic keys: ``batch`` (the pool holds a whole number of batches, taken
in turn), ``top_k``, ``ahead``, ``check_per_batch`` (rows of each
collected batch kept for the check, drawn from the seed), ``trace``."""

from __future__ import annotations

import collections
import sys
import time
import traceback

import numpy as np

from perfbench import seeds
from perfbench.drivers._dense import DenseBase


class Driver(DenseBase):
    def __init__(self, config, traffic, seed, device, control=False):
        super().__init__(config, traffic, seed, device, control)
        b = int(traffic["batch"])
        if len(self.pool) % b:
            raise ValueError(f"a pool of {len(self.pool)} queries is not a "
                             f"whole number of batches of {b}")
        self.batches = [self.pool[i:i + b] for i in range(0, len(self.pool), b)]
        for q in self.batches[: traffic.get("warm_batches", 2)]:
            self.engine.collect_vectors(
                self.engine.dispatch_vectors(q, self.top_k))
        self.lap("warm")

    def window(self, seconds: float, tracer):
        engine, k = self.engine, self.top_k
        b = int(self.traffic["batch"])
        ahead = int(self.traffic["ahead"])
        m = int(self.traffic["check_per_batch"])
        flight = collections.deque()
        stats = {"attempted": 0, "completed": 0, "failed": 0, "batches": 0}

        def collect():
            i, handle = flight.popleft()
            try:
                with tracer.span("collect"):
                    scores, rows = engine.collect_vectors(handle)
            except Exception:
                traceback.print_exc(file=sys.stderr)
                scores = rows = None
            rng = np.random.default_rng(
                seeds.derive(self.seed, seeds.SAMPLE, i))
            first = (i % len(self.batches)) * b
            for pos in rng.choice(b, m, replace=False):
                if rows is None:
                    self.kept.append((first + pos, None, None))
                else:
                    self.kept.append((first + pos, rows[pos].tolist(),
                                      scores[pos].tolist()))
            if rows is None or len(rows) != b:
                stats["failed"] += b
            else:
                stats["completed"] += b

        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            if tracer.due(time.perf_counter() - t0):
                while flight:
                    collect()
                tracer.toggle()
            q = self.batches[i % len(self.batches)]
            stats["attempted"] += b
            try:
                with tracer.span("dispatch"):
                    flight.append((i, engine.dispatch_vectors(q, k)))
            except Exception:
                traceback.print_exc(file=sys.stderr)
                stats["failed"] += b
            i += 1
            if len(flight) > ahead:
                collect()
        while flight:
            collect()
        elapsed = time.perf_counter() - t0
        tracer.finish()
        stats["batches"] = i
        return {**stats, "elapsed_s": elapsed}
