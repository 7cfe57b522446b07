"""Driver ``dense_interactive``: a closed loop of one client asking one
question at a time, ``DenseSearchEngine.search({qid: vector}, top_k)``,
over the query pool in turn.

Traffic keys: ``top_k``, ``check_requests`` (answers checked, drawn from
the seed among those of the window), ``trace``."""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np

from perfbench import seeds
from perfbench.drivers._dense import DenseBase


def _row(doc_id: str) -> int:
    """The corpus row a doc id names (the ids are the rows' numbers), -1
    for an id that names none."""
    return int(doc_id) if doc_id.isdigit() else -1


class Driver(DenseBase):
    positive_only = True  # search() keeps scores above 0

    def __init__(self, config, traffic, seed, device, control=False):
        super().__init__(config, traffic, seed, device, control)
        for i in range(traffic.get("warm_requests", 8)):
            self.engine.search({"warm": self.pool[i]}, top_k=self.top_k)
        self.lap("warm")

    def window(self, seconds: float, tracer):
        engine, k, pool = self.engine, self.top_k, self.pool
        attempted = completed = failed = 0
        answers = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if tracer.due(time.perf_counter() - t0):
                tracer.toggle()
            j = attempted % len(pool)
            qid = f"r{attempted}"
            attempted += 1
            try:
                with tracer.span("search"):
                    res = engine.search({qid: pool[j]}, top_k=k)
            except Exception:
                traceback.print_exc(file=sys.stderr)
                res = {}
            answer = res.get(qid)
            answers.append((j, answer))
            if answer is None:
                failed += 1
            else:
                completed += 1
        elapsed = time.perf_counter() - t0
        tracer.finish()
        rng = np.random.default_rng(seeds.derive(self.seed, seeds.SAMPLE))
        n = min(int(self.traffic["check_requests"]), len(answers))
        for pos in sorted(rng.choice(len(answers), n, replace=False)):
            j, answer = answers[pos]
            if answer is None:
                self.kept.append((j, None, None))
            else:
                self.kept.append((j, [_row(d) for d in answer],
                                  list(answer.values())))
        return {"attempted": attempted, "completed": completed,
                "failed": failed, "elapsed_s": elapsed}
