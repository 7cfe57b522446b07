"""What the two dense drivers share: the set-up (corpus and query pool
from the seed, the engine over the corpus, the corpus's f32 rows dropped)
and the check against the plain int8 reference."""

from __future__ import annotations

import gc

import numpy as np
import torch

from perfbench import compare, gen_dense
from perfbench.drivers import Laps
from perfbench.reference import dense_int8


class DenseBase:
    positive_only = False

    def __init__(self, config, traffic, seed: int, device, control=False):
        from osr_tpu_torch.retrieval.engine import DenseSearchEngine

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        c, q = config["corpus"], config["queries"]
        engine_cfg = dict(config["engine"])
        if control:
            engine_cfg.update(config["control"].get("engine", {}))
        self.top_k = int(traffic["top_k"])
        self.lap = Laps()
        if self.device.type == "cuda":
            from osr_tpu_torch.ops import _build

            _build.build_all()  # every kernel and the host runtime
        self.lap("build or load kernels")
        docs = gen_dense.corpus(seed, c["num_docs"], c["dim"],
                                c["block_rows"], self.device)
        self.pool = gen_dense.query_pool(seed, docs, q["pool"],
                                         q["noise_norm"])
        self.lap("generate")
        doc_ids = [str(i) for i in range(c["num_docs"])]
        self.lap("doc ids")
        self.engine = DenseSearchEngine(
            doc_ids, docs, device=self.device, **engine_cfg,
        )
        del docs
        if self.device.type == "cuda":
            if self.engine.backend != "cuda":
                raise RuntimeError("the engine does not take the CUDA "
                                   "kernels")
            torch.cuda.empty_cache()
        self.lap("engine")
        self.kept = []  # (pool row, rows, scores) or (pool row, None)

    def shapes(self):
        c = self.config["corpus"]
        return {"batch": int(self.traffic.get("batch", 1)),
                "docs": c["num_docs"], "dim": c["dim"]}

    def release(self):
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self):
        c = self.config["corpus"]
        n, dim = c["num_docs"], c["dim"]
        got = [(p, rows) for p, rows, _ in self.kept if rows is not None]
        m = max([len(rows) for _, rows in got] or [1])
        port = np.full((max(len(got), 1), m), -1, dtype=np.int64)
        queries = np.zeros((max(len(got), 1), dim), dtype=np.float32)
        for i, (p, rows) in enumerate(got):
            rows = np.asarray(rows, dtype=np.int64)
            port[i, :len(rows)] = np.where((rows >= 0) & (rows < n), rows, -1)
            queries[i] = self.pool[p]

        def blocks():
            for b, lo, rows in gen_dense.block_bounds(n, c["block_rows"]):
                yield lo, gen_dense.corpus_block(self.seed, b, rows, dim,
                                                 self.device)

        top, of_port = dense_int8.search(queries, port, blocks, self.top_k,
                                         self.device)
        answers, i = [], 0
        for _, rows, scores in self.kept:
            if rows is None:
                answers.append(None)
                continue
            # Unit queries and unit rows: no score exceeds 1 in size.
            answers.append((list(rows), list(scores),
                            of_port[i, :len(rows)], top[i], 1.0))
            i += 1
        self.checked = len(answers)
        return compare.judge(answers, positive_only=self.positive_only)
