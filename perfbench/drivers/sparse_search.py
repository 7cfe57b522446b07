"""Driver ``sparse_search``: a closed loop of one client calling
``SparseSearchEngine.search({qid: text}, top_k)`` over whole seeded query
sets, one set a call, the sets in turn. The engine cuts each call into
batches of its bucket and keeps them in flight with its own pipelining.

Traffic keys: ``queries_per_call``, ``query_sets`` (made at set-up, each
from its own seed), ``top_k``, ``check_per_call`` (answers of each call
kept for the check, positions drawn from the seed), ``trace`` (``start_s``,
``length_s``; unused where the cell traces the whole window)."""

from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np
import torch

from perfbench import compare, seeds
from perfbench.drivers import Laps
from perfbench.frozen import zipf
from perfbench.reference.sparse_bm25 import SparseReference

ROW_TILE = 128  # the head kernels' row tile: rows sweep in 128s


class Driver:
    def __init__(self, config, traffic, seed: int, device, control=False):
        from osr_tpu_torch.index.builder import SparseIndexBuilder
        from osr_tpu_torch.retrieval.engine import SparseSearchEngine

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        c, q = config["corpus"], config["queries"]
        index_cfg = dict(config["index"])
        if control:
            index_cfg.update(config["control"].get("index", {}))
        self.top_k = int(traffic["top_k"])
        lap = Laps()
        self.corpus = zipf.zipf_corpus(
            seeds.derive32(seed, seeds.CORPUS), c["num_docs"], c["vocab"],
            avg_len=c["avg_doc_terms"], word_prefix=c["word_prefix"],
            min_len=c["min_doc_terms"],
        )
        self.sets = [
            zipf.queries(
                seeds.derive32(seed, seeds.QUERIES, i),
                traffic["queries_per_call"], c["vocab"],
                avg_terms=q["avg_terms"], word_prefix=c["word_prefix"],
                min_terms=q["min_terms"],
            )
            for i in range(traffic["query_sets"])
        ]
        lap("generate")
        if self.device.type == "cuda":
            from osr_tpu_torch.ops import _build

            _build.build_all()  # every kernel and the host runtime
        lap("build or load kernels")
        index = SparseIndexBuilder(**index_cfg).build(self.corpus)
        lap("index")
        self.engine = SparseSearchEngine(
            index, device=self.device, **config["engine"]
        )
        lap("engine")
        if self.device.type == "cuda" and self.engine.head_backend != "cuda":
            raise RuntimeError("the engine does not take the CUDA kernels")
        for s in self.sets[: traffic.get("warm_calls", 1)]:
            self.engine.search(s, top_k=self.top_k)
        lap("warm")
        self.kept = []

    def shapes(self):
        c, i = self.config["corpus"], self.config["index"]
        rows = -(-c["num_docs"] // ROW_TILE) * ROW_TILE
        width = i["head_terms"]
        return {"batch": max(self.config["engine"]["batch_sizes"]),
                "rows": rows, "head_width": width,
                "head_bytes": rows * width}

    def window(self, seconds: float, tracer):
        engine, k = self.engine, self.top_k
        per_set = len(self.sets[0])
        m = int(self.traffic["check_per_call"])
        attempted = completed = failed = calls = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if tracer.due(time.perf_counter() - t0):
                tracer.toggle()
            s = calls % len(self.sets)
            queries = self.sets[s]
            attempted += per_set
            try:
                with tracer.span("search"):
                    res = engine.search(queries, top_k=k)
            except Exception:  # a failed call fails all its queries
                traceback.print_exc(file=sys.stderr)
                res = {}
            got = len(queries.keys() & res.keys())
            completed += got
            failed += per_set - got
            rng = np.random.default_rng(
                seeds.derive(self.seed, seeds.SAMPLE, calls))
            for pos in rng.choice(per_set, m, replace=False):
                qid = f"q{pos}"
                self.kept.append((s, qid, res.get(qid)))
            calls += 1
        elapsed = time.perf_counter() - t0
        tracer.finish()
        return {"attempted": attempted, "completed": completed,
                "failed": failed, "elapsed_s": elapsed, "calls": calls}

    def release(self):
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self):
        c, i = self.config["corpus"], self.config["index"]
        doc_ids = list(self.corpus)
        ref = SparseReference(
            [self.corpus[d]["text"] for d in doc_ids], k1=i["k1"], b=i["b"],
            head_terms=i["head_terms"], device=self.device,
        )
        row_of = {d: r for r, d in enumerate(doc_ids)}
        keys = sorted({(s, qid) for s, qid, _ in self.kept})
        slot = {key: j for j, key in enumerate(keys)}
        texts = [self.sets[s][qid] for s, qid in keys]
        scales = [ref.scale(t) for t in texts]
        scores = ref.scores(texts)
        masked = scores.masked_fill(scores <= 0, float("-inf"))
        kk = min(self.top_k, ref.num_docs)
        top = masked.topk(kk, dim=1).values.cpu().numpy()
        answers = []
        for s, qid, res in self.kept:
            if res is None:
                answers.append(None)
                continue
            j = slot[(s, qid)]
            rows = [row_of.get(d, -1) for d in res]
            valid = torch.tensor([max(r, 0) for r in rows],
                                 dtype=torch.int64, device=scores.device)
            ref_rows = scores[j, valid].cpu().numpy()
            ref_rows[np.asarray(rows, dtype=np.int64) < 0] = np.nan
            answers.append((rows, list(res.values()), ref_rows, top[j],
                            scales[j]))
        self.checked = len(answers)
        return compare.judge(answers, positive_only=True)
