"""Driver ``sparse_counted``: the closed loop of ``sparse_search`` over a
corpus of millions of documents, with the engine's counters over the
window.

What differs from ``sparse_search``: the corpus is made in bulk on the
device (``gen_sparse.py``, the frozen generator's law; its cached blocks
are returned before the engine plans from the free memory), the answers are
judged by the reference built in blocks (``reference/sparse_bm25_bulk.py``),
and the window record carries ``counters``, the difference of the engine's
``stats()["counters"]`` over the window (empty where the engine counts
nothing). The query sets, the loop and the sampled answers are
``sparse_search``'s.

Traffic keys: those of ``sparse_search``, and ``warm_calls`` (calls made at
set-up, default 1)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import compare, gen_sparse, seeds
from perfbench.drivers import Laps, sparse_search
from perfbench.frozen import zipf
from perfbench.reference.sparse_bm25_bulk import BulkSparseReference


class Driver(sparse_search.Driver):
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
        self.corpus = gen_sparse.corpus(
            seed, c["num_docs"], c["vocab"], c["avg_doc_terms"],
            c["min_doc_terms"], c["word_prefix"], self.device,
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

            # The generator's blocks stay in torch's cache unless returned:
            # the engine plans its chunks from the card's free memory.
            torch.cuda.empty_cache()

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

    def _counters(self):
        return dict(self.engine.stats().get("counters") or {})

    def window(self, seconds: float, tracer):
        before = self._counters()
        out = super().window(seconds, tracer)
        after = self._counters()
        out["counters"] = {k: v - before.get(k, 0) for k, v in after.items()}
        return out

    def numbers(self):
        i = self.config["index"]
        doc_ids = list(self.corpus)
        ref = BulkSparseReference(
            [self.corpus[d] for d in doc_ids], k1=i["k1"], b=i["b"],
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
        del masked
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
