"""Seeded synthetic corpora and queries (counterpart of
``osr_tpu/testing.py:SyntheticDataGenerator``): Zipf-distributed term
streams, identical to ``osr_tpu``'s for the same seed, used by the tests
and ``chip_smoke.py``."""

from __future__ import annotations

from typing import Dict

import numpy as np

from osr_tpu_torch.index.dense import synthetic_corpus_embeddings


class SyntheticDataGenerator:
    """Zipf-distributed corpora/queries and clustered embeddings, seeded."""

    def __init__(self, seed: int = 42):
        self.seed = seed

    def zipf_corpus(
        self,
        num_docs: int,
        vocab_size: int = 10_000,
        avg_len: int = 100,
        word_prefix: str = "term",
        min_len: int = 3,
    ) -> Dict[str, Dict[str, str]]:
        rng = np.random.RandomState(self.seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        probs /= probs.sum()
        cum = np.cumsum(probs)
        lengths = np.maximum(
            min_len,
            rng.gamma(2.0, avg_len / 2.0, size=num_docs).astype(np.int64),
        )
        total = int(lengths.sum())
        token_ids = np.searchsorted(cum, rng.rand(total))
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        corpus = {}
        for d in range(num_docs):
            ids = token_ids[offsets[d] : offsets[d + 1]]
            corpus[f"doc{d}"] = {
                "text": " ".join(f"{word_prefix}{i}" for i in ids),
                "title": f"Document {d}",
            }
        return corpus

    def queries(
        self,
        num_queries: int,
        vocab_size: int = 10_000,
        avg_terms: int = 8,
        word_prefix: str = "term",
        min_terms: int = 1,
    ) -> Dict[str, str]:
        rng = np.random.RandomState(self.seed + 1)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        probs /= probs.sum()
        cum = np.cumsum(probs)
        out = {}
        for i in range(num_queries):
            n = max(min_terms, int(rng.poisson(avg_terms)))
            ids = np.searchsorted(cum, rng.rand(n))
            out[f"q{i}"] = " ".join(f"{word_prefix}{j}" for j in ids)
        return out

    def embeddings(self, num_docs: int, dim: int = 768) -> np.ndarray:
        return synthetic_corpus_embeddings(num_docs, dim, seed=self.seed)
