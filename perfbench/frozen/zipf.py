"""Frozen copy of ``osr_tpu_torch/testing.py:SyntheticDataGenerator``'s
``zipf_corpus`` and ``queries`` at commit 7b0e7eb585b0, called with the
arguments of ``osr_tpu_torch/bench/common.py:make_corpus`` and
``make_queries`` at that commit (average document 130 terms, at least 5;
average query 11 terms, at least 2; words ``t<rank>``). The two methods are
unchanged except that they are module functions taking the seed."""

from __future__ import annotations

from typing import Dict

import numpy as np


def zipf_corpus(
    seed: int,
    num_docs: int,
    vocab_size: int = 10_000,
    avg_len: int = 100,
    word_prefix: str = "term",
    min_len: int = 3,
) -> Dict[str, Dict[str, str]]:
    rng = np.random.RandomState(seed)
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
    offsets = np.concatenate([[0], np.cumsum(lengths)]).tolist()
    # Each word is formatted once, not once per token (searchsorted can
    # return vocab_size where the cumulative sum rounds below 1).
    words = [f"{word_prefix}{i}" for i in range(vocab_size + 1)]
    tokens = list(map(words.__getitem__, token_ids.tolist()))
    corpus = {}
    for d in range(num_docs):
        corpus[f"doc{d}"] = {
            "text": " ".join(tokens[offsets[d] : offsets[d + 1]]),
            "title": f"Document {d}",
        }
    return corpus


def queries(
    seed: int,
    num_queries: int,
    vocab_size: int = 10_000,
    avg_terms: int = 8,
    word_prefix: str = "term",
    min_terms: int = 1,
) -> Dict[str, str]:
    rng = np.random.RandomState(seed + 1)
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
