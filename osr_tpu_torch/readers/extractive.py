"""Extractive answer reader (counterpart of ``osr_tpu/readers/extractive.py``,
on this package's tokenizer).

Capability-parity reimplementation of the reference's
``OptimizedExtractiveReader`` (reference rag_system/core/reader_registry.py:
12-85): pick the best sentence from the top retrieved contexts by a weighted
combination of query-term overlap (0.7), a moderate-length preference (0.2),
and a position bonus (0.1), truncating to ``max_answer_length``.
"""

from __future__ import annotations

import re
from typing import List

from osr_tpu_torch.index.tokenizer import tokenize

_SENTENCE_SPLIT = re.compile(r"[.!?]+")

OVERLAP_WEIGHT = 0.7
LENGTH_WEIGHT = 0.2
POSITION_WEIGHT = 0.1
TARGET_SENTENCE_WORDS = 50
MAX_CONTEXTS = 5
MIN_SENTENCE_CHARS = 10


class ExtractiveReader:
    def __init__(self, max_answer_length: int = 150, **kwargs):
        self.max_answer_length = max_answer_length
        self.use_advanced_extraction = kwargs.get(
            "use_advanced_extraction", True
        )

    def generate_answer(self, query: str, contexts: List[str]) -> str:
        if not contexts or not query:
            return "No sufficient context available."
        if not self.use_advanced_extraction:
            return self._first_snippet(contexts)
        return self._best_sentence(query, contexts)

    def _best_sentence(self, query: str, contexts: List[str]) -> str:
        query_terms = set(tokenize(query))
        best, best_score = "", 0.0
        for context in contexts[:MAX_CONTEXTS]:
            if not context:
                continue
            for sentence in _SENTENCE_SPLIT.split(context):
                sentence = sentence.strip()
                n_chars = len(sentence)
                if (
                    n_chars < MIN_SENTENCE_CHARS
                    or n_chars > self.max_answer_length * 2
                ):
                    continue
                sent_terms = set(tokenize(sentence))
                overlap = (
                    len(query_terms & sent_terms) / len(query_terms)
                    if query_terms
                    else 0.0
                )
                length_score = min(
                    1.0, TARGET_SENTENCE_WORDS / max(1, len(sentence.split()))
                )
                score = (
                    OVERLAP_WEIGHT * overlap
                    + LENGTH_WEIGHT * length_score
                    + POSITION_WEIGHT * 1.0
                )
                if score > best_score:
                    best_score = score
                    best = sentence
        if best:
            if len(best) > self.max_answer_length:
                words = best.split()
                return " ".join(words[: self.max_answer_length // 8]) + "..."
            return best
        return self._first_snippet(contexts)

    def _first_snippet(self, contexts: List[str]) -> str:
        first = contexts[0] or ""
        if not first:
            return "Unable to extract answer."
        snippet = first[: self.max_answer_length]
        return snippet + ("..." if len(first) > self.max_answer_length else "")
