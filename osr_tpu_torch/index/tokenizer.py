"""Tokenization identical to the reference pipeline (counterpart of
``osr_tpu/index/tokenizer.py``): ``re.findall(r'\\b\\w+\\b', text.lower())``.

ASCII text goes through the C++ tokenizer of the shared runtime when it is
available, which produces the same tokens; anything else uses the regex.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

from osr_tpu_torch import native

_TOKEN_RE = re.compile(r"\b\w+\b")


def tokenize(text: str, *, use_native: bool = True) -> List[str]:
    """Lowercase word tokenization, identical to the reference pipeline."""
    if not text:
        return []
    if use_native and text.isascii():
        try:
            return native.ascii_tokenize(text)
        except ImportError:
            pass
    return _TOKEN_RE.findall(text.lower())


def term_counts(text: str) -> Counter:
    """Unique-term counts of a text (the reference's ``Counter(tokens)``)."""
    return Counter(tokenize(text))


class Tokenizer:
    """Maps query strings to sorted (term_id, count) pairs against a fixed
    vocabulary; out-of-vocabulary terms are dropped."""

    def __init__(self, vocabulary: Dict[str, int]):
        self.vocabulary = vocabulary

    @classmethod
    def build(cls, texts: Iterable[str]) -> Tuple["Tokenizer", List[List[str]]]:
        """A tokenizer over the sorted set of every token of ``texts`` (the
        reference's vocabulary, as ``osr_tpu``'s ``Tokenizer.build``), and
        each text's token list, so callers do not tokenize twice."""
        token_lists: List[List[str]] = []
        vocab_set: set = set()
        for text in texts:
            toks = tokenize(text)
            token_lists.append(toks)
            vocab_set.update(toks)
        vocab = {term: idx for idx, term in enumerate(sorted(vocab_set))}
        return cls(vocab), token_lists

    def __len__(self) -> int:
        return len(self.vocabulary)

    def encode_counts(self, text: str) -> List[Tuple[int, float]]:
        pairs = [
            (self.vocabulary[term], float(count))
            for term, count in term_counts(text).items()
            if term in self.vocabulary
        ]
        pairs.sort()
        return pairs

    def encode_batch(
        self, texts: Sequence[str]
    ) -> List[List[Tuple[int, float]]]:
        return [self.encode_counts(t) for t in texts]
