"""The sparse cells' corpus made in bulk on the device, for corpora whose
tokens the frozen generator would take minutes to make.

The law is ``frozen/zipf.py:zipf_corpus``'s: document lengths gamma(2,
avg_len / 2) cut to whole terms, at least ``min_len``; each term drawn
independently by Zipf's law, probability proportional to 1 / rank over
``vocab`` ranks, by the inverse of its cumulative sum; rank r written as the
word ``<prefix><r - 1>`` (the sum can round below 1, so the word
``<prefix><vocab>`` can occur, as there). The draws come from NumPy's
``Generator`` (lengths) and torch's generator on ``device`` (terms), not
from ``RandomState``, and the text is assembled as bytes on the device: the
frozen generator's Python loop costs about a microsecond a token, five
minutes at MS MARCO passage's 495M tokens.

The corpus is ``{"doc<i>": text}``, terms separated by one space."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from perfbench import seeds

BLOCK_DOCS = 1 << 20  # documents assembled at once on the device


def doc_lengths(seed: int, num_docs: int, avg_len: float,
                min_len: int) -> np.ndarray:
    """Terms in each document: gamma(2, avg_len / 2) cut to whole terms,
    at least ``min_len``."""
    rng = np.random.default_rng(seeds.derive(seed, seeds.CORPUS))
    return np.maximum(
        min_len, rng.gamma(2.0, avg_len / 2.0, size=num_docs).astype(np.int64))


def _word_bytes(ids: torch.Tensor, prefix: bytes, vocab: int):
    """(buffer, byte offset of each term) of the words of ``ids``, each
    followed by one space."""
    dev = ids.device
    digits = torch.ones_like(ids)
    power = 10
    while power <= vocab:
        digits += ids >= power
        power *= 10
    slot = len(prefix) + digits + 1
    ends = torch.cumsum(slot, 0)
    starts = ends - slot
    buf = torch.full((int(ends[-1]),), ord(" "), dtype=torch.uint8,
                     device=dev)
    for j, c in enumerate(prefix):
        buf[starts + j] = c
    rest, last = ids.clone(), starts + len(prefix) + digits - 1
    for p in range(int(digits.max())):
        here = p < digits
        buf[(last - p)[here]] = (48 + rest % 10)[here].to(torch.uint8)
        rest //= 10
    return buf, starts


def blocks(seed: int, num_docs: int, vocab: int, avg_len: float,
           min_len: int, word_prefix: str, device,
           block_docs: int = BLOCK_DOCS) -> Iterator[Tuple[int, list]]:
    """(first document, texts) of each block of the corpus, in order."""
    dev = torch.device(device)
    lengths = doc_lengths(seed, num_docs, avg_len, min_len)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    cum = torch.from_numpy(np.cumsum(probs)).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seeds.derive(seed, seeds.CORPUS, 1))
    prefix = word_prefix.encode("ascii")
    for lo in range(0, num_docs, block_docs):
        n = lengths[lo:lo + block_docs]
        u = torch.rand(int(n.sum()), dtype=torch.float64, generator=g,
                       device=dev)
        ids = torch.searchsorted(cum, u)
        del u
        buf, starts = _word_bytes(ids, prefix, vocab)
        first = np.concatenate([[0], np.cumsum(n)[:-1]])
        begin = starts[torch.from_numpy(first).to(dev)].cpu().numpy()
        end = np.append(begin[1:], buf.numel()) - 1  # less the last space
        text = buf.cpu().numpy().tobytes().decode("ascii")
        del buf, starts, ids
        yield lo, [text[a:b] for a, b in zip(begin.tolist(), end.tolist())]


def corpus(seed: int, num_docs: int, vocab: int, avg_len: float,
           min_len: int, word_prefix: str, device) -> Dict[str, str]:
    """The whole corpus, ``{"doc<i>": text}``."""
    out: Dict[str, str] = {}
    for lo, texts in blocks(seed, num_docs, vocab, avg_len, min_len,
                            word_prefix, device):
        out.update(zip((f"doc{lo + i}" for i in range(len(texts))), texts))
    return out
