"""Plain BM25 over a text corpus: the reference of the sparse cells.

From the corpus texts it works out again what the program derives:
tokens (``\\b\\w+\\b`` on lowercased text), document lengths, document
frequencies, Robertson's IDF ``log((N - df + 0.5) / (df + 0.5))``, each
(document, term) weight ``idf * tf (k1 + 1) / (tf + k1 (1 - b + b dl /
avgdl))`` stored as float32, terms ranked by descending document
frequency (ties alphabetical), the first ``head_terms`` of them (and at
least every term of non-positive IDF) quantized per column as the
configuration states (int8: scale ``max |w| / 127``, codes ``rint(w /
scale)`` clipped to [-127, 127]), the rest kept exactly. A query's score
for a document is the sum over its distinct terms of count x weight, in
float64.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

TOKEN = re.compile(r"\b\w+\b")
QUERY_CHUNK = 64  # queries scored at once


def tokenize(text: str) -> List[str]:
    return TOKEN.findall(text.lower())


class SparseReference:
    """The reference index of one corpus, term-major, on ``device``."""

    def __init__(self, texts: Sequence[str], *, k1: float, b: float,
                 head_terms: int, head_dtype: str = "int8", device="cpu"):
        if head_dtype != "int8":
            raise ValueError(f"the reference states an int8 head, not "
                             f"{head_dtype}")
        self.device = torch.device(device)
        n = len(texts)
        temp: Dict[str, int] = {}
        lengths = np.empty(n, dtype=np.int64)
        parts = []
        for i, text in enumerate(texts):
            toks = tokenize(text)
            lengths[i] = len(toks)
            parts.append([temp.setdefault(t, len(temp)) for t in toks])
        flat = np.fromiter((t for p in parts for t in p), dtype=np.int64,
                           count=int(lengths.sum()))
        docs = np.repeat(np.arange(n, dtype=np.int64), lengths)
        v = len(temp)
        pairs, tf = np.unique(docs * v + flat, return_counts=True)
        doc, tid = pairs // v, pairs % v
        df = np.bincount(tid, minlength=v)
        terms = list(temp)
        order = sorted(range(v), key=lambda i: (-int(df[i]), terms[i]))
        rank = np.empty(v, dtype=np.int64)
        rank[np.asarray(order, dtype=np.int64)] = np.arange(v)
        self.vocabulary = {terms[t]: int(rank[t]) for t in range(v)}
        term = rank[tid]

        idf = np.log((n - df + 0.5) / (df + 0.5))[tid]
        dl = lengths[doc].astype(np.float64)
        avgdl = float(lengths.mean())
        tf = tf.astype(np.float64)
        w = (idf * tf * (k1 + 1.0)
             / (tf + k1 * (1.0 - b + b * dl / avgdl))).astype(np.float32)

        n_nonpos = int((np.log((n - df + 0.5) / (df + 0.5)) <= 0).sum())
        f = max(min(head_terms, v), n_nonpos)
        self.head_terms = f
        head = term < f
        colmax = np.zeros(f, dtype=np.float32)
        np.maximum.at(colmax, term[head], np.abs(w[head]))
        scale = np.where(colmax > 0, colmax / np.float32(127.0),
                         np.float32(1.0)).astype(np.float32)
        codes = np.clip(np.rint(w[head] / scale[term[head]]), -127, 127)
        value = w.astype(np.float64)
        value[head] = scale[term[head]].astype(np.float64) * codes

        by_term = np.lexsort((doc, term))
        ptr = np.zeros(v + 1, dtype=np.int64)
        np.cumsum(np.bincount(term, minlength=v), out=ptr[1:])
        self.num_docs = n
        # The largest |weight| of each term: a query's scale is the sum of
        # count x this over its terms, the most any score could reach.
        self.term_max = np.zeros(v)
        np.maximum.at(self.term_max, term, np.abs(value))
        self.ptr = torch.from_numpy(ptr).to(self.device)
        self.docs = torch.from_numpy(doc[by_term]).to(self.device)
        self.values = torch.from_numpy(value[by_term]).to(self.device)

    def encode(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        """(term ids, counts) of a query's in-vocabulary terms."""
        ids = [self.vocabulary[t] for t in tokenize(text)
               if t in self.vocabulary]
        uniq, counts = np.unique(np.asarray(ids, dtype=np.int64),
                                 return_counts=True)
        return uniq, counts.astype(np.float64)

    def scale(self, text: str) -> float:
        """Sum over the query's terms of count x the term's largest
        |weight|: no document's score, nor any one term's share of it, can
        exceed it."""
        ids, counts = self.encode(text)
        return float((counts * self.term_max[ids]).sum())

    def scores(self, texts: Sequence[str]) -> torch.Tensor:
        """(len(texts), num_docs) float64 scores."""
        out = torch.zeros((len(texts), self.num_docs), dtype=torch.float64,
                          device=self.device)
        for lo in range(0, len(texts), QUERY_CHUNK):
            qi, ti, ci = [], [], []
            for j, text in enumerate(texts[lo:lo + QUERY_CHUNK]):
                ids, counts = self.encode(text)
                qi += [j] * len(ids)
                ti += ids.tolist()
                ci += counts.tolist()
            if not ti:
                continue
            t = torch.tensor(ti, dtype=torch.int64, device=self.device)
            start, stop = self.ptr[t], self.ptr[t + 1]
            lens = stop - start
            entry = (torch.repeat_interleave(start - torch.cumsum(lens, 0)
                                             + lens, lens)
                     + torch.arange(int(lens.sum()), device=self.device))
            row = torch.repeat_interleave(
                torch.tensor(qi, dtype=torch.int64, device=self.device), lens)
            weight = torch.repeat_interleave(
                torch.tensor(ci, dtype=torch.float64, device=self.device),
                lens)
            block = out[lo:lo + QUERY_CHUNK]
            block.view(-1).index_add_(
                0, row * self.num_docs + self.docs[entry],
                weight * self.values[entry])
        return out
