"""Plain BM25 over a text corpus, built in blocks on a device: the
reference of sparse cells whose corpus is too large for the term-by-term
Python build of ``sparse_bm25.py`` (about 800 s at MS MARCO passage's 8.84M
documents on a host like the card's).

The same semantics as :class:`~perfbench.reference.sparse_bm25.
SparseReference`, which it extends (its query scale and scoring are
used as they are): tokens ``\\b\\w+\\b`` on lowercased text, Robertson's
IDF, float32 BM25 weights, terms ranked by descending document frequency
(ties alphabetical), the int8 head, the exact tail, float64 scores.

How it builds: blocks of documents are joined, lowercased and moved to the
device as bytes; a token is a maximal run of ``[0-9a-z_]`` and is held as
its bytes packed big-endian into one int64, zero-padded, so that integer
order is alphabetical order and no two tokens share a key. Only ASCII text
with tokens of at most 8 bytes can be held so; other text is refused. Each
block reduces to its (document, token, count) triples, and the triples of
all blocks to the term-major index of the parent class.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.sparse_bm25 import SparseReference, tokenize

KEY_BYTES = 8
BLOCK_DOCS = 1 << 19


def pack(token: str) -> int:
    """The int64 key of a token (ASCII, at most 8 bytes), else -1."""
    raw = token.encode("ascii", "replace")
    if len(raw) > KEY_BYTES or not token.isascii():
        return -1
    return int.from_bytes(raw.ljust(KEY_BYTES, b"\0"), "big")


def _block_triples(texts: Sequence[str], device):
    """(document in the block, token key, count) of each distinct token of
    each document, and the documents' lengths in tokens."""
    joined = "\n".join(texts)
    if not joined.isascii():
        raise ValueError("the bulk reference reads ASCII text only")
    b = torch.from_numpy(
        np.frombuffer(joined.lower().encode("ascii"), dtype=np.uint8).copy()
    ).to(device)
    word = (((b >= 48) & (b <= 57)) | ((b >= 97) & (b <= 122)) | (b == 95))
    prev = torch.zeros_like(word)
    prev[1:] = word[:-1]
    after = torch.zeros_like(word)
    after[:-1] = word[1:]
    starts = torch.nonzero(word & ~prev).flatten()
    ends = torch.nonzero(word & ~after).flatten() + 1
    del prev, after, word
    size = ends - starts
    if starts.numel() and int(size.max()) > KEY_BYTES:
        raise ValueError(
            f"the bulk reference holds tokens of at most {KEY_BYTES} bytes")
    key = torch.zeros_like(starts)
    for j in range(KEY_BYTES):
        byte = b[(starts + j).clamp_max(b.numel() - 1)].long()
        key = key * 256 + torch.where(j < size, byte, 0)
    first = np.zeros(len(texts), dtype=np.int64)
    np.cumsum([len(t) + 1 for t in texts[:-1]], out=first[1:])
    doc = torch.searchsorted(torch.from_numpy(first).to(device), starts,
                             right=True) - 1
    lengths = torch.bincount(doc, minlength=len(texts))
    local, inv = torch.unique(key, return_inverse=True)
    nk = max(local.numel(), 1)
    pairs, tf = torch.unique(doc * nk + inv, return_counts=True)
    return pairs // nk, local[pairs % nk], tf, lengths


class BulkSparseReference(SparseReference):
    """The reference index of one corpus, built in blocks on ``device``."""

    def __init__(self, texts: Sequence[str], *, k1: float, b: float,
                 head_terms: int, head_dtype: str = "int8", device="cpu",
                 block_docs: int = BLOCK_DOCS):
        if head_dtype != "int8":
            raise ValueError(f"the reference states an int8 head, not "
                             f"{head_dtype}")
        dev = self.device = torch.device(device)
        n = len(texts)
        docs, keys, tfs, lengths = [], [], [], []
        for lo in range(0, n, block_docs):
            d, k, tf, ln = _block_triples(texts[lo:lo + block_docs], dev)
            docs.append(d + lo)
            keys.append(k)
            tfs.append(tf)
            lengths.append(ln)
        doc = torch.cat(docs)
        tf = torch.cat(tfs).double()
        lengths = torch.cat(lengths).cpu().numpy()
        del docs, tfs
        vocab_keys, tid = torch.unique(torch.cat(keys), return_inverse=True)
        del keys
        v = vocab_keys.numel()
        df = torch.bincount(tid, minlength=v).cpu().numpy()
        # Keys ascend alphabetically: a stable sort on -df ranks ties so.
        order = np.argsort(-df, kind="stable")
        rank = np.empty(v, dtype=np.int64)
        rank[order] = np.arange(v)
        self._keys = vocab_keys.cpu().numpy()
        self._rank = rank
        term = torch.from_numpy(rank).to(dev)[tid]
        idf_all = np.log((n - df + 0.5) / (df + 0.5))
        idf = torch.from_numpy(idf_all).to(dev)[tid]
        del tid
        dl = torch.from_numpy(lengths.astype(np.float64)).to(dev)[doc]
        avgdl = float(lengths.mean())
        w = (idf * tf * (k1 + 1.0)
             / (tf + k1 * (1.0 - b + b * dl / avgdl))).float()
        del idf, dl, tf

        n_nonpos = int((idf_all <= 0).sum())
        f = max(min(head_terms, v), n_nonpos)
        self.head_terms = f
        head = term < f
        colmax = torch.zeros(f, dtype=torch.float32, device=dev)
        colmax.scatter_reduce_(0, term[head], w[head].abs(), "amax")
        scale = torch.where(colmax > 0, colmax / torch.tensor(
            127.0, dtype=torch.float32), torch.ones_like(colmax))
        codes = torch.clamp(torch.round(w[head] / scale[term[head]]),
                            -127, 127)
        value = w.double()
        value[head] = scale[term[head]].double() * codes.double()
        del w, codes, head

        by_term = torch.argsort(term * max(n, 1) + doc)
        self.num_docs = n
        self.term_max = torch.zeros(v, dtype=torch.float64, device=dev)
        self.term_max.scatter_reduce_(0, term, value.abs(), "amax")
        self.term_max = self.term_max.cpu().numpy()
        counts = torch.bincount(term, minlength=v)
        self.ptr = torch.zeros(v + 1, dtype=torch.int64, device=dev)
        torch.cumsum(counts, 0, out=self.ptr[1:])
        self.docs = doc[by_term]
        self.values = value[by_term]

    def encode(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        """(term ids, counts) of a query's in-vocabulary terms."""
        keys = np.asarray([pack(t) for t in tokenize(text)], dtype=np.int64)
        keys = keys[keys >= 0]
        pos = np.searchsorted(self._keys, keys)
        pos = np.minimum(pos, len(self._keys) - 1)
        known = self._keys[pos] == keys
        ids = self._rank[pos[known]]
        uniq, counts = np.unique(ids, return_counts=True)
        return uniq, counts.astype(np.float64)
