"""Dense embedding sources (counterpart of ``osr_tpu/index/dense.py``):
seeded synthetic corpora, hash-seeded query embeddings and on-disk
ingestion. All NumPy, so the same seed gives ``osr_tpu``'s arrays bit for
bit; the port's engines take them as host arrays or tensors.
"""

from __future__ import annotations

import zlib
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np


def synthetic_corpus_embeddings(
    num_docs: int,
    dim: int = 768,
    seed: int = 42,
    num_clusters: Optional[int] = None,
    noise: float = 0.1,
) -> np.ndarray:
    """Clustered unit-norm synthetic embeddings: seeded standard-normal
    cluster centers, docs assigned uniformly to clusters, Gaussian noise,
    L2-normalized rows."""
    rng = np.random.RandomState(seed)
    if num_clusters is None:
        num_clusters = max(1, min(50, num_docs // 10))
    centers = rng.randn(num_clusters, dim).astype(np.float32)
    assignments = rng.randint(0, num_clusters, num_docs)
    emb = centers[assignments] + (
        rng.randn(num_docs, dim).astype(np.float32) * noise
    )
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    return (emb / np.maximum(norms, 1e-8)).astype(np.float32)


_FMIX_1 = np.uint32(0x85EBCA6B)
_FMIX_2 = np.uint32(0xC2B2AE35)


def _fmix32(x: np.ndarray) -> np.ndarray:
    """Vectorized murmur3 fmix32 finalizer: uint32 counters -> hashes
    (in place)."""
    x ^= x >> np.uint32(16)
    x *= _FMIX_1
    x ^= x >> np.uint32(13)
    x *= _FMIX_2
    x ^= x >> np.uint32(16)
    return x


def synthetic_query_embeddings(
    texts: Sequence[str], dim: int = 768
) -> np.ndarray:
    """Deterministic hash-seeded unit query embeddings, (B, dim): crc32 of
    each text seeds a counter grid, murmur3 fmix32 hashes each (seed,
    feature) lane into a uniform in [-1, 1), and rows are normalized. The
    same text gives the same vector alone or in a batch."""
    seeds = np.array(
        [zlib.crc32(t.encode("utf-8")) for t in texts], dtype=np.uint32
    )
    # The odd multiplier spreads consecutive crc32 seeds across the 32-bit
    # ring so their per-feature counter ranges never overlap for dim < 2^20.
    base = seeds[:, None] * np.uint32(0x9E3779B1)
    idx = np.arange(dim, dtype=np.uint32)[None, :]
    bits = _fmix32(base + idx)
    # Top 24 bits -> exact float32 uniforms in [0, 1), mapped to [-1, 1).
    v = (bits >> np.uint32(8)).astype(np.float32)
    v = v * np.float32(2.0 / (1 << 24)) - np.float32(1.0)
    norms = np.linalg.norm(v, axis=1, keepdims=True)
    return v / np.maximum(norms, np.float32(1e-8))


def synthetic_query_embedding(query_text: str, dim: int = 768) -> np.ndarray:
    """One text's :func:`synthetic_query_embeddings` row."""
    return synthetic_query_embeddings([query_text], dim)[0]


def load_embeddings(
    path: Union[str, Path],
    num_docs: Optional[int] = None,
    dim: Optional[int] = None,
    mmap: bool = True,
) -> np.ndarray:
    """Load encoder embeddings from .npy/.npz or a raw float32 blob; a raw
    blob's dim is inferred from its size when ``num_docs`` is given."""
    path = Path(path)
    if path.suffix == ".npy":
        return np.load(path, mmap_mode="r" if mmap else None)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return z[z.files[0]]
    size = path.stat().st_size
    if dim is None:
        if not num_docs:
            raise ValueError("Need num_docs or dim to infer raw blob shape")
        dim = size // (num_docs * 4)
    num_docs = num_docs or size // (dim * 4)
    return np.memmap(path, dtype=np.float32, mode="r", shape=(num_docs, dim))
