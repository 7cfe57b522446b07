"""The dense cells' inputs, made on the device from the seed: L2-normalised
Gaussian corpus rows, made block by block so that the reference can make
any block again alone, and a pool of queries, each a noisy copy of a
seeded corpus row (so each has a true neighbour), handed over as a host
float32 array as an encoder's output would be."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import seeds


def corpus_block(seed: int, block: int, rows: int, dim: int,
                 device) -> torch.Tensor:
    """Block ``block`` of the corpus: (rows, dim) f32 unit rows."""
    g = torch.Generator(device=device)
    g.manual_seed(seeds.derive(seed, seeds.CORPUS, block))
    x = torch.randn((rows, dim), generator=g, device=device)
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


def block_bounds(num_docs: int, block_rows: int):
    """(block, first row, rows) of each corpus block."""
    for b, lo in enumerate(range(0, num_docs, block_rows)):
        yield b, lo, min(block_rows, num_docs - lo)


def corpus(seed: int, num_docs: int, dim: int, block_rows: int,
           device) -> torch.Tensor:
    """The whole (num_docs, dim) f32 corpus on ``device``."""
    out = torch.empty((num_docs, dim), dtype=torch.float32, device=device)
    for b, lo, n in block_bounds(num_docs, block_rows):
        out[lo:lo + n] = corpus_block(seed, b, n, dim, device)
    return out


def query_pool(seed: int, docs: torch.Tensor, pool: int,
               noise_norm: float) -> np.ndarray:
    """(pool, dim) host f32 unit queries: seeded corpus rows plus Gaussian
    noise of norm about ``noise_norm``, normalised again."""
    g = torch.Generator(device=docs.device)
    g.manual_seed(seeds.derive(seed, seeds.QUERIES))
    src = torch.randint(0, docs.shape[0], (pool,), generator=g,
                        device=docs.device)
    noise = torch.randn((pool, docs.shape[1]), generator=g,
                        device=docs.device)
    q = docs[src] + noise * (noise_norm / docs.shape[1] ** 0.5)
    q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return q.cpu().numpy()
