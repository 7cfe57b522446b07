"""What the measurement entry points share: ``bench.py``'s workload
(``bench.py:30-50``), the H100's peak rates, the card's name and power
limit, the head kernels' byte and operation count, the sparse engines'
exactness rule against the plain head (the merge check), and the roots
of the prose harvest. ``chip_smoke.py`` takes these from here, so the
workload, the bound and the checks have one definition."""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Dict, Tuple

import numpy as np
import torch

BASELINE_QPS = 314.7  # BASELINE.md: the reference's Numba CPU pipeline on FiQA
NUM_DOCS = 57_638
NUM_QUERIES = 6_648
VOCAB = 100_000
TOP_K = 50

# Published peaks of one H100 SXM at its 700 W limit (dense rates).
PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores
PEAK_INT8_OPS = 1979e12  # int8 tensor cores
PEAK_F32_OPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3

NO_CARD = "no CUDA device; no measurement taken"
MERGE_QUERIES = 256  # queries the merge check holds to the plain head
# The int8 head kernels a sparse search takes on the card: K2, or K1 where
# the block-pruned selection does not apply (rows / 128 <= 2 x top_k).
INT8_HEAD_KERNELS = ("head_blockmax_i8", "head_scores_i8")


def batch_for(num_queries: int) -> int:
    """The headline's batch: half the query set, rounded up to 8."""
    return ((num_queries // 2 + 7) // 8) * 8


BATCH = batch_for(NUM_QUERIES)  # 3,328: two batches per pass


def make_corpus(num_docs: int = NUM_DOCS, vocab: int = VOCAB):
    """``bench.py``'s FiQA-scale corpus: Zipf terms, seed 42."""
    from osr_tpu_torch.testing import SyntheticDataGenerator

    return SyntheticDataGenerator(seed=42).zipf_corpus(
        num_docs, vocab, avg_len=130, word_prefix="t", min_len=5
    )


def make_queries(num_queries: int = NUM_QUERIES, vocab: int = VOCAB):
    """``bench.py``'s queries: seed 6."""
    from osr_tpu_torch.testing import SyntheticDataGenerator

    return SyntheticDataGenerator(seed=6).queries(
        num_queries, vocab, avg_terms=11, word_prefix="t", min_terms=2
    )


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_host_runtime():
    """The loaded host runtime; raises unless it is the library built from
    ``csrc/host_runtime.cc`` under ``build/osr_tpu_torch/`` (ImportError
    with the compiler's output when it cannot be built)."""
    from osr_tpu_torch import native
    from osr_tpu_torch.ops import _build

    lib = native.library()
    if lib.path != _build.host_target() or lib.path.parent != _build.BUILD_DIR:
        raise RuntimeError(
            f"the host runtime was loaded from {lib.path}, not from "
            f"{_build.host_target()}"
        )
    return lib


def device_name(dev: torch.device) -> str:
    return card_line() if dev.type == "cuda" else str(dev)


def no_card(metric: str, **keys) -> int:
    """``bench.py``'s answer when there is no device: the JSON line with
    no value and the reason; exit code 1."""
    print(json.dumps({"metric": metric, "value": None, "unit": "queries/s",
                      **keys, "error": NO_CARD}))
    return 1


def head_work(
    b: int, r: int, width: int, head_bytes: int, blockmax: bool = True
) -> Tuple[float, int]:
    """(operations, bytes) of one head kernel launch, K1-K3: a (b, width)
    bf16 query times the (r, width) head, each input read once (head,
    query, row mask), each output written once ((b, r) f32 scores, and
    for K2/K3 the (r/128, b) f32 block maxima)."""
    flops = 2.0 * b * r * width
    nbytes = head_bytes + 2 * b * width + r + 4 * b * r
    if blockmax:
        nbytes += 4 * b * (-(-r // 128))
    return flops, nbytes


def all_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count."""
    from osr_tpu_torch.ops import head, matmul, quantize_kernels

    return {**head.LAUNCHES, **matmul.LAUNCHES, **quantize_kernels.LAUNCHES}


def reset_all_launches() -> None:
    from osr_tpu_torch.ops import head, matmul, quantize_kernels

    for mod in (head, matmul, quantize_kernels):
        mod.reset_launches()


def launched() -> Dict[str, int]:
    """The kernels with a nonzero launch count."""
    return {k: v for k, v in all_launches().items() if v}


def prose_roots() -> Tuple[str, ...]:
    """The running interpreter's own library trees (``sysconfig``'s
    stdlib, purelib and platlib, duplicates removed): where the prose
    harvest of quality-at-scale and fusion-sweep looks for files."""
    import sysconfig

    paths = sysconfig.get_paths()
    return tuple(dict.fromkeys(paths[k] for k in ("stdlib", "purelib",
                                                  "platlib")))


def bench_case(engine, texts, chunk=None):
    """A sparse engine's own head-kernel inputs for one batch of queries:
    (head, scales, scattered query, valid rows) of its head, or of one of
    its row chunks."""
    from osr_tpu_torch.ops.bm25 import scatter_query_head

    d = engine._dev
    head, valid = (d.head, d.valid) if chunk is None else d.chunks[chunk]
    enc = engine.encode_queries(texts)
    ids = torch.from_numpy(enc.head_ids).to(engine.device)
    w = torch.from_numpy(enc.head_weights).to(engine.device)
    qhead = scatter_query_head(
        ids, w, head_terms=engine.index.layout.head_terms
    )
    return head, d.head_scales, qhead, valid


def same_results(got, want, rtol=1e-5) -> bool:
    """Same ids in the same order, except at near-ties (scores within rtol
    of a neighbour), and scores within rtol."""
    for qid, w in want.items():
        g = got[qid]
        if len(g) != len(w):
            return False
        gs, ws = np.array(list(g.values())), np.array(list(w.values()))
        if not np.allclose(gs, ws, rtol=rtol, atol=0):
            return False
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b and i != len(ws) - 1 and not any(
                abs(ws[i] - ws[j]) <= rtol * abs(ws[i])
                for j in (i - 1, i + 1) if 0 <= j < len(ws)
            ):
                return False
    return True


def merge_check(engine, plain_engine, queries) -> int:
    """The sparse engines' exactness rule on the first MERGE_QUERIES
    queries: the kernel engine's results equal the plain engine's
    (``same_results``), and every real candidate's kernel head score lies
    within ``merge_tau_slack`` of the host's candidate head dot (the
    engine's batch must hold MERGE_QUERIES). Returns the candidates
    checked; raises RuntimeError on a violation."""
    from osr_tpu_torch.index import postings as P
    from osr_tpu_torch.ops import head as H

    sub = dict(list(queries.items())[:MERGE_QUERIES])
    got = engine.search(sub, top_k=TOP_K)
    want = plain_engine.search(sub, top_k=TOP_K)
    if not same_results(got, want):
        raise RuntimeError("kernel engine and plain engine disagree")
    layout = engine.index.layout
    head, scales, qhead, valid = bench_case(engine, list(sub.values()))
    enc = engine.encode_queries(list(sub.values()))
    hs, _ = H.masked_head_scores_blockmax(head, scales, qhead, valid)
    cand = P.tail_candidates_flat(
        layout.post_ptr, layout.post_rows, layout.post_weights,
        enc.tail_ids, enc.tail_counts, enc.tail_ptr,
        enc.head_ids.shape[0], num_rows=head.shape[0],
    )
    host_head, host_dtype, head_t, slack_per_term = P.prepare_host_merge(
        layout
    )
    host = P.cand_head_scores_host(
        host_head, host_dtype, layout.head_scales, cand,
        enc.head_flat_ids, enc.head_flat_counts, enc.head_ptr, head_t=head_t,
    )
    slack = P.merge_tau_slack(
        slack_per_term, enc.head_flat_ids, enc.head_flat_counts, enc.head_ptr
    )
    n = cand.total
    rows = torch.from_numpy(cand.rows[:n].astype(np.int64)).to(hs.device)
    cols = torch.from_numpy(cand.cols[:n].astype(np.int64)).to(hs.device)
    dev = hs[cols, rows].cpu().numpy()
    gap = np.abs(dev.astype(np.float64) - host) - slack[cand.cols[:n]]
    if n == 0 or not np.all(gap <= 0):
        raise RuntimeError(
            f"merge slack violated ({n} candidates, worst {gap.max()})"
        )
    return n
