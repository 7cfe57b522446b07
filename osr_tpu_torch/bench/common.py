"""What the measurement entry points share: ``bench.py``'s workload
(``bench.py:30-50``), the H100's peak rates, the card's name and power
limit, and the head kernels' byte and operation count. ``chip_smoke.py``
takes these from here, so the workload and the bound have one
definition."""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Dict, Tuple

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
