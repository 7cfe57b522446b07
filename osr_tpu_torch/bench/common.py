"""What the measurement entry points share: ``bench.py``'s workload
(``bench.py:30-50``) and the tools' seed-42 one, the H100's peak rates,
the card's name and power limit, the head kernels' byte and operation
count, the sparse engines' exactness rules (the merge check against the
plain head, the sharded scripts' mismatch rule), a batch's stages read
from the engine's own spans, CUDA-event timing and the device-stage
scripts' enqueued timing, pinned fetches, a top-k comparison up to tied
scores, the index state handed to spawned ranks, and the roots of the
prose harvest. ``chip_smoke.py`` takes these from here, so the workload,
the bound, the checks and the stages have one definition."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

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


def workload(docs: int = NUM_DOCS, vocab: int = VOCAB,
             num_queries: int = NUM_QUERIES):
    """The tools' corpus and queries (``tools/bench_batch_curve.py``, the
    sharded pair, ``profile_trace.py``, ``profile_latency.py``): one
    seed-42 generator, corpus first; the queries are not ``bench.py``'s
    seed-6 set."""
    from osr_tpu_torch.testing import SyntheticDataGenerator

    gen = SyntheticDataGenerator(seed=42)
    corpus = gen.zipf_corpus(
        docs, vocab, avg_len=130, word_prefix="t", min_len=5
    )
    queries = gen.queries(
        num_queries, vocab, avg_terms=11, word_prefix="t", min_terms=2
    )
    return corpus, queries


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
    from osr_tpu_torch.ops import head, matmul, quantize_kernels, topk

    return {**head.LAUNCHES, **matmul.LAUNCHES, **quantize_kernels.LAUNCHES,
            **topk.LAUNCHES}


def reset_all_launches() -> None:
    from osr_tpu_torch.ops import head, matmul, quantize_kernels, topk

    for mod in (head, matmul, quantize_kernels, topk):
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


def substantive_mismatches(
    a: Mapping[str, Mapping[str, float]],
    b: Mapping[str, Mapping[str, float]],
    tol: float = 1e-4,
) -> int:
    """The queries of ``b`` whose results in ``a`` differ substantively
    (``tools/bench_sharded_cpu.py:128-143``, ``bench_sharded_tpu.py:
    122-139``): a document unique to one side outscores the other side's
    k-th kept score by more than ``tol`` (relative, at least absolute), or
    a shared document's scores differ by more than it. An equal-score tie
    swap at the k-th place does not count."""
    mismatches = 0
    for qid in b:
        x, y = a[qid], b[qid]
        xmin = min(x.values(), default=0.0)
        ymin = min(y.values(), default=0.0)
        bad = any(
            x[d] > ymin + tol * max(1.0, abs(ymin)) for d in set(x) - set(y)
        ) or any(
            y[d] > xmin + tol * max(1.0, abs(xmin)) for d in set(y) - set(x)
        ) or any(
            abs(x[d] - y[d]) > tol * max(1.0, abs(y[d]))
            for d in set(x) & set(y)
        )
        mismatches += bool(bad)
    return mismatches


def differing_dicts(a, b) -> int:
    """The queries of ``b`` whose result dicts in ``a`` differ at all (ids,
    order aside, or scores)."""
    if set(a) != set(b):
        raise RuntimeError("the two results cover different queries")
    return sum(a[q] != b[q] for q in b)


def span_self_ms(events, prefix: str = "osr.") -> Dict[str, float]:
    """Self milliseconds of the spans whose names start with ``prefix``,
    summed by name, in the order the names first start. ``events`` are
    (name, thread, start ns, end ns); a span's self time is its own less
    that of the spans of ``prefix`` nested directly in it on its thread."""
    spans = sorted(
        (e for e in events if e[0].startswith(prefix)),
        key=lambda e: (e[1], e[2], -e[3]),
    )
    first = {}
    self_ns: Dict[str, int] = {}
    open_spans = []  # (thread, end ns, name) of the spans enclosing this one
    for name, thread, start, end in spans:
        while open_spans and (
            open_spans[-1][0] != thread or open_spans[-1][1] <= start
        ):
            open_spans.pop()
        if open_spans:
            parent = open_spans[-1][2]
            self_ns[parent] -= end - start
        self_ns[name] = self_ns.get(name, 0) + end - start
        first.setdefault(name, start)
        open_spans.append((thread, end, name))
    return {n: self_ns[n] / 1e6 for n in sorted(first, key=first.get)}


def batch_stages(engine, texts, top_k) -> Dict[str, float]:
    """Self time (ms) of each ``osr.sparse.*`` span of one
    ``engine.search`` over ``texts`` (one batch where they fit the
    engine's largest batch size) under a CPU-only ``torch.profiler``: the
    served path, where the candidates' head dots overlap the device step
    (or wait for it where the candidate filter applies). The query cache
    is emptied first, so every query runs. The values sum to the call's
    time (``osr.sparse.search`` keeps what no stage span covers)."""
    from torch.profiler import ProfilerActivity, profile

    engine.clear_cache()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.search({f"q{i}": t for i, t in enumerate(texts)}, top_k)
    return span_self_ms(
        (e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
        for e in prof.profiler.kineto_results.events()
    )


def median_stages(engine, texts, top_k, runs=3) -> Dict[str, float]:
    """:func:`batch_stages`, each stage's median over ``runs`` calls (a
    stage missing from a call, such as a re-dispatch, counts 0 there)."""
    out = [batch_stages(engine, texts, top_k) for _ in range(runs)]
    names = list(dict.fromkeys(k for r in out for k in r))
    return {k: float(np.median([r.get(k, 0.0) for r in out])) for k in names}


def median_ms(fn: Callable[[], object], reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` single calls of ``fn`` on the current CUDA
    stream, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def sync(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def enqueued_ms(fn: Callable[[], object], dev: torch.device,
                reps: int = 4) -> float:
    """The device-stage scripts' fetch-forced timing: ``fn`` once to warm,
    then ``reps`` calls enqueued back to back and one synchronize after
    the last; milliseconds a call on the host clock. On the CPU each call
    runs as it is made."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def fetch(tensors) -> list:
    """Device tensors copied into pinned host buffers, after a
    synchronize, as NumPy arrays (the CPU's tensors as they are)."""
    out = []
    for t in tensors:
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            t = host
        out.append(t.numpy())
    return out


def rounded(x: Optional[float], digits: int = 4) -> Optional[float]:
    return None if x is None else round(float(x), digits)


def equal_up_to_ties(s_a: np.ndarray, r_a: np.ndarray, s_b: np.ndarray,
                     r_b: np.ndarray) -> bool:
    """Two exact top-k lists, (B, k) scores and rows, hold the same scores
    in the same places and the same rows but where a score is tied: rows
    among equal scores may come in another order, and at a tie on the
    k-th score another of the tied rows may be kept."""
    if not np.array_equal(s_a, s_b):
        return False
    for q in np.flatnonzero((r_a != r_b).any(axis=1)):
        kth = s_a[q, -1]
        for v in np.unique(s_a[q]):
            at = s_a[q] == v
            if v != kth and set(r_a[q, at]) != set(r_b[q, at]):
                return False
    return True


FOREIGN_MODULES = ("jax", "jaxlib", "osr_tpu", "transformers", "yaml")


def foreign_modules() -> Tuple[str, ...]:
    """The modules of this process that the port must not load: JAX,
    ``osr_tpu``, ``transformers`` and PyYAML (the spawned ranks report
    it)."""
    return tuple(sorted(
        m for m in sys.modules if m.split(".")[0] in FOREIGN_MODULES
    ))


def index_state(index) -> Dict[str, object]:
    """The keyword arguments of ``convert.index_from_arrays`` for ``index``:
    how a parent hands its host index to spawned ranks."""
    lay = index.layout
    return dict(
        head=lay.head, head_scales=lay.head_scales, post_ptr=lay.post_ptr,
        post_rows=lay.post_rows, post_weights=lay.post_weights,
        valid=lay.valid, num_docs=lay.num_docs, vocab_size=lay.vocab_size,
        head_terms=lay.head_terms, head_dtype=lay.head_dtype,
        vocabulary=dict(index.vocabulary), doc_ids=list(index.doc_ids),
        method=index.method, idf=index.idf, doc_lengths=index.doc_lengths,
        avgdl=index.avgdl, k1=index.k1, b=index.b,
    )
