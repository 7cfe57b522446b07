#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for the numbers
recorded in PERF.md).

Phases, each of which fails the run (non-zero exit) on any error:

1. build the hand-written kernels (osr_tpu_torch/csrc) with nvcc;
2. hold K1, K2 and K3 against their plain PyTorch versions on the card, at
   a ragged small shape and at the FiQA bench shape (the main path's own
   inputs), with the tolerance of tests/test_torch_head.py; time each
   kernel, its plain version and a one-call PyTorch yardstick;
3. drive the main path: the bench.py FiQA-scale corpus (57,638 docs,
   100k-term vocabulary) and its 6,648 queries through
   SparseSearchEngine(device="cuda", batch_sizes=(3328,)) at top_k=50 (K2),
   the same index at top_k=1000 (K1), and an int4 build (K3), counting
   each kernel's launches in each run;
4. the merge check on 256 queries: the kernel engine's results match an
   engine whose head step is the plain version, and every real candidate's
   kernel head score is within merge_tau_slack of cand_head_scores_host;
5. the device step per batch (CUDA events), main-path QPS (median of 5
   passes), one batch timed stage by stage, and p50 single-query latency.

Prints the card's name and power limit, a JSON line of per-kernel numbers,
and last a JSON line {"ok": true, "device": {...}}. Exits non-zero without
a result when no CUDA device is available. Run: python3 chip_smoke.py
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

NUM_DOCS = 57_638
NUM_QUERIES = 6_648
VOCAB = 100_000
TOP_K = 50
DEEP_K = 1_000  # the depth BEIR evaluation retrieves
BATCH = ((NUM_QUERIES // 2 + 7) // 8) * 8  # 3,328: two batches per pass
MERGE_QUERIES = 256
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
KERNELS = {
    # launch-counter name: the Pallas kernel it replaces
    "head_scores_i8": "osr_tpu/ops/pallas/head.py:42",
    "head_blockmax_i8": "osr_tpu/ops/pallas/head.py:208",
    "head_blockmax_i4": "osr_tpu/ops/pallas/head.py:225",
}
SOURCE = "osr_tpu_torch/csrc/head.cu"


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_registers():
    """Registers per thread of each kernel as ptxas reports them
    (``nvcc --resource-usage``); the count sets blocks per SM."""
    from osr_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = _build.BUILD_DIR / "resource_usage.o"
    out = subprocess.run(
        [_build._nvcc(), *flags, "--resource-usage", "-c", "-o", str(obj),
         str(_build.CSRC / "head.cu")],
        capture_output=True, text=True, timeout=600, check=True,
    )
    obj.unlink(missing_ok=True)
    # head_scores_kernel<kInt4, kBlockMax> mangles as ILb<int4>ELb<bmax>E.
    names = {"ILb0ELb0E": "head_scores_i8", "ILb0ELb1E": "head_blockmax_i8",
             "ILb1ELb1E": "head_blockmax_i4"}
    regs, current = {}, None
    for line in (out.stdout + out.stderr).splitlines():
        current = next((n for m, n in names.items() if m in line), current)
        if "registers" in line and current is not None:
            regs[current] = int(line.split("Used ")[1].split()[0])
    if set(regs) != set(KERNELS):
        fail(f"ptxas reported registers for {sorted(regs)} only")
    return regs


def median_ms(fn, reps, warmup=2):
    """Median over ``reps`` single calls, each timed with CUDA events."""
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


# ----------------------------------------------------------------------
# Kernel checks
# ----------------------------------------------------------------------


def kernel_call(name, head, scales, qhead, valid, plain=False):
    from osr_tpu_torch.ops import head as H

    if name == "head_scores_i8":
        fn = H.masked_head_scores_plain if plain else H.masked_head_scores
        return fn(head, scales, qhead, valid), None
    fn = (
        H.masked_head_scores_blockmax_plain
        if plain
        else H.masked_head_scores_blockmax
    )
    return fn(head, scales, qhead, valid)


def check_kernel(name, head, scales, qhead, valid):
    """Kernel vs plain on the same card inputs. Per entry, |kernel - plain|
    <= 4 F 2^-24 sum_j |q_j w_ij| (f32 summation order; the products are
    exact on both sides); masked entries exactly -inf; block maxima equal
    the maxima of the kernel's own scores. Returns max |kernel - plain|."""
    from osr_tpu_torch.ops import head as H

    got, gmax = kernel_call(name, head, scales, qhead, valid)
    want, _ = kernel_call(name, head, scales, qhead, valid, plain=True)
    torch.cuda.synchronize()
    q = H.scaled_query(qhead, scales, H.logical_width(head)).float()
    with H.f32_matmul():
        mag = q.abs() @ H.decode_head(head).abs().T
    bound = 4 * q.shape[1] * 2.0**-24 * mag
    ok = valid[None, :].expand_as(got)
    if not torch.all(got[~ok] == float("-inf")):
        fail(f"{name}: masked entries are not -inf")
    if not torch.all(want[~ok] == float("-inf")):
        fail(f"{name}: plain masked entries are not -inf")
    err = (got - want).abs()[ok]
    excess = (err - bound[ok]).max().item() if err.numel() else 0.0
    if not (excess <= 0.0):
        fail(f"{name}: kernel exceeds the tolerance by {excess}")
    if gmax is not None and not torch.equal(gmax, H.block_max(got)):
        fail(f"{name}: block maxima differ from the tile maxima")
    return float(err.max().item()) if err.numel() else 0.0


def kernel_numbers(name, head, scales, qhead, valid):
    """Error, times and bound of one kernel at the main path's shape."""
    from osr_tpu_torch.ops import head as H

    err = check_kernel(name, head, scales, qhead, valid)
    ms = median_ms(
        lambda: kernel_call(name, head, scales, qhead, valid), reps=20
    )
    plain_ms = median_ms(
        lambda: kernel_call(name, head, scales, qhead, valid, plain=True),
        reps=5, warmup=1,
    )
    # Yardstick only (the port never calls it): one cuBLAS bf16 product of
    # the upcast head at the same shape, plus the mask.
    hb = H.decode_head(head).to(torch.bfloat16)
    q = H.scaled_query(qhead, scales, hb.shape[1])
    not_valid = ~valid
    library_ms = median_ms(
        lambda: torch.matmul(q, hb.T).masked_fill_(not_valid, float("-inf")),
        reps=10,
    )
    del hb
    b, r, width = q.shape[0], head.shape[0], q.shape[1]
    flops = 2.0 * b * r * width
    nbytes = (
        head.numel() * head.element_size() + q.numel() * 2 + r + 4 * b * r
    )
    if name != "head_scores_i8":
        nbytes += 4 * b * (-(-r // 128))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    log(
        f"kernel {name}: B={b} R={r} F={width} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={max(t_ops, t_bytes):.4f} max_abs_err={err:.3e} "
        f"TFLOP/s={flops / ms / 1e9:.1f}"
    )
    return {
        "name": name,
        "route": "cuda",
        "source": SOURCE,
        "replaces": KERNELS[name],
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def small_case(name, dev):
    """Ragged small inputs: B and R off the 128 tiles, invalid rows."""
    rng = np.random.RandomState(5)
    b, r = 130, 300
    if name.endswith("i4"):
        fp, f = 80, 150
        codes = rng.randint(0, 16, (r, 2 * fp)).astype(np.uint8)
        codes[:, f:] = 0
        head = codes[:, :fp] | (codes[:, fp:] << 4)
        scales = ((rng.rand(f) - 0.3) / 15.0).astype(np.float32)
    else:
        f = 160
        head = rng.randint(-127, 128, (r, f)).astype(np.int8)
        scales = ((rng.rand(f) + 0.1) / 127.0).astype(np.float32)
    qhead = rng.randint(0, 4, (b, f)).astype(np.float32)
    valid = rng.rand(r) > 0.1
    return [
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (head, scales, qhead, valid)
    ]


def bench_case(engine, texts):
    """The main path's own kernel inputs for one batch of queries."""
    from osr_tpu_torch.ops.bm25 import scatter_query_head

    d = engine._dev
    enc = engine.encode_queries(texts)
    ids = torch.from_numpy(enc.head_ids).to(engine.device)
    w = torch.from_numpy(enc.head_weights).to(engine.device)
    qhead = scatter_query_head(
        ids, w, head_terms=engine.index.layout.head_terms
    )
    return d.head, d.head_scales, qhead, d.valid


# ----------------------------------------------------------------------
# Main path
# ----------------------------------------------------------------------


def counted_search(engine, queries, top_k):
    """One pass with every launch count set to 0 just before it; returns
    (results, launch counts of this pass)."""
    from osr_tpu_torch.ops import head as H

    H.reset_launches()
    results = engine.search(queries, top_k=top_k)
    torch.cuda.synchronize()
    return results, dict(H.LAUNCHES)


def check_results(results, queries, top_k):
    if set(results) != set(queries):
        fail("results do not cover every query")
    nonempty = 0
    for r in results.values():
        s = np.fromiter(r.values(), np.float64, len(r))
        if len(r) > top_k or not np.all(np.isfinite(s)) or np.any(s <= 0):
            fail("a result has too many, non-finite or non-positive scores")
        if np.any(np.diff(s) > 0):
            fail("a result is not sorted by descending score")
        nonempty += bool(r)
    if nonempty < 0.9 * len(queries):
        fail(f"only {nonempty}/{len(queries)} queries returned documents")
    return nonempty


def same_results(got, want, rtol=1e-5):
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


def merge_check(engine, plain_engine, queries):
    """Kernel engine == plain engine on MERGE_QUERIES queries, and the
    kernel's candidate head scores are within the merge slack of the host's
    candidate head dots."""
    from osr_tpu_torch.index import postings as P
    from osr_tpu_torch.ops import head as H

    sub = dict(list(queries.items())[:MERGE_QUERIES])
    got = engine.search(sub, top_k=TOP_K)
    want = plain_engine.search(sub, top_k=TOP_K)
    if not same_results(got, want):
        fail("kernel engine and plain engine disagree")
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
        fail(f"merge slack violated ({n} candidates, worst {gap.max()})")
    return n


def batch_stages(engine, texts, top_k):
    """Wall time (ms) of each stage of one batch, run one after another
    (inside search() the candidate head dots overlap the device step)."""
    from osr_tpu_torch.index import postings as P
    from osr_tpu_torch.ops.bm25 import fused_search

    d = engine._dev
    ms = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        ms[name] = (now - t) * 1e3
        t = now

    enc = engine.encode_queries(texts)
    lap("encode")
    cand = engine._tail_candidates(enc, enc.head_ids.shape[0])
    lap("tail_walk")
    top, rows, _ = fused_search(
        engine._upload(enc.head_ids), engine._upload(enc.head_weights),
        d.empty_i32, d.empty_i32, d.head, d.head_scales, d.valid,
        head_terms=engine.index.layout.head_terms, k=top_k,
        head_backend=engine.head_backend,
    )
    top, rows = top.cpu().numpy(), rows.cpu().numpy()
    lap("device_step_and_copy")
    cand_head = engine._cand_head_host(cand, enc)
    lap("cand_head_dots")
    slack = P.merge_tau_slack(
        engine._slack_per_term, enc.head_flat_ids, enc.head_flat_counts,
        enc.head_ptr,
    )
    scores, ids = P.merge_host(
        top, rows, cand, cand_head, d.num_rows, top_k, tau_slack=slack
    )
    lap("merge")
    engine._result_dicts(scores, ids)
    lap("result_dicts")
    return ms


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from osr_tpu_torch import native
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.ops import _build
    from osr_tpu_torch.ops.bm25 import fused_search
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine
    from osr_tpu_torch.testing import SyntheticDataGenerator

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    log(f"registers per thread (ptxas): {kernel_registers()}")
    log(f"host runtime: native={native.available()}")

    for name in KERNELS:
        err = check_kernel(name, *small_case(name, dev))
        log(f"small ragged check {name}: max_abs_err={err:.3e}")

    t0 = time.perf_counter()
    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(
        NUM_DOCS, VOCAB, avg_len=130, word_prefix="t", min_len=5
    )
    queries = SyntheticDataGenerator(seed=6).queries(
        NUM_QUERIES, VOCAB, avg_terms=11, word_prefix="t", min_terms=2
    )
    index8 = SparseIndexBuilder(head_dtype="int8").build(corpus)
    index4 = SparseIndexBuilder(head_dtype="int4").build(corpus)
    del corpus
    log(
        f"indexes built in {time.perf_counter() - t0:.1f} s: "
        f"{index8.stats()['num_rows']} rows, F={index8.layout.head_terms}, "
        f"int8 head {index8.layout.head.nbytes / 2**20:.1f} MiB, "
        f"int4 head {index4.layout.head.nbytes / 2**20:.1f} MiB"
    )

    eng8 = SparseSearchEngine(
        index8, device="cuda", batch_sizes=(BATCH,), cache_queries=False
    )
    eng4 = SparseSearchEngine(
        index4, device="cuda", batch_sizes=(BATCH,), cache_queries=False
    )
    if eng8.head_backend != "cuda" or eng4.head_backend != "cuda":
        fail("the engines do not take the CUDA kernels")
    texts = list(queries.values())[:BATCH]

    # Kernels at the main path's shapes, on the main path's inputs.
    rows = []
    for name, eng in (
        ("head_scores_i8", eng8),
        ("head_blockmax_i8", eng8),
        ("head_blockmax_i4", eng4),
    ):
        rows.append(kernel_numbers(name, *bench_case(eng, texts)))
        torch.cuda.empty_cache()
    by_name = {r["name"]: r for r in rows}

    # The main path, and the two paths that reach K1 and K3.
    for label, eng, k, kernel in (
        ("main path int8 top_k=50", eng8, TOP_K, "head_blockmax_i8"),
        ("int8 top_k=1000", eng8, DEEP_K, "head_scores_i8"),
        ("int4 top_k=50", eng4, TOP_K, "head_blockmax_i4"),
    ):
        t0 = time.perf_counter()
        results, counts = counted_search(eng, queries, k)
        secs = time.perf_counter() - t0
        nonempty = check_results(results, queries, k)
        log(
            f"{label}: {len(results)} queries in {secs:.2f} s, "
            f"{nonempty} non-empty, launches {counts}"
        )
        if counts[kernel] == 0:
            fail(f"{label} launched no {kernel}")
        by_name[kernel]["launches"] = counts[kernel]

    plain8 = SparseSearchEngine(
        index8, device="cuda", batch_sizes=(BATCH,), cache_queries=False,
        head_backend="torch",
    )
    n = merge_check(eng8, plain8, queries)
    log(f"merge check int8: results match the plain engine; {n} candidates "
        "within merge_tau_slack")
    plain4 = SparseSearchEngine(
        index4, device="cuda", batch_sizes=(BATCH,), cache_queries=False,
        head_backend="torch",
    )
    n = merge_check(eng4, plain4, queries)
    log(f"merge check int4: results match the plain engine; {n} candidates "
        "within merge_tau_slack")
    del plain8, plain4

    # The device step alone (scatter, head kernel, selection), per batch.
    enc = eng8.encode_queries(texts)
    ids = torch.from_numpy(enc.head_ids).to(dev)
    w = torch.from_numpy(enc.head_weights).to(dev)
    d = eng8._dev
    step_ms = {}
    for k in (TOP_K, DEEP_K):
        step_ms[k] = median_ms(
            lambda: fused_search(
                ids, w, d.empty_i32, d.empty_i32, d.head, d.head_scales,
                d.valid, head_terms=index8.layout.head_terms, k=k,
                head_backend="cuda",
            ),
            reps=10,
        )
        log(f"device step int8 top_k={k}, B={BATCH}: {step_ms[k]:.4f} ms")

    passes = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng8.search(queries, top_k=TOP_K)
        passes.append(NUM_QUERIES / (time.perf_counter() - t0))
    qps = float(np.median(passes))
    busy = 2 * step_ms[TOP_K] / (NUM_QUERIES / qps * 1e3)
    log(
        f"main path QPS (int8, top_k=50, B={BATCH}, median of 5): "
        f"{qps:.1f}; passes {[round(p, 1) for p in passes]}; device step "
        f"share of a pass {busy:.3f}"
    )
    runs = [batch_stages(eng8, texts, TOP_K) for _ in range(3)]
    stages = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    log(
        "one batch stage by stage (int8, top_k=50, B=3328, ms, median of "
        f"3): {json.dumps({k: round(v, 3) for k, v in stages.items()})}; "
        f"sum {sum(stages.values()):.3f}"
    )
    lat_engine = SparseSearchEngine(
        index8, device="cuda", batch_sizes=(1,), cache_queries=False
    )
    items = list(queries.items())
    lat_engine.search(dict(items[:1]), top_k=TOP_K)
    lats = []
    for i in range(40):
        t0 = time.perf_counter()
        lat_engine.search(dict(items[i : i + 1]), top_k=TOP_K)
        lats.append((time.perf_counter() - t0) * 1e3)
    log(
        f"B=1 latency (int8, top_k=50): p50 {np.percentile(lats, 50):.3f} ms, "
        f"p95 {np.percentile(lats, 95):.3f} ms"
    )
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
