#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for the numbers
recorded in PERF.md).

Phases, each of which fails the run (non-zero exit) on any error:

1. build the hand-written kernels (osr_tpu_torch/csrc: head_wgmma.cu,
   similarity_wgmma.cu, quantize.cu, topk_select.cu) with nvcc and the
   host runtime (csrc/host_runtime.cc) with g++, one process per source,
   all at once;
   fail unless the runtime loads from build/osr_tpu_torch/ (no engine on
   the card runs without it); walk the tail postings of a 67,108,864-row
   index (rows past 2^24, 1,024 queries) through tail_candidates_flat,
   which must take the runtime and equal the NumPy body bit for bit, and
   print both times; print each kernel's registers and shared memory (ptxas,
   plus the dynamic shared memory of the TMA kernels), failing if ptxas
   serialized a wgmma pipeline; check that the SASS of head_wgmma.cu's
   five kernels (K1, K2, K4-i8, K3, K4-i4) holds HGMMA and UTMALDG (wgmma
   and TMA loads) and that of similarity_wgmma.cu's K5 and K6 IGMMA
   (integer wgmma), UTMALDG and UTMASTG (TMA stores);
2. hold the exact top-k select kernel (topk_select.cu) against the stable
   sort's first k, values and int32 indices bit for bit, at every
   selection shape of the benchmark's five cells (SELECT_SHAPES, scores
   with head scores' ties) and on K1's own scores at the FiQA bench shape,
   and time it beside the sort, torch.topk (a yardstick the port never
   calls) and its bound (the scores read once); hold K1, K2 and K3
   against their plain PyTorch versions on the card, at a ragged small
   shape and at the FiQA bench shape (the main path's own
   inputs), with the tolerance of tests/test_torch_head.py, K1's scores
   equal to K2's bit for bit there, and K1, K2/K4-i8 and K3/K4-i4 at the
   edges of their TMA rings (int8 widths 16 to 2,048 bytes, int4 packed
   widths 16 to 1,024, B and R off the 128 tiles, invalid rows in the last
   block); time each
   kernel, its plain version and a one-call PyTorch yardstick; hold K4
   (the per-block top-m extraction, int8 and int4, m in 1, 4, 8, 16)
   against its plain twin at R=700, F=160, B=9: bit-equal on exact-sum inputs,
   within the K1-K3 bound on random ones; hold K4 against the stable
   per-block top-8 of K2's (K3's) own scores at the path shapes, bit for
   bit; hold K5, K6, K7 (both roundings) and K8 against theirs at a
   ragged shape (B=37, N=1,000, D=776), where the error must be 0, and K5
   and K6 at the edges of their stages and tiles (widths off 16 bytes,
   which their wrappers pad, N off 4, several tiles per persistent block);
3. drive the sparse main path: the bench.py FiQA-scale corpus (57,638
   docs, 100k-term vocabulary) and its 6,648 queries through
   SparseSearchEngine(device="cuda", batch_sizes=(3328,)) at top_k=50 (K2),
   the same index at top_k=1000 (K1), and an int4 build (K3), counting
   each kernel's launches in each run (each must launch the select kernel
   and send no selection to the stable sort); then, on each index, the
   extraction plan (narrow_m=8, narrow_backend='extract': K4), the
   narrowed plan (narrow_m=8) and topk_mode='approx' (both run the
   standard block-pruned selection, K2 / K3), whose results must each
   equal the standard engine's dict for dict;
4. the merge check on 256 queries: the kernel engine's results match an
   engine whose head step is the plain version, and every real candidate's
   kernel head score is within merge_tau_slack of cand_head_scores_host;
5. the device step per batch (CUDA events; standard at top_k 50 and 1000,
   and extraction), main-path QPS (median of 5 passes), one batch timed stage
   by stage, and p50 single-query latency;
6. the retrieval surface on the same corpus and queries, through
   RetrieverRegistry.create with osr_tpu/configs/prose_87k.yaml's two
   retriever blocks on cuda: the bm25 retriever at top_k=100 (K2) must
   equal SparseSearchEngine(device="cuda") dict for dict; the hybrid
   (hashing_idf encoder with its native backend, dim 768, RRF 1.0/1.0,
   fusion depth 100) over every query must launch K2, K7 and K5, its array
   path must equal the dict oracle (_search_dicts) on 256 queries, its
   dense leg the backend='torch' engine bit for bit, and after
   set_fusion(weighted, 0.3/0.7) the oracle again; the splade route over
   seeded learned vectors (K2) must match a head_backend='torch' engine
   under the merge check; RetrievalService over the 57,638 stored docs must
   give the bm25 retriever's results and each hit's stored text. Prints the
   encoder's fit + encode time, QPS (median of 3) of the hybrid, the bm25
   retriever and the hybrid's dense leg alone, one hybrid batch stage by
   stage, and the device step share of a hybrid pass;
7. the experiment pipeline on the same corpus: the port's build_dataset
   (noisy regime, 2,048 queries with graded qrels) written as BEIR files
   and read back by the loaders (ids, texts, one grade-2 document a
   query); HFEncoder at Contriever's published width (BERT-base: 12
   layers, hidden 768, 12 heads, vocabulary 30,522, seeded weights, a
   WordPiece vocabulary of the corpus's most frequent terms) in f32 on
   the card against f32 on the CPU over 64 docs (max abs 1e-5, TF32
   off) and in bf16 against f32 (1e-2), its bf16 docs/s and tokens/s;
   then run_all_experiments on a config dict with the contriever
   experiment over the bf16 HFEncoder (K7 + K5) on cuda (prose_87k.yaml's
   bm25 and hybrid blocks run through it in phase 13's pipeline-87k):
   every query processed, its kernels launched, its preds equal to a
   direct retriever.search of the same block (over the experiment's
   corpus and query embeddings) and its quality equal to
   evaluate_retrieval over that search; prints build, warmup and
   retrieve seconds, retrieval and pipeline QPS, nDCG@10 and the stage
   split;
8. the benchmark suites on the same scratch data: (a) run_from_config on
   osr_tpu/configs/benchmarks.yaml with device="cuda" (the bm25, topk,
   quantization and storage suites) must pass every row, launch K1, K5,
   K7 and K8, and hold a passing head_kernel_parity row (K1 == K2 bit for
   bit, K1 within the kernels' tolerance of the plain scores); K7, K8 and
   K5 then equal their plain versions bit for bit on the quantization
   suite's own inputs and shapes (2,000 x 256, 32 queries); (b)
   run_quality_benchmark over phase 7's dataset, bm25 and tfidf at
   top_k=100 on cuda, must launch K2 and give IR metrics equal to the same
   run on the plain head; (c) BEIRCompatibleSearch(device="cuda") over that
   corpus and 256 of its queries must launch K2, equal
   SparseSearchEngine(device="cuda") on the same title + text dict for
   dict, and give back each hit's stored text; prints each suite's speed
   rows, build seconds and warm QPS;
9. the 1M path: tools/bench_scaling.py's recipe, 1,000,000 docs over a
   400,000-term vocabulary, int8 head F=2,048, 2,048 queries at top_k=50,
   B=2,048: first the batch's tail walk six times (the first call and
   the median of the later ones), then through three engines: (x)
   extraction in 2 row chunks of
   500,096 (K4), (s) the standard chunked program (K2), (f) one unchunked
   sweep (K2). (x) must equal (s) dict for dict, (f) must match (s), and a
   plain chunked engine must match (f) on 256 queries with the merge
   slack check; QPS (median of 3), device step per batch, the stage split,
   and K4 at one chunk against its bound, plain twin and a cuBLAS +
   torch.topk yardstick;
10. drive the dense path at 1,000,000 x 768, for symmetric (K7 + K5) and
   int4 (K7 + K6): DenseSearchEngine(device="cuda") built from f32
   embeddings drawn on the card, 4,096 queries (corpus rows) in batches of
   1,024 at top_k=50, launches counted (the select kernel among them, and
   no selection sent to the stable sort); the corpus codes equal the plain
   quantizer's; K5's and K6's wrappers made no operand copy; 256 queries
   give the backend='torch' engine's ids and bit-equal scores; the
   self-hit rate; each kernel against its plain version at the path's
   shapes (error 0) with its times; the dense device
   step per batch, QPS (median of 5 passes) and p50/p95 B=1 latency;
11. drive the quantization round trip (quantize, dequantize; deterministic
   and stochastic, as benchmarks/suites.py's quantization suite does) on
   the 1M corpus, counting K7 and K8, and time K7 and K8 there; then dense
   QPS at bench.py's own dense shape (the bench corpus size x 768,
   B=4,096), for reference;
12. the sharded engines (osr_tpu_torch/parallel/) at the same widths:
   (a) the script's own world of one rank under NCCL (a file:// store in
   its scratch directory, destroyed at the end of the part), mesh (1, 1):
   ShardedSparseSearchEngine over the FiQA-scale indexes at int8 top_k=50
   (K2), top_k=1000 (K1), int4 (K3) and the extraction plan (narrow_m=8,
   K4-i8 and K4-i4) over the 6,648 queries, each equal dict for dict to
   the flat engine whose merge reads the same candidate scores (the
   device merge; the host merge for extraction);
   ShardedDenseSearchEngine over bench.py's dense shape (57,638 x 768,
   4,096 query rows, top_k=50), symmetric (K7 + K5) and int4 (K7 + K6),
   ids and scores equal to the flat engine bit for bit; and
   ShardedHybridEngine (RRF, depth 100) equal to the flat HybridRetriever
   over the same two legs; prints the sharded device step against the
   flat one (CUDA events) and both engines' QPS (median of 3). (b) two
   spawned ranks, both on cuda:0, under gloo (NCCL refuses two ranks on
   one card), mesh (1, 2): the int8 head in 2 shards of 28,928 rows and
   the dense corpus in 2 shards of 28,928 rows; each rank must launch K2
   and K5 and return the flat engine's results (sparse dict for dict,
   dense bit for bit); every process group has a 60 s timeout, and the
   parent waits at most 300 s, then kills the ranks and fails with a
   rank's traceback;
13. the measurement entry points (osr_tpu_torch/bench/), each mode in a
   process of its own through ``python -m osr_tpu_torch.bench``: the
   headline (bench.py's workload), whose last line must hold every key
   the tests fix, a positive value that is the median of 9 passes, a
   device and a host probe per pass and this card's line, with K2
   launched in its passes and K7 + K5 in its dense leg; hybrid --fusion
   rrf at full size (K2, K7, K5); scaling --head-dtype int4 (K3) at
   200,000 docs, its index built once by --save-index into the phase's
   scratch directory and loaded by --load-index; dense-scale at 200,000 x 768 (K7 + K5, K7 + K6); batch-curve
   (B = 8 to 6,656, each batch's queries counted and K2 launched);
   int4-quality at 50,000 docs (K2 on the int8 head, K3 on the int4
   head, each engine held to the plain head by the merge check on 256
   queries; the overlaps printed beside the committed TPU row); storage
   at its defaults (host only: every synthetic row passed, the unique-text
   rows measured or named in dropped, the anchor's store rates positive,
   no kernel); evidence --only probe,encoder (the probe's row this card,
   the encoder step dense-encoder at its defaults: K7 + K5 on the
   symmetric leg, K7 + K6 on the int4 leg, each equal to backend='torch'
   bit for bit; both logs written under --out); then the prose harvest
   of this interpreter's library trees: at 20,000 chunks or more
   quality-at-scale (noisy, dense hashing, f32 control), fusion-sweep and
   pipeline-87k at their defaults, below it the three must refuse and
   their functions run on the chunks there are; each launches a head
   kernel (K2, or K1 below the block-prune floor), K7 and K5, the sweep
   has the script's 13 points in its order, bm25_custom's IR metrics
   (and the sweep's sparse_only row) equal a run on the plain head, and
   pipeline-87k's two experiments (prose_87k.yaml's bm25 and hybrid
   RRF-IDF blocks) are ok, with preds and quality equal to a direct
   search of each block over the same dataset; then
   sharded-scale at 25,000 docs (8 gloo ranks on this card, mesh (2,
   4): 0 mismatched queries against the flat engine, 0
   differing dicts, K2 on every rank), sharded-overhead (a world of one
   under NCCL against the flat engine, 0 and 0, K2 in both engines; again
   with narrow_m=8 and extraction, K4-i8 in both), its overhead printed
   beside phase 12 (a)'s step ratio, profile-trace (a torch.profiler
   trace whose K2 events are as many as K2's launches; the top ten device
   operations printed), profile-latency (B=1, K2 on every iteration; the
   stage p50s beside search()'s) and profile-search at B = 1,024 (K2);
   then the stage and device-step profilers: profile-stages-1m
   over the saved int4 index (K3, candidates counted), profile-host-scale
   over it (host only, on the host runtime), profile-hybrid (K2, K7, K5;
   its stages sum to no more than its wall, both device steps timed with
   CUDA events), and at B = 2,048 profile-device (K2; its fused step equal
   to the engine's), profile-fused (K2; stage D equal to the engine's
   step bit for bit, stage E up to tied scores), profile-narrow (K2 and
   K4-i8; equal outputs across m), profile-blocksel and profile-topk2
   (selection only; their exactness flags true) and profile-topk-fix (K1;
   the chunked scan equal to the one-program top-k), each dropped row
   null and named. A mode that exits non-zero, or outlives 300 s (it is
   killed), fails the run.

Prints the card's name and power limit, a JSON line of per-kernel numbers
(with ``surface_launches`` and ``pipeline_launches``, phase 6's and phase
7's launches, on K2's, K7's and K5's, and ``benchmarks_launches``,
``sharded_launches`` and ``bench_launches``, phases 8's, 12's (both ranks
of (b) included) and 13's (the modes' measured passes, sharded-scale's
eight ranks included), on every kernel's),
and last a JSON line {"ok": true, "device": {...}}. Exits non-zero without
a result when no CUDA device is available. Run: python3 chip_smoke.py

``python3 chip_smoke.py --select`` builds, prints every kernel's
registers and shared memory and runs only phase 2's select kernel checks
and times.

``python3 chip_smoke.py --host-stages [--tree DIR]`` times only the
sparse path's host stages (one FiQA-scale batch stage by stage, and the
FiQA and 1M tail walks, first batch and later ones) for the port of this
checkout or of the checkout DIR, to compare two commits in one call.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# bench.py's workload (BATCH = 3,328: two batches per pass), the H100's
# peaks, the head kernels' byte and operation count, the launch counts,
# one batch stage by stage, CUDA-event timing and the index state handed
# to spawned ranks: one definition, shared with the port's measurement
# entry points.
from osr_tpu_torch.bench.common import (
    BATCH,
    INT8_HEAD_KERNELS,
    MERGE_QUERIES,
    NUM_QUERIES,
    PEAK_BF16_FLOPS,
    PEAK_BYTES,
    PEAK_F32_OPS,
    PEAK_INT8_OPS,
    TOP_K,
    all_launches,
    bench_case,
    card_line,
    check_host_runtime,
    differing_dicts,
    head_work,
    index_state,
    make_corpus,
    make_queries,
    median_ms,
    median_stages,
    merge_check,
    prose_roots,
    reset_all_launches,
    same_results,
)

DEEP_K = 1_000  # the depth BEIR evaluation retrieves
DENSE_DOCS = 1_000_000
DENSE_DIM = 768
DENSE_BATCH = 1_024
DENSE_QUERIES = 4_096
DENSE_CHECK = 256  # queries held against the backend='torch' engine
BENCH_DENSE_BATCH = 4_096  # bench.py's dense batch
HEAD_KERNELS = {
    # launch-counter name: the Pallas kernel it replaces
    "head_scores_i8": "osr_tpu/ops/pallas/head.py:42",
    "head_blockmax_i8": "osr_tpu/ops/pallas/head.py:208",
    "head_blockmax_i4": "osr_tpu/ops/pallas/head.py:225",
}
TOPM_KERNELS = {
    "head_blocktopm_i8": "osr_tpu/ops/pallas/head.py:372",
    "head_blocktopm_i4": "osr_tpu/ops/pallas/head.py:372",
}
NARROW_M = 8  # the extraction plan's per-block m (tools/bench_scaling.py)
M1_DOCS = 1_000_000
M1_VOCAB = 400_000
M1_QUERIES = 2_048  # one batch of B = 2,048
M1_CHUNK = 500_000  # score_chunk_rows: 2 chunks of 500,096 rows
# The walker check past 2^24 rows: the tail postings of a 67,108,864-row
# index (row chunks lift osr_tpu's 2^24 cap), 50,000 tail terms with
# Zipf-like document frequencies, about 5M postings (cut from 10M, whose
# generation took 19.0 s on an H100 machine's host, when phase 13 grew by
# nine modes), 1,024 queries.
WALK_ROWS = 1 << 26
WALK_TERMS = 50_000
WALK_POSTINGS = 5_000_000
WALK_QUERIES = 1_024
DENSE_KERNELS = {
    "int8_similarity": "osr_tpu/ops/pallas/matmul.py:24",
    "int4_similarity": "osr_tpu/ops/pallas/matmul.py:36",
    "quantize_symmetric": "osr_tpu/ops/pallas/quantize.py:24",
    "quantize_symmetric_stochastic": "osr_tpu/ops/pallas/quantize.py:32",
    "dequantize_symmetric": "osr_tpu/ops/pallas/quantize.py:115",
}
SELECT_KERNELS = {
    "topk_select": "none: lax.top_k was XLA's primitive, no Pallas kernel",
}
KERNELS = {**HEAD_KERNELS, **TOPM_KERNELS, **DENSE_KERNELS, **SELECT_KERNELS}
SOURCES = {
    "head_wgmma.cu": ("head_scores_i8", "head_blockmax_i8",
                      "head_blocktopm_i8", "head_blockmax_i4",
                      "head_blocktopm_i4"),
    "similarity_wgmma.cu": ("int8_similarity", "int4_similarity"),
    "quantize.cu": ("quantize_symmetric", "quantize_symmetric_stochastic",
                    "dequantize_symmetric"),
    "topk_select.cu": ("topk_select",),
}
SOURCE_OF = {k: f"osr_tpu_torch/csrc/{src}" for src, ks in SOURCES.items()
             for k in ks}
# ptxas function-name fragments of the instantiations the paths launch.
MANGLED = {
    "head_wgmma_kernelILb1ELi2E": "head_scores_i8",
    "head_wgmma_kernelILb1ELi0E": "head_blockmax_i8",
    "head_wgmma_kernelILb1ELi1E": "head_blocktopm_i8",
    "head_wgmma_kernelILb0ELi0E": "head_blockmax_i4",
    "head_wgmma_kernelILb0ELi1E": "head_blocktopm_i4",
    "similarity_wgmma_kernelILb0ELb1E": "int8_similarity",
    "similarity_wgmma_kernelILb1ELb1E": "int4_similarity",
    "quantize_rows_kernelILb0ELb1E": "quantize_symmetric",
    "quantize_rows_kernelILb1ELb1E": "quantize_symmetric_stochastic",
    "dequantize_rows_kernelILb1E": "dequantize_symmetric",
    "topk_select_kernelILb1E": "topk_select",  # float32 (int32 is ILb0E)
}
# The selections of the benchmark's cells: (the cell, the selection, rows,
# row width, k).
SELECT_SHAPES = (
    ("fiqa-bm25.top1000", "full row", 3_328, 57_728, 1_000),
    ("fiqa-bm25.batch", "block maxima", 3_328, 451, 50),
    ("fiqa-bm25.batch", "candidates", 3_328, 6_400, 50),
    ("msmarco-bm25.top1000", "sweep candidates", 3_496, 128_000, 1_000),
    ("msmarco-bm25.top1000", "sweep block maxima", 3_496, 17_270, 1_000),
    ("msmarco-bm25.top1000", "chunk merge", 3_496, 4_000, 1_000),
    ("nq-contriever-int8.batch", "block maxima", 1_024, 20_949, 100),
    ("nq-contriever-int8.batch", "candidates", 1_024, 12_800, 100),
    ("nq-contriever-int8.interactive", "block maxima", 1, 20_949, 10),
    ("nq-contriever-int8.interactive", "candidates", 1, 1_280, 10),
)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def kernel_resources():
    """(registers per thread, shared memory bytes per block) of each kernel
    as ptxas reports them (``nvcc --resource-usage``, one process per
    source, run at once), plus the dynamic shared memory the TMA kernels
    request at launch; both set blocks per SM. Fails if ptxas serialized a
    wgmma pipeline (its C7513/C7515 warnings)."""
    from osr_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = _build.BUILD_DIR / f"resource_usage_{src}.o"
        procs.append((obj, subprocess.Popen(
            [_build._nvcc(), *flags, "--resource-usage", "-c", "-o",
             str(obj), str(_build.CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    outs = []
    for obj, proc in procs:  # wait for every nvcc before judging any
        outs.append(proc.communicate(timeout=600)[0])
        obj.unlink(missing_ok=True)
    regs, smem, current = {}, {}, None
    for (_, proc), out in zip(procs, outs):
        if proc.returncode != 0:
            fail(f"nvcc --resource-usage failed:\n{out}")
        if "instructions are serialized" in out:
            fail(f"ptxas serialized a wgmma pipeline:\n{out}")
        for line in out.splitlines():
            current = next(
                (n for m, n in MANGLED.items() if m in line), current
            )
            if "registers" in line and current is not None:
                regs[current] = int(line.split("Used ")[1].split()[0])
                found = re.search(r"(\d+) bytes smem", line)
                smem[current] = int(found.group(1)) if found else 0
                current = None
    if set(regs) != set(KERNELS):
        fail(f"ptxas reported registers for {sorted(regs)} only")
    lib = _build.library("head_wgmma")
    for name in SOURCES["head_wgmma.cu"]:
        smem[name] += lib.osr_head_wgmma_smem_bytes(name.endswith("i8"))
    lib = _build.library("similarity_wgmma")
    for name in SOURCES["similarity_wgmma.cu"]:
        smem[name] += lib.osr_similarity_wgmma_smem_bytes(
            name.startswith("int4")
        )
    return regs, smem


# The SASS each TMA + wgmma source's kernels must hold: HGMMA (bf16 wgmma)
# or IGMMA (integer wgmma), UTMALDG (TMA tensor loads), UTMASTG (TMA
# tensor stores).
SASS_REQUIRED = {
    "head_wgmma.cu": ("HGMMA", "UTMALDG"),
    "similarity_wgmma.cu": ("IGMMA", "UTMALDG", "UTMASTG"),
}
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "LDS", "STS", "PRMT",
            "LOP3", "IMAD", "HFMA2", "HADD2")


def check_sass():
    """The SASS (cuobjdump, beside nvcc) of each kernel of SASS_REQUIRED's
    sources must hold that source's instructions. Returns the static count
    of each of SASS_OPS in each kernel (the main loop's two stages are
    unrolled; the shared loads and stores and the decode's byte permutes,
    logic ops, integer multiplies and bf16 subtractions are the others)."""
    from pathlib import Path

    from osr_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    counts = {}
    for src, required in SASS_REQUIRED.items():
        out = subprocess.run(
            [str(cuobjdump), "-sass", str(_build._target(_build.CSRC / src))],
            capture_output=True, text=True, timeout=300,
        )
        if out.returncode != 0:
            fail(f"cuobjdump -sass failed:\n{out.stderr}")
        current = None
        for line in out.stdout.splitlines():
            if "Function :" in line:
                current = next(
                    (n for m, n in MANGLED.items() if m in line), None
                )
                if current is not None:
                    counts[current] = dict.fromkeys(SASS_OPS, 0)
            elif current is not None and "*/" in line:
                words = line.split("*/", 1)[1].split()
                if words and words[0].startswith("@"):
                    words = words[1:]
                op = words[0].split(".")[0] if words else ""
                if op in counts[current]:
                    counts[current][op] += 1
        for name in SOURCES[src]:
            if not all(counts.get(name, {}).get(op) for op in required):
                fail(f"{name}: its SASS lacks one of {required} ({counts})")
    return counts


# ----------------------------------------------------------------------
# The host runtime (csrc/host_runtime.cc)
# ----------------------------------------------------------------------


def host_line(native):
    """The host's CPU (its /proc/cpuinfo identity, and lscpu's model name
    where /proc leaves it unknown) and the runtime's thread count."""
    info = {}
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        key, _, value = line.partition(":")
        info.setdefault(key.strip(), value.strip())
    model = info.get("model name", "unknown")
    if model in ("", "unknown"):
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            model = re.search(r"Model name:\s*(.+)", out).group(1).strip()
        except (OSError, subprocess.SubprocessError, AttributeError):
            pass
    ident = ", ".join(f"{k} {info[k]}" for k in (
        "vendor_id", "cpu family", "model", "stepping", "cpu MHz"
    ) if k in info)
    return (f"host CPU {model} ({ident}; {len(os.sched_getaffinity(0))} "
            f"cores usable); runtime threads {native.get_num_threads()}")


def load_host_runtime():
    """Load the port's host runtime; fail unless it is the library built
    from csrc/host_runtime.cc under build/osr_tpu_torch/."""
    from osr_tpu_torch import native
    from osr_tpu_torch.ops import _build

    try:
        lib = check_host_runtime()
    except (ImportError, RuntimeError) as e:
        fail(str(e))
    log(f"host runtime: {lib.path} ({' '.join(_build.HOST_FLAGS)}); "
        f"{host_line(native)}")


def walk_posting_set(seed=24):
    """Tail postings of a WALK_ROWS-row index: rows unique and ascending
    per term, the first terms' last rows at the top of the range, so
    the radix walk needs its third 12-bit digit. Weights are multiples of
    1/16 below 4 and query counts 1 or 2, so every sum is exact in
    float32: the runtime's float32 sums and the NumPy body's float64 ones
    then agree bit for bit in any order, and the check holds the rows,
    their grouping and the contributions summed."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, WALK_TERMS + 1, dtype=np.float64) ** 0.8
    df = np.maximum(1, WALK_POSTINGS / ranks / np.sum(1 / ranks))
    term = np.repeat(np.arange(WALK_TERMS, dtype=np.int64),
                     df.astype(np.int64))
    rows = rng.integers(0, WALK_ROWS, size=term.size, dtype=np.int64)
    rows[:WALK_TERMS] = WALK_ROWS - 1 - np.arange(WALK_TERMS)
    key = np.unique(term * WALK_ROWS + rows)
    term, rows = key // WALK_ROWS, key % WALK_ROWS
    post_ptr = np.zeros(WALK_TERMS + 1, dtype=np.int64)
    np.cumsum(np.bincount(term, minlength=WALK_TERMS), out=post_ptr[1:])
    weights = (rng.integers(1, 64, size=rows.size) / 16).astype(np.float32)
    # Queries: 4-12 distinct tail terms each, frequent terms favoured.
    ids, counts, ptr = [], [], [0]
    for _ in range(WALK_QUERIES):
        t = np.unique(
            (WALK_TERMS * rng.random(rng.integers(4, 13)) ** 2).astype(np.int32)
        )
        ids.append(t)
        counts.append(rng.integers(1, 3, size=t.size).astype(np.float32))
        ptr.append(ptr[-1] + t.size)
    return (post_ptr, rows.astype(np.int32), weights, np.concatenate(ids),
            np.concatenate(counts), np.array(ptr, dtype=np.int64))


def walker_past_2_pow_24():
    """The tail walk over an index whose rows reach past 2^24: through
    tail_candidates_flat it must take the runtime (counted) and equal the
    NumPy body bit for bit. Prints both times."""
    from osr_tpu_torch import native
    from osr_tpu_torch.index import postings as P

    t0 = time.perf_counter()
    case = walk_posting_set()
    gen_s = time.perf_counter() - t0
    post_ptr, post_rows, _, ids, _, _ = case
    walked = int((post_ptr[ids + 1] - post_ptr[ids]).sum())
    walk = native.tail_candidates_native
    calls = []

    def counted(*args):
        calls.append(1)
        return walk(*args)

    native_ms = []
    native.tail_candidates_native = counted
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            got = P.tail_candidates_flat(
                *case, WALK_QUERIES, num_rows=WALK_ROWS, use_native=True
            )
            native_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        native.tail_candidates_native = walk
    if len(calls) != 3:
        fail(f"walker past 2^24: the runtime took {len(calls)} of 3 walks")
    t0 = time.perf_counter()
    want = P.tail_candidates_flat(
        *case, WALK_QUERIES, num_rows=WALK_ROWS, use_native=False
    )
    numpy_ms = (time.perf_counter() - t0) * 1e3
    same = got.total == want.total and all(
        getattr(got, n).tobytes() == getattr(want, n).tobytes()
        for n in ("rows", "cols", "tail", "ptr")
    )
    if not same:
        fail("walker past 2^24: the runtime's candidates differ from the "
             "NumPy body's")
    if int(got.rows.max()) < 1 << 24:
        fail("walker past 2^24: no candidate row reaches 2^24")
    log(f"walker past 2^24 ({WALK_ROWS} rows, {post_rows.size} postings "
        f"over {WALK_TERMS} terms, made in {gen_s:.1f} s; {WALK_QUERIES} "
        f"queries walk {walked} postings into {got.total} candidates, top "
        f"row {int(got.rows.max())}): the runtime equals the NumPy body bit "
        f"for bit; runtime {native_ms[0]:.3f} ms first, "
        f"{float(np.median(native_ms[1:])):.3f} ms median of the 2 later; "
        f"NumPy body {numpy_ms:.3f} ms")


def tail_walk_ms(index, texts, reps=6):
    """Wall ms of the tail walk of one batch of ``texts`` over ``index``,
    ``reps`` times in a row (the first call at a new size pays for its
    scratch pages)."""
    from osr_tpu_torch.index.postings import tail_candidates_flat
    from osr_tpu_torch.index.tokenizer import Tokenizer
    from osr_tpu_torch.retrieval.encoding import (
        QueryEncoder,
        encode_query_batch,
    )

    lay = index.layout
    enc = encode_query_batch(
        QueryEncoder(Tokenizer(index.vocabulary)), texts, len(texts),
        lay.head_terms,
    )
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        tail_candidates_flat(
            lay.post_ptr, lay.post_rows, lay.post_weights, enc.tail_ids,
            enc.tail_counts, enc.tail_ptr, len(texts), num_rows=lay.num_rows,
        )
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def walk_line(label, ms):
    return (f"{label} tail walk: first batch {ms[0]:.3f} ms, median of the "
            f"{len(ms) - 1} later {float(np.median(ms[1:])):.3f} ms; all "
            f"{[round(m, 3) for m in ms]}")


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


def tile_loads(head, b):
    """GB that the TMA of a head_wgmma.cu kernel copies from L2 into
    shared memory in one launch: per (128 x 128) block and stage, two
    16 KB query tiles and the raw head tile (128 rows x 128 int8 bytes or
    64 packed int4 bytes). Every block loads its queries' whole width
    again; this, not the device-memory bytes, is the traffic that grows
    with the tile count."""
    r, hw = head.shape
    row_bytes = 64 if head.dtype == torch.uint8 else 128
    blocks = -(-b // 128) * -(-r // 128)
    return blocks * -(-hw // row_bytes) * (2 * 16384 + 128 * row_bytes) / 1e9


def check_kernel(name, head, scales, qhead, valid):
    """Kernel vs plain on the same card inputs. Per entry, |kernel - plain|
    <= 4 F 2^-24 sum_j |q_j w_ij| (f32 summation order; the products are
    exact on both sides); masked entries exactly -inf; block maxima equal
    the maxima of the kernel's own scores. Returns max |kernel - plain|."""
    from osr_tpu_torch.ops import head as H

    got, gmax = kernel_call(name, head, scales, qhead, valid)
    want, _ = kernel_call(name, head, scales, qhead, valid, plain=True)
    torch.cuda.synchronize()
    bound = H.score_tolerance(head, scales, qhead)
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
    flops, nbytes = head_work(
        b, r, width, head.numel() * head.element_size(),
        blockmax=name != "head_scores_i8",
    )
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    loads = ""
    if SOURCE_OF[name].endswith("head_wgmma.cu"):
        gb = tile_loads(head, b)
        loads = f" tile_loads_GB={gb:.3f} ({gb / ms:.3f} TB/s)"
    log(
        f"kernel {name}: B={b} R={r} F={width} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={max(t_ops, t_bytes):.4f} max_abs_err={err:.3e} "
        f"TFLOP/s={flops / ms / 1e9:.1f}{loads}"
    )
    return {
        "name": name,
        "route": "cuda",
        "source": SOURCE_OF[name],
        "replaces": KERNELS[name],
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def select_scores(b, n, seed, dev):
    """Seeded (b, n) f32 scores with head scores' ties: Gaussians rounded
    to quarters and clamped at 0 (about half the entries 0), every
    seventh row all 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(b, n, generator=g, device=dev) * 4).round().clamp_min(0)
    x /= 4
    x[::7] = 0.0
    return x


def select_case(label, x, k):
    """The select kernel against the stable sort's first k on x (values
    and int32 indices bit for bit), and its time beside the sort's,
    torch.topk's (a yardstick the port never calls) and its bound: the
    scores read once and the (b, k) values and indices written once."""
    from osr_tpu_torch.ops import topk as T

    sorts = T.SORT_ROUTE["cuda"]
    vals, idx = T.topk(x, k=k)
    want_v, want_i = torch.sort(x, dim=-1, descending=True, stable=True)
    if (T.SORT_ROUTE["cuda"] != sorts
            or not torch.equal(idx, want_i[:, :k].int())
            or not torch.equal(vals.view(torch.int32),
                               want_v[:, :k].contiguous().view(torch.int32))):
        fail(f"select {label}: the kernel differs from the stable sort")
    del want_v, want_i
    b, n = x.shape
    ms = median_ms(lambda: T.topk(x, k=k), reps=10)
    sort_ms = median_ms(
        lambda: torch.sort(x, dim=-1, descending=True, stable=True), reps=5
    )
    library_ms = median_ms(lambda: torch.topk(x, k, dim=-1), reps=5)
    bound_ms = (4 * b * n + 8 * b * k) / PEAK_BYTES * 1e3
    log(f"select {label}: B={b} n={n} k={k} ms={ms:.4f} "
        f"sort_ms={sort_ms:.4f} torch_topk_ms={library_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({100 * bound_ms / ms:.1f}% of it)")
    return {"ms": ms, "plain_ms": sort_ms, "library_ms": library_ms,
            "bound_ms": bound_ms}


def select_phase(dev, own=()):
    """The select kernel at every selection shape of the benchmark's
    cells (SELECT_SHAPES, on select_scores), and at each (label, scores,
    k) of ``own``. Returns the kernels-JSON row, at the FiQA full-row
    shape; its launches are filled in later."""
    row = {"name": "topk_select", "route": "cuda",
           "source": SOURCE_OF["topk_select"],
           "replaces": KERNELS["topk_select"], "launches": 0,
           "max_abs_err": 0.0, "bound_by": "bytes"}
    for cell, what, b, n, k in SELECT_SHAPES:
        x = select_scores(b, n, b + n + k, dev)
        numbers = select_case(f"{cell} {what}", x, k)
        if (cell, what) == SELECT_SHAPES[0][:2]:
            row.update(numbers)
        del x
        torch.cuda.empty_cache()
    for label, x, k in own:
        select_case(label, x, k)
    return row


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


def blocktopm_case(dtype, exact_sum, dev, b=9, r=700, f=160, seed=7,
                   fp=None):
    """K4's small inputs: R off the 128-row tile (a ragged last block),
    B off the 128-query tile, invalid rows. Exact-sum inputs (power-of-two
    column scales, integer query counts, codes from a few levels) make
    every dot exact in f32 whatever the summation order, and hold many
    real ties. An int8 head has width fp (f by default), an int4 head
    packed width fp (f / 2 by default); columns f and up are zero."""
    rng = np.random.RandomState(seed)
    lo, hi = ((-2, 3) if exact_sum else (-127, 128)) if dtype == "int8" else (
        (0, 3) if exact_sum else (0, 16)
    )
    codes = rng.randint(lo, hi, (r, f))
    if dtype == "int8":
        head = np.zeros((r, fp or f), np.int8)
        head[:, :f] = codes
    else:  # block-packed: byte c holds columns c and fp + c
        fp = f // 2 if fp is None else fp
        full = np.zeros((r, 2 * fp), np.uint8)
        full[:, :f] = codes
        head = full[:, :fp] | (full[:, fp:] << 4)
    if exact_sum:
        scales = (2.0 ** -rng.randint(2, 6, f)).astype(np.float32)
        qhead = rng.randint(1, 3, (b, f)) * (rng.rand(b, f) < 0.05)
    else:
        scales = ((rng.rand(f) + 0.1) / 127.0).astype(np.float32)
        qhead = rng.randint(0, 4, (b, f))
    if dtype == "int4":  # the int4 head keeps its sign in the scale
        scales *= np.where(rng.rand(f) < 0.3, -1.0, 1.0).astype(np.float32)
    valid = rng.rand(r) > 0.1
    return [
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (head, scales, qhead.astype(np.float32), valid)
    ]


def check_blocktopm(head, scales, qhead, valid, m, exact_sum):
    """K4 vs its plain twin on the same card inputs. Exact-sum inputs:
    values bit-equal, rows equal wherever the value is finite (the row of
    a -inf value is unspecified, as in osr_tpu). Otherwise each value
    within the K1-K3 tolerance (the largest score_tolerance of the batch: a
    rank's value moves by at most the largest score error), and the plain
    score of each kernel row within twice it of the plain value at its
    rank (a near-tie may swap two rows). Returns max |kernel - plain|."""
    from osr_tpu_torch.ops import head as H

    got_v, got_r = H.masked_head_blocktopm(head, scales, qhead, valid, m=m)
    want_v, want_r = H.masked_head_blocktopm_plain(
        head, scales, qhead, valid, m
    )
    torch.cuda.synchronize()
    what = f"K4 {'int4' if head.dtype == torch.uint8 else 'int8'} m={m}"
    finite = torch.isfinite(want_v)
    if not torch.equal(torch.isfinite(got_v), finite):
        fail(f"{what}: -inf entries differ from the plain twin's")
    if exact_sum:
        if not (
            torch.equal(got_v, want_v)
            and torch.equal(got_r[finite], want_r[finite])
        ):
            fail(f"{what}: not bit-equal to the plain twin on exact sums")
        return 0.0
    tol = H.score_tolerance(head, scales, qhead).max().item()
    err = (got_v - want_v)[finite].abs().max().item() if finite.any() else 0
    if not err <= tol:
        fail(f"{what}: value error {err} over the tolerance {tol}")
    b, r = qhead.shape[0], head.shape[0]
    plain = H.masked_head_scores_plain(head, scales, qhead, valid)
    at = plain.gather(1, got_r.reshape(b, -1).long().clamp_max(r - 1))
    gap = (at.view_as(got_v) - want_v)[finite].abs()
    if gap.numel() and not gap.max().item() <= 2 * tol:
        fail(f"{what}: a row's score is {gap.max().item()} off its rank")
    return float(err)


def blocktopm_is_topm_of_blockmax(head, scales, qhead, valid, m=NARROW_M):
    """K4's (values, rows) equal the stable per-block top-m of K2's (K3's)
    own scores on the same inputs, bit for bit: the kernels share their
    main loop."""
    from osr_tpu_torch.ops import head as H
    from osr_tpu_torch.ops.topk import block_topm

    scores, _ = H.masked_head_scores_blockmax(head, scales, qhead, valid)
    want_v, want_r = block_topm(scores, m)
    del scores
    got_v, got_r = H.masked_head_blocktopm(head, scales, qhead, valid, m=m)
    torch.cuda.synchronize()
    if not (torch.equal(got_v, want_v) and torch.equal(got_r, want_r)):
        fail(f"K4 is not the per-block top-{m} of K2/K3's scores at B="
             f"{qhead.shape[0]}, R={head.shape[0]}")


def k1_is_k2_scores(head, scales, qhead, valid):
    """K1 is the scores-only epilogue of K2's kernel: on the same inputs
    its (B, R) scores equal K2's bit for bit."""
    from osr_tpu_torch.ops import head as H

    got = H.masked_head_scores(head, scales, qhead, valid)
    want, _ = H.masked_head_scores_blockmax(head, scales, qhead, valid)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"K1's scores differ from K2's at B={qhead.shape[0]}, "
             f"R={head.shape[0]}")


def blocktopm_numbers(name, head, scales, qhead, valid, m=NARROW_M):
    """K4's error, times and bound at a path shape. The yardstick (never
    called by the port): one cuBLAS bf16 product of the upcast head, the
    mask, and torch.topk of each 128-row block."""
    from osr_tpu_torch.ops import head as H

    err = check_blocktopm(head, scales, qhead, valid, m, exact_sum=False)
    torch.cuda.empty_cache()
    ms = median_ms(
        lambda: H.masked_head_blocktopm(head, scales, qhead, valid, m=m),
        reps=10,
    )
    plain_ms = median_ms(
        lambda: H.masked_head_blocktopm_plain(head, scales, qhead, valid, m),
        reps=3, warmup=1,
    )
    torch.cuda.empty_cache()
    hb = H.decode_head(head).to(torch.bfloat16)
    q = H.scaled_query(qhead, scales, hb.shape[1])
    b, r, width = q.shape[0], head.shape[0], q.shape[1]
    g = r // H.ROW_TILE
    not_valid = ~valid
    library_ms = median_ms(
        lambda: torch.topk(
            torch.matmul(q, hb.T)
            .masked_fill_(not_valid, float("-inf"))
            .view(b, g, H.ROW_TILE),
            m,
        ),
        reps=5,
    )
    del hb
    torch.cuda.empty_cache()
    flops = 2.0 * b * r * width
    nbytes = (
        head.numel() * head.element_size() + q.numel() * 2 + r
        + 2 * 4 * b * g * m
    )
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    gb = tile_loads(head, b)
    log(
        f"kernel {name}: B={b} R={r} F={width} m={m} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={max(t_ops, t_bytes):.4f} (bytes {t_bytes:.4f}) "
        f"max_abs_err={err:.3e} TFLOP/s={flops / ms / 1e9:.1f} "
        f"tile_loads_GB={gb:.3f} ({gb / ms:.3f} TB/s)"
    )
    return {
        "name": name,
        "route": "cuda",
        "source": SOURCE_OF[name],
        "replaces": KERNELS[name],
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


# The TMA rings' edges: (B, R, head width in bytes, logical F). A stage
# takes 128 int8 bytes, or 64 packed int4 bytes, of each head row.
RING_CASES = {
    "int8": (
        (1, 1, 16, 16), (64, 127, 16, 10), (130, 129, 48, 48),
        (257, 1031, 48, 37), (1, 129, 64, 64), (64, 1031, 112, 100),
        (257, 127, 112, 112), (130, 1, 128, 128), (64, 129, 128, 97),
        (257, 1031, 144, 144), (1, 1031, 2048, 2048),
        (130, 127, 2048, 1500),
    ),
    "int4": (
        (1, 1, 16, 32), (64, 127, 16, 20), (130, 129, 48, 96),
        (257, 1031, 48, 77), (1, 129, 64, 128), (64, 1031, 64, 100),
        (257, 127, 80, 160), (130, 1, 80, 97), (64, 129, 96, 192),
        (257, 1031, 96, 150), (1, 1031, 1024, 2048),
        (130, 127, 1024, 1500),
    ),
}


def ring_checks(dtype, dev):
    """K1/K2/K4-i8 or K3/K4-i4 at the edges of the TMA ring (RING_CASES),
    every other row of the last 128-row block invalid: K1/K2/K3 within the
    tolerance of their plain versions, K1's scores equal to K2's, and K4
    (m=8) equal to the per-block top-8 of K2's (K3's) own scores on random
    inputs; K4 bit-equal to its plain twin on exact-sum ones."""
    k, i = ("K2", "i8") if dtype == "int8" else ("K3", "i4")
    for b, r, fp, f in RING_CASES[dtype]:
        cases = []
        for exact_sum in (False, True):
            args = blocktopm_case(dtype, exact_sum, dev, b=b, r=r, f=f,
                                  seed=r + fp, fp=fp)
            args[3][(r - 1) // 128 * 128 + 1 :: 2] = False
            cases.append(args)
        err = check_kernel(f"head_blockmax_{i}", *cases[0])
        blocktopm_is_topm_of_blockmax(*cases[0])
        check_blocktopm(*cases[1], NARROW_M, exact_sum=True)
        k1 = ""
        if dtype == "int8":
            k1_err = check_kernel("head_scores_i8", *cases[0])
            k1_is_k2_scores(*cases[0])
            k1 = f"; K1 max_abs_err={k1_err:.3e}, equal to K2's scores"
        log(f"{dtype} ring edge B={b} R={r} head width {fp} F={f}: {k} "
            f"max_abs_err={err:.3e}; K4-{i} equals {k}'s per-block top-"
            f"{NARROW_M} and its exact-sum plain twin{k1}")


def blocktopm_small_checks(dev):
    """K4 against its plain twin at R=700, F=160, B=9, int8 and int4, m in
    1, 4, 8, 16: bit-equal on exact sums, within the bound on random
    inputs."""
    for dtype in ("int8", "int4"):
        for m in (1, 4, NARROW_M, 16):
            for exact_sum in (True, False):
                err = check_blocktopm(
                    *blocktopm_case(dtype, exact_sum, dev), m, exact_sum
                )
                log(f"small ragged check K4 {dtype} m={m} "
                    f"{'exact-sum' if exact_sum else 'random'}: "
                    f"max_abs_err={err:.3e}")


# ----------------------------------------------------------------------
# Main path
# ----------------------------------------------------------------------


def counted_search(engine, queries, top_k):
    """One pass with every launch count set to 0 just before it; returns
    (results, launch counts of this pass: the head kernels', the select
    kernel's, and ``topk_sort_route``, the CUDA selections that took the
    stable sort)."""
    from osr_tpu_torch.ops import head as H
    from osr_tpu_torch.ops import topk as T

    H.reset_launches()
    T.reset_launches()
    results = engine.search(queries, top_k=top_k)
    torch.cuda.synchronize()
    return results, {**H.LAUNCHES, **T.LAUNCHES,
                     "topk_sort_route": T.SORT_ROUTE["cuda"]}


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


# ----------------------------------------------------------------------
# More plans: extraction (K4), narrowing, approx; the 1M path
# ----------------------------------------------------------------------


def fiqa_plans(index, base, queries, dtype):
    """The extraction, narrowed and approx plans on one FiQA-scale index,
    each equal to ``base`` (the standard engine's results at top_k=50)
    dict for dict. Returns K4's launches in the extraction run."""
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    topm = "head_blocktopm_i4" if dtype == "int4" else "head_blocktopm_i8"
    scores_kernel = "head_blockmax_i4" if dtype == "int4" else "head_blockmax_i8"
    kw = dict(device="cuda", batch_sizes=(BATCH,), cache_queries=False)
    ex = SparseSearchEngine(
        index, narrow_m=NARROW_M, narrow_backend="extract", **kw
    )
    if not ex._use_extract(TOP_K):
        fail(f"{dtype}: the extraction plan does not apply at FiQA scale")
    results, counts = counted_search(ex, queries, TOP_K)
    if results != base:
        fail(f"{dtype} extraction: results differ from the standard "
             "engine's")
    if counts[topm] == 0:
        fail(f"{dtype} extraction launched no {topm}")
    log(f"{dtype} extraction (narrow_m={NARROW_M}): results equal the "
        f"standard engine's dict for dict; launches {counts}; tie-safety "
        f"re-runs {ex.stats()['extract_redispatches']}")
    for label, plan in ((f"narrow_m={NARROW_M}", {"narrow_m": NARROW_M}),
                        ("topk_mode='approx'", {"topk_mode": "approx"})):
        eng = SparseSearchEngine(index, **plan, **kw)
        results, pcounts = counted_search(eng, queries, TOP_K)
        if results != base:
            fail(f"{dtype} {label}: results differ from the standard "
                 "engine's")
        if pcounts[scores_kernel] == 0:
            fail(f"{dtype} {label} launched no {scores_kernel}")
        log(f"{dtype} {label}: results equal the standard engine's dict "
            f"for dict; launches {pcounts}")
    return counts[topm]


def million_path(dev):
    """Phase 9. Returns K4-i8's record, its launches from the (x) run."""
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.ops import head as H
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine
    from osr_tpu_torch.testing import SyntheticDataGenerator

    t0 = time.perf_counter()
    gen = SyntheticDataGenerator(seed=42)
    queries = gen.queries(
        M1_QUERIES, M1_VOCAB, avg_terms=11, word_prefix="t", min_terms=2
    )
    corpus = gen.zipf_corpus(
        M1_DOCS, M1_VOCAB, avg_len=130, word_prefix="t", min_len=5
    )
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = SparseIndexBuilder(head_dtype="int8").build(corpus)
    build_s = time.perf_counter() - t0
    del corpus
    lay = index.layout
    log(f"1M: corpus generated in {gen_s:.1f} s, index built in "
        f"{build_s:.1f} s (host): {lay.num_rows} rows, F={lay.head_terms}, "
        f"int8 head {lay.head.nbytes / 1e9:.3f} GB")

    kw = dict(device="cuda", batch_sizes=(M1_QUERIES,), cache_queries=False)
    t0 = time.perf_counter()
    eng = {
        "x": SparseSearchEngine(
            index, narrow_m=NARROW_M, narrow_backend="extract",
            score_chunk_rows=M1_CHUNK, **kw,
        ),
        "s": SparseSearchEngine(index, score_chunk_rows=M1_CHUNK, **kw),
        "f": SparseSearchEngine(index, score_chunk_rows=0, **kw),
    }
    log(f"1M: three engines built in {time.perf_counter() - t0:.1f} s; "
        f"device memory allocated {torch.cuda.memory_allocated() / 1e9:.3f} "
        "GB")
    for key in ("x", "s"):
        if eng[key].stats().get("score_chunks") != 2:
            fail(f"1M ({key}): {eng[key].stats().get('score_chunks')} score "
                 "chunks, not 2")
    if eng["f"]._dev.chunks is not None:
        fail("1M (f): the unchunked engine is chunked")
    if not eng["x"]._use_extract_chunked(TOP_K):
        fail("1M (x): the extraction plan does not apply")
    texts = list(queries.values())
    log(walk_line(f"1M, B={M1_QUERIES},", tail_walk_ms(index, texts)))
    results, counts = {}, {}
    for key, kernel in (("x", "head_blocktopm_i8"), ("s", "head_blockmax_i8"),
                        ("f", "head_blockmax_i8")):
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results[key], counts[key] = counted_search(eng[key], queries, TOP_K)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        nonempty = check_results(results[key], queries, TOP_K)
        log(f"1M ({key}): {len(queries)} queries in {secs:.2f} s, "
            f"{nonempty} non-empty, launches {counts[key]}; device memory "
            f"above the resident heads at peak {peak / 1e9:.3f} GB")
        if counts[key][kernel] == 0:
            fail(f"1M ({key}) launched no {kernel}")
    if results["x"] != results["s"]:
        fail("1M: extraction results differ from the standard chunked "
             "engine's")
    if not same_results(results["f"], results["s"]):
        fail("1M: the unchunked engine's results differ from the chunked")
    log("1M: (x) equals (s) dict for dict; (f) matches (s); tie-safety "
        f"re-runs in (x): {eng['x'].stats()['extract_redispatches']}")
    plain = SparseSearchEngine(
        index, head_backend="torch", score_chunk_rows=M1_CHUNK, **kw
    )
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plain.search(dict(list(queries.items())[:MERGE_QUERIES]), top_k=TOP_K)
    peak = torch.cuda.max_memory_allocated() - before
    n = merge_check(eng["f"], plain, queries)
    log(f"1M merge check: the plain chunked engine matches (f) on "
        f"{MERGE_QUERIES} queries; {n} candidates within merge_tau_slack; "
        f"the plain engine's peak above the resident heads {peak / 1e9:.3f} "
        "GB")
    del plain
    torch.cuda.empty_cache()

    enc = eng["x"].encode_queries(texts)
    ids = torch.from_numpy(enc.head_ids).to(dev)
    w = torch.from_numpy(enc.head_weights).to(dev)
    step = {
        key: median_ms(lambda e=e: e.device_step(ids, w, TOP_K), reps=5)
        for key, e in eng.items()
    }
    qps = {}
    for key, e in eng.items():
        passes = []
        for _ in range(3):
            t0 = time.perf_counter()
            e.search(queries, top_k=TOP_K)
            passes.append(len(queries) / (time.perf_counter() - t0))
        qps[key] = float(np.median(passes))
        log(f"1M ({key}): device step {step[key]:.4f} ms per batch; QPS "
            f"(top_k={TOP_K}, B={M1_QUERIES}, median of 3) {qps[key]:.1f}; "
            f"passes {[round(p, 1) for p in passes]}; device step share of "
            f"a pass {step[key] / (len(queries) / qps[key] * 1e3):.3f}")
    for key in ("x", "s"):
        stages = median_stages(eng[key], texts, TOP_K)
        log(f"1M ({key}) one batch stage by stage (ms, median of 3): "
            f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}; "
            f"sum {sum(stages.values()):.3f}")
    del eng["s"], eng["f"]
    torch.cuda.empty_cache()

    # K4 and K2 at one 1M chunk, on the path's own inputs.
    head, scales, qhead, valid = bench_case(eng["x"], texts, chunk=0)
    blocktopm_is_topm_of_blockmax(head, scales, qhead, valid)
    log(f"1M chunk: K4 equals the per-block top-{NARROW_M} of K2's scores "
        "bit for bit")
    torch.cuda.empty_cache()
    k2_ms = median_ms(
        lambda: H.masked_head_scores_blockmax(head, scales, qhead, valid),
        reps=5,
    )
    gb = tile_loads(head, qhead.shape[0])
    log(f"kernel head_blockmax_i8 at one 1M chunk (B={qhead.shape[0]}, "
        f"R={head.shape[0]}): ms={k2_ms:.4f} tile_loads_GB={gb:.3f} "
        f"({gb / k2_ms:.3f} TB/s)")
    torch.cuda.empty_cache()
    row = blocktopm_numbers("head_blocktopm_i8", head, scales, qhead, valid)
    row["launches"] = counts["x"]["head_blocktopm_i8"]
    del eng, index, head, scales, qhead, valid, ids, w
    torch.cuda.empty_cache()
    return row


# ----------------------------------------------------------------------
# The retrieval surface: registry, hybrid fusion, learned sparse, service
# ----------------------------------------------------------------------

# osr_tpu/configs/prose_87k.yaml's two retriever blocks, on the card.
BM25_CONFIG = {"type": "bm25", "params": {
    "top_k": 100, "k1": 1.2, "b": 0.75, "cache_matrices": False,
    "device": "cuda"}}
HYBRID_CONFIG = {"type": "hybrid", "params": {
    "top_k": 100, "cache_matrices": False, "encoder": "hashing_idf",
    "fusion": "rrf", "sparse_weight": 1.0, "dense_weight": 1.0,
    "device": "cuda"}}
SURFACE_TOP_K = 100
SURFACE_KERNELS = ("head_blockmax_i8", "quantize_symmetric",
                   "int8_similarity")


def fused_equal(fast, full, top_k, rtol, atol, tie):
    """The array path's fused rows against the dict oracle's full fused
    lists (``_search_dicts`` at a depth that keeps every candidate): the
    same score sequence as the oracle's top ``top_k`` within rtol/atol,
    each id's own oracle score within them, and the oracle's ids in its
    order except inside ties (a neighbour within ``tie``, where the two
    paths may order or choose differently)."""
    for qid, f in fast.items():
        w = full[qid]
        ws = np.array(list(w.values()))
        fs = np.array(list(f.values()))
        if len(fs) != min(top_k, len(ws)) or not np.allclose(
            fs, ws[: len(fs)], rtol=rtol, atol=atol
        ):
            return False
        if any(d not in w or not np.isclose(s, w[d], rtol=rtol, atol=atol)
               for d, s in f.items()):
            return False
        for i, (a, b) in enumerate(zip(f, w)):
            if a != b and not any(
                abs(ws[i] - ws[j]) <= tie
                for j in (i - 1, i + 1) if 0 <= j < len(ws)
            ):
                return False
    return True


def hybrid_oracle_check(hy, sub, label, rtol, atol, tie):
    fast = hy.search(sub, top_k=SURFACE_TOP_K)
    full = hy._search_dicts(sub, top_k=2 * hy.fusion_depth)
    if not fused_equal(fast, full, SURFACE_TOP_K, rtol, atol, tie):
        fail(f"hybrid {label}: the array path differs from _search_dicts")
    log(f"hybrid {label}: {len(sub)} queries, the array path equals "
        f"_search_dicts (ids up to ties within {tie:g}, scores within rtol "
        f"{rtol:g} atol {atol:g})")


def hybrid_stages(hy, texts, top_k):
    """Wall time (ms) of each stage of one hybrid batch, run one after
    another (inside search() the dense step rides the device while the
    sparse host stages run)."""
    from osr_tpu_torch.retrieval.fusion import (
        fuse_topk_arrays,
        fused_rows_to_results,
    )

    sp, de, depth = hy.sparse.engine, hy.dense.engine, hy.fusion_depth
    ms = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        ms[name] = (now - t) * 1e3
        t = now

    vecs = hy.dense.embed_queries(texts)
    lap("embed")
    d_handle = de.dispatch_vectors(vecs, depth)
    lap("dense_dispatch")
    s_handle = sp.search_encoded_device(sp.encode_queries(texts), depth)
    lap("sparse_encode_dispatch")
    s_scores, s_ids = sp.finish_batch(s_handle, depth)
    lap("sparse_finish")
    d_scores, d_ids = de.collect_vectors(d_handle)
    lap("dense_collect")
    n = len(texts)
    f_sc, f_ids = fuse_topk_arrays(
        s_scores[:n], s_ids[:n], d_scores, d_ids, hy.sparse_weight,
        hy.dense_weight, top_k, mode=hy.fusion, rrf_k=hy.rrf_k,
    )
    lap("fusion")
    fused_rows_to_results(list(range(n)), f_sc, f_ids, sp._doc_names)
    lap("result_dicts")
    return ms


def dense_leg_pass(hy, texts):
    """The hybrid's dense leg alone over ``texts``: embed, dispatch and
    collect in the sparse engine's largest batch, two batches in flight."""
    from osr_tpu_torch.retrieval.pipeline_util import run_pipelined

    de, depth = hy.dense.engine, hy.fusion_depth
    run_pipelined(
        texts, hy.sparse.engine.batch_sizes[-1],
        lambda chunk: de.dispatch_vectors(hy.dense.embed_queries(chunk),
                                          depth),
        lambda chunk, handle: de.collect_vectors(handle),
        depth=2,
    )


def qps_passes(fn, n, before=None):
    passes = []
    for _ in range(3):
        if before is not None:
            before()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        passes.append(n / (time.perf_counter() - t0))
    return float(np.median(passes)), [round(p, 1) for p in passes]


def learned_vectors_file(corpus, path):
    """Seeded (term, weight) vectors over each doc's own terms (NumPy,
    seed 11), written as an npz for the splade route's vectors_path."""
    from osr_tpu_torch.index.builder import SparseIndexBuilder

    doc_ids = list(corpus)
    counted = SparseIndexBuilder._count_corpus_native(
        [corpus[d]["text"] for d in doc_ids]
    )
    if counted is None:
        fail("the splade vectors need the native runtime")
    vocabulary, _, _, indptr, term_ids, _ = counted
    terms = [""] * len(vocabulary)
    for t, i in vocabulary.items():
        terms[i] = t
    weights = np.random.RandomState(11).gamma(
        2.0, 0.7, size=len(term_ids)
    ).astype(np.float32)
    np.savez(path, doc_ids_json=json.dumps(doc_ids),
             vocab_json=json.dumps(terms), indptr=indptr, term_ids=term_ids,
             weights=weights)
    return len(term_ids)


def retrieval_surface(corpus, queries, scratch):
    """Phase 6: the retrieval surface at FiQA scale through the entry
    points a user calls. Returns the hybrid pass's launches of K2, K7 and
    K5."""
    from osr_tpu_torch import (
        Document,
        RetrievalService,
        RetrieverRegistry,
    )
    from osr_tpu_torch.ops.bm25 import fused_search
    from osr_tpu_torch.retrieval.engine import (
        DenseSearchEngine,
        SparseSearchEngine,
        dense_kernel_step,
    )

    k = SURFACE_TOP_K
    items = list(queries.items())
    sub = dict(items[:MERGE_QUERIES])
    texts = [t for _, t in items]

    # bm25, from prose_87k.yaml's block.
    t0 = time.perf_counter()
    bm25 = RetrieverRegistry.create(BM25_CONFIG)
    bm25.build_index_from_corpus(corpus)
    log(f"bm25 retriever built in {time.perf_counter() - t0:.1f} s "
        f"(head backend {bm25.engine.head_backend})")
    if bm25.engine.head_backend != "cuda":
        fail("the bm25 retriever does not take the CUDA kernels")
    reset_all_launches()
    bm25_res = bm25.search(queries, top_k=k)
    torch.cuda.synchronize()
    counts = all_launches()
    check_results(bm25_res, queries, k)
    if counts["head_blockmax_i8"] == 0:
        fail("the bm25 retriever launched no head_blockmax_i8")
    plain = SparseSearchEngine(bm25.index, device="cuda")
    if plain.search(queries, top_k=k) != bm25_res:
        fail("the bm25 retriever differs from SparseSearchEngine")
    log(f"bm25 retriever: {len(queries)} queries at top_k={k} equal "
        "SparseSearchEngine(device='cuda')'s dict for dict; launches "
        f"{ {n: c for n, c in counts.items() if c} }")
    del plain

    # The hybrid, from prose_87k.yaml's hybrid_rrf_idf block.
    hy = RetrieverRegistry.create(HYBRID_CONFIG)
    encoder = hy.dense.embedding_fn.__self__
    if encoder._nb is None:
        fail("the HashingEncoder has no native backend")
    encode_s = []

    def timed_encode(docs):
        t = time.perf_counter()
        out = encoder.encode(docs)
        encode_s.append(time.perf_counter() - t)
        return out

    hy.dense.embedding_fn = timed_encode
    t0 = time.perf_counter()
    hy.build_index_from_corpus(corpus)
    torch.cuda.synchronize()
    log(f"hybrid built in {time.perf_counter() - t0:.1f} s; HashingEncoder "
        f"(dim {encoder.dim}, idf, native) fit + encode of "
        f"{len(corpus)} docs {encode_s[0]:.2f} s")
    if hy.sparse.engine.head_backend != "cuda" or hy.dense.engine.backend != (
        "cuda"
    ):
        fail("the hybrid's engines do not take the CUDA kernels")
    reset_all_launches()
    t0 = time.perf_counter()
    fused = hy.search(queries, top_k=k)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = all_launches()
    check_results(fused, queries, k)
    surface = {n: counts[n] for n in SURFACE_KERNELS}
    log(f"hybrid rrf: {len(queries)} queries at top_k={k} in {secs:.2f} s; "
        f"launches {surface}")
    for n, c in surface.items():
        if c == 0:
            fail(f"the hybrid launched no {n}")
    hybrid_oracle_check(hy, sub, "rrf", 1e-6, 0.0, 1e-7)

    de = hy.dense.engine
    vecs = hy.dense.embed_queries(list(sub.values()))
    torch_eng = DenseSearchEngine.from_quantized(
        de.doc_ids, de._docs, de._scales, device="cuda", backend="torch"
    )
    got, want = de.search_vectors(vecs, k), torch_eng.search_vectors(vecs, k)
    if not (np.array_equal(got[1], want[1])
            and np.array_equal(got[0], want[0])):
        fail("the hybrid's dense leg and the backend='torch' engine disagree")
    log(f"hybrid dense leg: {len(sub)} queries give the backend='torch' "
        "engine's ids and bit-equal scores")
    del torch_eng

    qps, passes = qps_passes(lambda: hy.search(queries, top_k=k), len(texts))
    log(f"hybrid rrf QPS (top_k={k}, depth {hy.fusion_depth}, B="
        f"{hy.sparse.engine.batch_sizes[-1]}, median of 3): {qps:.1f}; "
        f"passes {passes}")
    b_qps, b_passes = qps_passes(
        lambda: bm25.search(queries, top_k=k), len(texts),
        before=bm25.clear_cache,
    )
    log(f"bm25 retriever QPS (top_k={k}, query cache cleared before each "
        f"pass, median of 3): {b_qps:.1f}; passes {b_passes}")
    d_qps, d_passes = qps_passes(lambda: dense_leg_pass(hy, texts),
                                 len(texts))
    log(f"hybrid dense leg alone QPS (embed, K7 + K5 + selection, depth "
        f"{hy.fusion_depth}, median of 3): {d_qps:.1f}; passes {d_passes}")
    batch = texts[: hy.sparse.engine.batch_sizes[-1]]
    runs = [hybrid_stages(hy, batch, k) for _ in range(3)]
    stages = {s: float(np.median([r[s] for r in runs])) for s in runs[0]}
    log(f"one hybrid batch stage by stage (B={len(batch)}, top_k={k}, ms, "
        f"median of 3): "
        f"{json.dumps({s: round(v, 3) for s, v in stages.items()})}; sum "
        f"{sum(stages.values()):.3f}")
    sp = hy.sparse.engine
    enc = sp.encode_queries(batch)
    ids, w = sp._upload(enc.head_ids), sp._upload(enc.head_weights)
    d = sp._dev
    sparse_ms = median_ms(
        lambda: fused_search(
            ids, w, d.empty_i32, d.empty_i32, d.head, d.head_scales, d.valid,
            head_terms=sp.index.layout.head_terms, k=hy.fusion_depth,
            head_backend=sp.head_backend,
        ),
        reps=10,
    )
    q = torch.from_numpy(hy.dense.embed_queries(batch)).to(de.device)
    dense_ms = median_ms(
        lambda: dense_kernel_step(q, de._docs, de._scales, hy.fusion_depth),
        reps=10,
    )
    n_batches = -(-len(texts) // len(batch))
    share = n_batches * (sparse_ms + dense_ms) / (len(texts) / qps * 1e3)
    log(f"hybrid device steps per batch of {len(batch)}: sparse (K2 + "
        f"selection) {sparse_ms:.4f} ms, dense (K7 + K5 + selection) "
        f"{dense_ms:.4f} ms; device step share of a hybrid pass {share:.3f}")
    hy.set_fusion(fusion="weighted", sparse_weight=0.3, dense_weight=0.7)
    hybrid_oracle_check(hy, sub, "weighted 0.3/0.7 (set_fusion, no rebuild)",
                        0.0, 1e-5, 2e-5)
    del hy, q, ids, w, d, sp, de

    # splade with learned vectors; queries fall back to their own tokens.
    path = scratch / "splade_vectors.npz"
    nnz = learned_vectors_file(corpus, path)
    lr = RetrieverRegistry.create(
        {"type": "splade", "params": {"vectors_path": str(path),
                                      "device": "cuda"}}
    )
    lr.build_index_from_corpus(corpus)
    reset_all_launches()
    l_res = lr.search(queries, top_k=k)
    torch.cuda.synchronize()
    counts = all_launches()
    check_results(l_res, queries, k)
    if counts["head_blockmax_i8"] == 0:
        fail("the splade retriever launched no head_blockmax_i8")
    plain = SparseSearchEngine(lr.index, device="cuda", head_backend="torch")
    want = plain.search_weighted(
        {q: lr._query_vec(q, t) for q, t in sub.items()}, top_k=k
    )
    if not same_results(lr.search(sub, top_k=k), want):
        fail("the splade retriever and the plain engine disagree")
    n = merge_check(lr.engine, plain, queries)
    log(f"splade (learned vectors, {nnz} (doc, term) weights, seed 11): "
        f"launches { {c: v for c, v in counts.items() if v} }; {len(sub)} "
        f"queries match the head_backend='torch' engine; {n} candidates "
        "within merge_tau_slack")
    del lr, plain

    # RetrievalService over the same documents.
    with RetrievalService(scratch / "corpus.osrd", create=True,
                          device="cuda") as svc:
        t0 = time.perf_counter()
        svc.add_documents(
            [Document(id=d, text=r["text"], title=r["title"])
             for d, r in corpus.items()]
        )
        store_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc.build_bm25_index()
        build_s = time.perf_counter() - t0
        hits = svc.search_bm25(sub, top_k=k)
        if hits != {q: bm25_res[q] for q in sub}:
            fail("RetrievalService.search_bm25 differs from the bm25 "
                 "retriever")
        for qid in list(sub)[:32]:
            joined = svc.get_search_results(hits[qid])
            if [r["text"] for r in joined] != [
                corpus[doc]["text"] for doc in hits[qid]
            ]:
                fail("get_search_results does not return the stored text")
        log(f"RetrievalService: {len(corpus)} docs stored in {store_s:.1f} "
            f"s, BM25 index from the store in {build_s:.1f} s; "
            f"search_bm25 on {len(sub)} queries equals the bm25 "
            "retriever's; get_search_results returns each hit's text")
    del bm25
    torch.cuda.empty_cache()
    return surface


# ----------------------------------------------------------------------
# The experiment pipeline: loaders, registry, readers, metrics, HFEncoder
# ----------------------------------------------------------------------

PIPELINE_QUERIES = 2_048  # FiQA's 6,648 cut to keep the phase near 120 s
PIPELINE_DATASET = "fiqa_scale"
# facebook/contriever's config.json (BERT-base), written here: nothing is
# downloaded. The weights are seeded.
CONTRIEVER = dict(vocab_size=30_522, hidden_size=768, num_hidden_layers=12,
                  num_attention_heads=12, intermediate_size=3_072,
                  max_position_embeddings=512, type_vocab_size=2)
# Docs the f32 encoder on the card is held to the CPU over: 64, cut from
# 256 when phase 13 grew by nine modes (the CPU forward of 256 took 39.4 s
# of the pipeline phase on an H100 machine's host).
ENCODER_CHECK_DOCS = 64
F32_CARD_ATOL = 1e-5  # f32 on the card (TF32 off) against f32 on the CPU
BF16_ATOL = 1e-2  # tests/test_torch_hf_encoder.py's bf16 tolerance
THROUGHPUT_DOCS = 4_096
PIPELINE_KERNELS = {
    "fiqa_contriever": ("quantize_symmetric", "int8_similarity"),
}


def contriever_tokenizer(texts):
    """WordPiece over the five specials plus the corpus's 30,517 most
    frequent terms (Contriever's vocabulary size)."""
    from collections import Counter

    from osr_tpu_torch.bert import SPECIAL_TOKENS, WordPieceTokenizer

    counts = Counter(w for t in texts for w in t.split())
    terms = [w for w, _ in counts.most_common(
        CONTRIEVER["vocab_size"] - len(SPECIAL_TOKENS))]
    return WordPieceTokenizer(list(SPECIAL_TOKENS) + terms)


def contriever_encoder(tokenizer, dtype, device):
    """HFEncoder at Contriever's width over a seeded BertModel (seed 0),
    max_length 256, batches of 64 (the repo's stand-in settings)."""
    from osr_tpu_torch import HFEncoder
    from osr_tpu_torch.bert import BertConfig, BertModel

    model = BertModel(BertConfig(**CONTRIEVER),
                      generator=torch.Generator().manual_seed(0))
    return HFEncoder(
        "contriever-width-standin-seed0", max_length=256, batch_size=64,
        model=model, tokenizer=tokenizer, dtype=dtype, device=device,
    )


def check_encoder(texts):
    """The Contriever-width encoder: f32 on the card against f32 on the
    CPU, bf16 on the card against f32 on the card, over
    ENCODER_CHECK_DOCS docs; then its
    bf16 throughput on the card. Returns the bf16 encoder."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        fail("TF32 is on: the f32 encoder check needs f32 products")
    docs = texts[:ENCODER_CHECK_DOCS]
    tokenizer = contriever_tokenizer(texts)
    t0 = time.perf_counter()
    cpu = contriever_encoder(tokenizer, "float32", "cpu").encode(docs)
    cpu_s = time.perf_counter() - t0
    f32 = contriever_encoder(tokenizer, "float32", "cuda").encode(docs)
    enc = contriever_encoder(tokenizer, "bfloat16", "cuda")
    bf16 = enc.encode(docs)
    f32_err = float(np.abs(f32 - cpu).max())
    bf16_err = float(np.abs(bf16 - f32).max())
    norms = np.linalg.norm(bf16, axis=1)
    log(f"HFEncoder at Contriever's width ({CONTRIEVER['num_hidden_layers']} "
        f"layers, hidden {CONTRIEVER['hidden_size']}, vocab "
        f"{CONTRIEVER['vocab_size']}): f32 on the card vs f32 on the CPU "
        f"over {len(docs)} docs max_abs_err={f32_err:.3e} (tolerance "
        f"{F32_CARD_ATOL:g}; the CPU took {cpu_s:.1f} s); bf16 vs f32 on the "
        f"card max_abs_err={bf16_err:.3e} (tolerance {BF16_ATOL:g})")
    width = CONTRIEVER["hidden_size"]
    if not (np.all(np.isfinite(bf16)) and bf16.shape == (len(docs), width)
            and np.allclose(norms, 1.0, atol=1e-5)):
        fail(f"the encoder's vectors are not finite unit rows of width {width}")
    if f32_err > F32_CARD_ATOL:
        fail("HFEncoder f32 on the card differs from the CPU")
    if bf16_err > BF16_ATOL:
        fail("HFEncoder bf16 differs from f32 beyond its tolerance")

    sample = texts[:THROUGHPUT_DOCS]
    enc.encode(sample[: enc.batch_size])
    t0 = time.perf_counter()
    enc.encode(sample)
    secs = time.perf_counter() - t0
    real = padded = 0
    for i in range(0, len(sample), enc.batch_size):
        mask = enc._tokenize(sample[i : i + enc.batch_size])["attention_mask"]
        real += int(mask.sum())
        padded += mask.numel()
    t0 = time.perf_counter()
    tok_only = [enc._tokenize(sample[i : i + enc.batch_size])
                for i in range(0, len(sample), enc.batch_size)]
    tok_s = time.perf_counter() - t0
    del tok_only
    t0 = time.perf_counter()
    for t in sample[:256]:
        enc.encode_one(t[:60])
    one_ms = (time.perf_counter() - t0) / 256 * 1e3
    log(f"HFEncoder bf16 on the card, {len(sample)} docs in batches of "
        f"{enc.batch_size}: {len(sample) / secs:.1f} docs/s, {real / secs:.1f} "
        f"tokens/s ({padded / secs:.1f} padded tokens/s; {real / len(sample):.1f} "
        f"tokens a doc); host tokenization alone {tok_s:.2f} s of "
        f"{secs:.2f} s; encode_one of a short text {one_ms:.3f} ms")
    return enc


def check_dataset(ds, texts, made):
    from osr_tpu_torch.storage.loaders import load_corpus, load_qrels, load_queries

    corpus = load_corpus(ds)
    queries = load_queries(ds)
    qrels = load_qrels(ds)
    if list(corpus) != [f"p{i}" for i in range(len(texts))] or any(
        corpus[f"p{i}"]["text"] != t for i, t in enumerate(texts)
    ):
        fail("load_corpus does not give back the written documents")
    if list(queries) != [f"q{i}" for i in range(made)] or any(
        not q["text"] for q in queries.values()
    ):
        fail("load_queries does not give back the written queries")
    if set(qrels) != set(queries) or any(
        sorted(r.values()).count(2) != 1 for r in qrels.values()
    ):
        fail("load_qrels: every query needs exactly one grade-2 document")
    return corpus, queries, qrels


class RecordedEncoder:
    """An encoder whose results are kept (copies) as the experiment asks
    for them, so that the direct check reads the same embeddings back
    (``replay``, ``replay_one``; a text not recorded is encoded) instead
    of a second BERT pass over the corpus and the queries; the
    experiment's own calls are not served from the record."""

    def __init__(self, enc):
        self.enc, self.corpus, self.queries = enc, {}, {}

    def encode(self, texts):
        emb = np.asarray(self.enc.encode(texts))
        self.corpus[tuple(texts)] = emb.copy()
        return emb

    def encode_one(self, text):
        emb = np.asarray(self.enc.encode_one(text))
        self.queries[text] = emb.copy()
        return emb

    def replay(self, texts):
        emb = self.corpus.get(tuple(texts))
        return self.encode(texts) if emb is None else emb.copy()

    def replay_one(self, text):
        emb = self.queries.get(text)
        return self.encode_one(text) if emb is None else emb.copy()


def check_against_direct(name, block, s, docs, queries, qrels, results,
                         made):
    """An experiment's summary ``s`` and its preds file under ``results``
    against a direct retriever.search of the same block over the same
    dataset: every query processed, the preds' retriever scores the
    direct search's first MAX_CONTEXTS, the quality evaluate_retrieval
    over the direct search."""
    from osr_tpu_torch import RetrieverRegistry
    from osr_tpu_torch.metrics.ir import evaluate_retrieval
    from osr_tpu_torch.pipeline import experiment as pipe
    from osr_tpu_torch.storage.loaders import extract_query_text

    if s.get("status") != "ok":
        fail(f"experiment {name}: {s}")
    if s["queries_processed"] != made or s["queries_failed"] != 0:
        fail(f"experiment {name} processed {s['queries_processed']} "
             f"queries, {s['queries_failed']} failed")
    query_texts = {q: extract_query_text(r) for q, r in queries.items()}
    direct = RetrieverRegistry.create(block)
    direct.build_index_from_corpus(docs)
    want = direct.search(query_texts, top_k=s["top_k"])
    check_results(want, query_texts, s["top_k"])
    preds = json.loads((results / f"{name}_preds.json").read_text())
    if [p["qid"] for p in preds] != list(query_texts) or any(
        list(p["retriever_scores"].items())
        != list(want[p["qid"]].items())[: pipe.MAX_CONTEXTS]
        for p in preds
    ):
        fail(f"experiment {name}: preds differ from a direct search")
    k_values = tuple(sorted({10, 100, s["top_k"]}))
    if s["quality"] != evaluate_retrieval(want, qrels, k_values=k_values):
        fail(f"experiment {name}: quality differs from evaluate_retrieval "
             "over the direct search")
    del direct
    torch.cuda.empty_cache()


def experiment_pipeline(corpus, scratch):
    """Phase 7: the experiment pipeline at FiQA scale through
    run_all_experiments on a config dict, with the Contriever-width
    HFEncoder (prose_87k.yaml's bm25 and hybrid blocks run through it in
    phase 13's pipeline-87k). Returns the pipeline's launches of K2, K7 and
    K5."""
    from osr_tpu_torch import run_all_experiments
    from osr_tpu_torch.bench.pipeline_87k import counted_experiments
    from osr_tpu_torch.testing import build_dataset

    texts = [d["text"] for d in corpus.values()]
    root = scratch / "datasets"
    t0 = time.perf_counter()
    made, grade1 = build_dataset(root / PIPELINE_DATASET, texts,
                                 PIPELINE_QUERIES, mode="noisy")
    if made != PIPELINE_QUERIES:
        fail(f"build_dataset made {made} queries, not {PIPELINE_QUERIES}")
    docs, queries, qrels = check_dataset(root / PIPELINE_DATASET, texts, made)
    log(f"dataset: {len(docs)} docs, {made} noisy queries, {grade1} grade-1 "
        f"qrels written as BEIR files and read back in "
        f"{time.perf_counter() - t0:.1f} s")

    enc = RecordedEncoder(check_encoder(texts))

    def contriever(embed, embed_one):
        return {"type": "contriever", "params": {
            "top_k": SURFACE_TOP_K, "embedding_fn": embed,
            "query_embedding_fn": embed_one, "device": "cuda"}}

    blocks = {
        "fiqa_contriever": (
            contriever(enc.encode, enc.encode_one),
            {"type": "extractive", "params": {"max_answer_length": 150}}),
    }
    direct = {"fiqa_contriever": contriever(enc.replay, enc.replay_one)}
    cfg = {
        "datasets_root": str(root),
        "output_dir": str(scratch / "results"),
        "experiments": [
            {"name": name, "dataset": PIPELINE_DATASET, "retriever": r,
             "reader": rd}
            for name, (r, rd) in blocks.items()
        ],
    }

    t0 = time.perf_counter()
    with counted_experiments(torch.device("cuda"), {}) as launches:
        overall = run_all_experiments(cfg)
    log(f"run_all_experiments: {len(overall)} experiments in "
        f"{time.perf_counter() - t0:.1f} s")
    json.loads((scratch / "results" / "overall_results.json").read_text())

    totals = {n: 0 for n in SURFACE_KERNELS}
    for name in blocks:
        s = overall[name]
        counts = launches.get(name, {})
        for kernel in PIPELINE_KERNELS[name]:
            if not counts.get(kernel):
                fail(f"experiment {name} launched no {kernel}")
        for n in totals:
            totals[n] += counts.get(n, 0)
        check_against_direct(name, direct[name], s, docs, queries, qrels,
                             scratch / "results", made)
        st = s["stage_times_s"]
        log(f"experiment {name}: build {s['build_time_s']:.2f} s, warmup "
            f"{s['warmup_time_s']:.2f} s, retrieve {s['retrieve_time_s']:.2f} "
            f"s; retrieval QPS {s['retrieval_qps']:.1f}, pipeline QPS "
            f"{s['queries_per_second']:.1f}; nDCG@10 "
            f"{s['quality']['ndcg@10']:.4f}; stages (s) "
            f"{json.dumps({k: round(v, 3) for k, v in st.items()})}; launches "
            f"{counts}; preds and quality equal a direct search of the same "
            "block")
    del enc, blocks, direct
    torch.cuda.empty_cache()
    return totals


# ----------------------------------------------------------------------
# The benchmark suites, the quality harness and the BEIR adapter
# ----------------------------------------------------------------------

BENCH_SPEC = Path(__file__).resolve().parent / "osr_tpu/configs/benchmarks.yaml"
SUITE_KERNELS = ("head_scores_i8", "int8_similarity", "quantize_symmetric",
                 "dequantize_symmetric")
QUALITY_METHODS = ("bm25", "tfidf")
BEIR_QUERIES = 256


def quantization_suite_kernels(cfg):
    """Phase 8 (a)'s K7, K8 and K5 against their plain versions, bit for
    bit, on the quantization suite's own inputs (its seeded embeddings and
    query rows, rebuilt by its setup) at the shapes the suite gives them.
    The suite's rows gate only on a cosine and a P@10 overlap, which a
    kernel off by a code or a scale ulp would pass."""
    from osr_tpu_torch.benchmarks.suites import QuantizationSuite
    from osr_tpu_torch.ops import matmul as M
    from osr_tpu_torch.ops import quantize_kernels as Q

    suite = QuantizationSuite(**cfg.suites.get("quantization", {}),
                              device="cuda")
    suite.setup()
    codes = {}
    for what, a in (("docs", suite.embeddings), ("queries", suite.query_vecs)):
        x = torch.from_numpy(a).cuda()
        codes[what] = Q.quantize_symmetric(x)
        exact(f"K7 on the quantization suite's {what} {tuple(x.shape)}",
              codes[what], Q.quantize_symmetric_plain(x))
    (d8, ds), (q8, qs) = codes["docs"], codes["queries"]
    exact(f"K8 on the quantization suite's codes {tuple(d8.shape)}",
          Q.dequantize_symmetric(d8, ds), Q.dequantize_symmetric_plain(d8, ds))
    exact(f"K5 on the quantization suite's {tuple(q8.shape)} x "
          f"{tuple(d8.shape)}", M.int8_similarity(q8, d8, qs, ds),
          M.int8_similarity_plain(q8, d8, qs, ds))
    log(f"  quantization suite inputs ({d8.shape[0]:,} x {d8.shape[1]}, "
        f"{q8.shape[0]} queries): K7 (docs and queries), K8 and K5 equal "
        "their plain versions bit for bit")


def bench_spec(scratch):
    """Phase 8 (a): the repo's benchmark spec through run_from_config on
    cuda. Returns the run's launches."""
    from osr_tpu_torch.benchmarks.runner import (
        load_benchmark_config,
        run_from_config,
    )

    cfg = load_benchmark_config(BENCH_SPEC)
    cfg.output_dir = str(scratch / "bench_suites")
    reset_all_launches()
    t0 = time.perf_counter()
    overall = run_from_config(cfg, device="cuda")
    torch.cuda.synchronize()
    counts = all_launches()
    secs = time.perf_counter() - t0
    rows = {}
    for suite in overall["suites"]:
        if suite["error"]:
            fail(f"benchmark suite {suite['suite']}: {suite['error']}")
        for r in suite["results"]:
            rows[f"{suite['suite']}/{r['name']}"] = r
            if not r["passed"]:
                fail(f"benchmark row {suite['suite']}/{r['name']} failed: "
                     f"{r['metrics']}")
    if not overall["all_passed"]:
        fail("the benchmark spec did not pass")
    parity = rows.get("bm25/head_kernel_parity")
    if parity is None:
        fail("the bm25 suite has no head_kernel_parity row on cuda")
    for kernel in SUITE_KERNELS:
        if counts[kernel] == 0:
            fail(f"the benchmark spec launched no {kernel}")
    if overall["backend_validation"]["platform"] != "gpu":
        fail("the suites' backend validation did not run on the card")
    log(f"benchmark spec {BENCH_SPEC.name} on cuda: "
        f"{overall['total_passed']}/{overall['total_benchmarks']} rows "
        f"passed in {secs:.1f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    m = parity["metrics"]
    log(f"  bm25/head_kernel_parity: K1 == K2 {m['k1_equals_k2_scores']}, "
        f"max |K1 - plain| {m['max_abs_err_vs_plain']:.3e} within the "
        f"tolerance {m['within_tolerance_of_plain']}; K1 "
        f"{m['kernel_s'] * 1e3:.4f} ms, plain {m['plain_s'] * 1e3:.4f} ms")
    quantization_suite_kernels(cfg)
    for name in ("bm25/throughput_vs_csr", "quantization/int8_matmul_speed",
                 "topk/topk_exact", "topk/topk_fast_bf16_rerank",
                 "topk/topk_approx_threshold", "storage/build",
                 "storage/random_access"):
        r = rows[name]
        log(f"  {name}: {json.dumps(r['metrics'])}; "
            f"{r['duration_s'] * 1e3:.3f} ms; grade {r['grade']}")
    return counts


def quality_run(ds, methods, out_dir, **engine_kwargs):
    """``bench.quality_at_scale.benchmark`` over ``ds`` (top_k=100, cuda),
    every SparseSearchEngine built with ``engine_kwargs``; returns its
    summaries and the kernels launched, failing if a method failed."""
    import functools

    from osr_tpu_torch.bench import quality_at_scale as qas
    from osr_tpu_torch.retrieval import registry

    engine = registry.SparseSearchEngine
    registry.SparseSearchEngine = functools.partial(engine, **engine_kwargs)
    try:
        return qas.benchmark(ds, out_dir, methods, torch.device("cuda"))
    except RuntimeError as e:
        fail(f"quality benchmark {out_dir.name} {e}")
    finally:
        registry.SparseSearchEngine = engine


def quality_at_scale(ds, scratch):
    """Phase 8 (b): run_quality_benchmark over phase 7's FiQA-scale
    dataset, bm25 and tfidf at top_k=100 on cuda (K2), against the same
    run with every engine's head on the plain version (which launches no
    kernel but the select kernel: its selections are on the card).
    Returns the kernel run's launches."""
    got, counts = quality_run(ds, QUALITY_METHODS, scratch / "quality")
    want, plain_counts = quality_run(
        ds, QUALITY_METHODS, scratch / "quality_plain", head_backend="torch"
    )
    if not counts.get("head_blockmax_i8"):
        fail("the quality benchmark launched no head_blockmax_i8")
    if any(v for k, v in plain_counts.items() if k not in SELECT_KERNELS):
        fail(f"the plain-head quality run launched kernels: {plain_counts}")
    for m in QUALITY_METHODS:
        ir = sorted(k for k in want[m] if "@" in k)
        diff = {k: (got[m][k], want[m][k]) for k in ir
                if got[m][k] != want[m][k]}
        if not ir or diff:
            fail(f"quality benchmark {m}: the kernel head's IR metrics "
                 f"differ from the plain head's: {diff}")
        r = got[m]
        log(f"quality benchmark {m} at FiQA scale ({r['num_docs']} docs, "
            f"{r['num_queries']} queries, top_k={r['top_k']}): build "
            f"{r['build_time_s']:.2f} s, cold search {r['cold_search_s']:.3f} "
            f"s, warm QPS {r['qps']:.1f} (plain head "
            f"{want[m]['qps']:.1f}); nDCG@10 {r['ndcg@10']:.4f}, recall@100 "
            f"{r['recall@100']:.4f}: IR metrics equal the plain head's")
    log(f"  quality launches {json.dumps({k: v for k, v in counts.items() if v})}")
    return counts


def beir_adapter(ds, scratch):
    """Phase 8 (c): BEIRCompatibleSearch on cuda over phase 7's corpus and
    256 of its queries, against SparseSearchEngine(device="cuda") on the
    same title + text, dict for dict; every hit's stored text back from
    get_documents. Returns the adapter's launches."""
    from osr_tpu_torch.benchmarks.beir_adapter import BEIRCompatibleSearch
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine
    from osr_tpu_torch.storage.loaders import (
        extract_query_text,
        load_corpus,
        load_queries,
    )

    corpus = load_corpus(ds)
    queries = {q: extract_query_text(r) for q, r in
               list(load_queries(ds).items())[:BEIR_QUERIES]}
    s = BEIRCompatibleSearch(store_path=scratch / "beir.osrd", device="cuda")
    try:
        reset_all_launches()
        t0 = time.perf_counter()
        got = s.search(corpus, queries, top_k=SURFACE_TOP_K)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = all_launches()
        if counts["head_blockmax_i8"] == 0:
            fail("the BEIR adapter launched no head_blockmax_i8")
        check_results(got, queries, SURFACE_TOP_K)
        searchable = {
            d: {"text": (r.get("title", "") + " " + r.get("text", "")).strip()}
            for d, r in corpus.items()
        }
        engine = SparseSearchEngine(
            SparseIndexBuilder(method="bm25").build(searchable),
            device="cuda", batch_sizes=(s.batch_size,),
        )
        want = engine.search(queries, top_k=SURFACE_TOP_K)
        if {q: list(r.items()) for q, r in got.items()} != {
            q: list(r.items()) for q, r in want.items()
        }:
            fail("the BEIR adapter's results differ from the engine's")
        hits = sorted({d for r in got.values() for d in r})
        docs = s.get_documents(hits)
        if any(doc is None or doc.id != d or doc.text != corpus[d]["text"]
               for d, doc in zip(hits, docs)):
            fail("get_documents does not give back each hit's stored text")
    finally:
        s.close()
    log(f"BEIR adapter on cuda: index + {len(queries)} queries in "
        f"{secs:.2f} s ({s.index_stats['num_docs']} docs); results equal "
        f"SparseSearchEngine(device='cuda') dict for dict; {len(hits)} hits' "
        f"stored texts read back; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts


def benchmark_suites(scratch):
    """Phase 8: the benchmark suites, the quality harness and the BEIR
    adapter on the card. Returns the phase's launches, summed."""
    ds = scratch / "datasets" / PIPELINE_DATASET
    totals = {}
    for counts in (bench_spec(scratch), quality_at_scale(ds, scratch),
                   beir_adapter(ds, scratch)):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    torch.cuda.empty_cache()
    return totals


# ----------------------------------------------------------------------
# Dense path: kernels K5-K8
# ----------------------------------------------------------------------


def exact(name, got, want):
    """Max |kernel - plain| over every output; fails unless it is 0 and
    the outputs are bit-equal (NaN-free)."""
    got, want = (got,) if torch.is_tensor(got) else got, (
        (want,) if torch.is_tensor(want) else want
    )
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{name}: kernel gives {g.dtype} {tuple(g.shape)}, plain "
                 f"{w.dtype} {tuple(w.shape)}")
        err = max(err, float((g.double() - w.double()).abs().max().item()))
        if not torch.equal(g, w):
            fail(f"{name}: kernel and plain differ (max_abs_err {err})")
    return err


def dense_calls(name, args, maxima=False):
    """(kernel call, plain call) of one dense kernel on ``args``; with
    ``maxima`` K5/K6's launch that writes the block maxima too, against
    the plain scores and ``topk.block_max`` of them."""
    from osr_tpu_torch.ops import matmul as M
    from osr_tpu_torch.ops import quantize_kernels as Q
    from osr_tpu_torch.ops.topk import block_max

    if maxima:
        kernel = getattr(M, name + "_blockmax")
        plain = getattr(M, name + "_plain")

        def plain_both():
            scores = plain(*args)
            return scores, block_max(scores)

        return lambda: kernel(*args), plain_both
    if name == "int8_similarity":
        return (lambda: M.int8_similarity(*args),
                lambda: M.int8_similarity_plain(*args))
    if name == "int4_similarity":
        return (lambda: M.int4_similarity(*args),
                lambda: M.int4_similarity_plain(*args))
    if name == "dequantize_symmetric":
        return (lambda: Q.dequantize_symmetric(*args),
                lambda: Q.dequantize_symmetric_plain(*args))
    stochastic = name == "quantize_symmetric_stochastic"
    return (
        lambda: Q.quantize_symmetric(args[0], stochastic=stochastic, seed=7),
        lambda: Q.quantize_symmetric_plain(
            args[0], stochastic=stochastic, seed=7
        ),
    )


def dense_bound(name, args, maxima=False):
    """(operations ms, bytes ms) the card needs at least for one call:
    each input read once, each output (with ``maxima`` the (B, N / 128)
    block maxima too) written once; int8 tensor-core
    operations for the products, the f32 rate outside the tensor cores
    for the element-wise kernels (4 operations an element to quantize:
    |x|, max, divide, round; 18 with the stochastic hash and compare; 1 to
    dequantize)."""
    if name.endswith("_similarity"):
        q8, docs, _, _ = args
        b, d, n = q8.shape[0], q8.shape[1], docs.shape[0]
        nbytes = b * d + docs.numel() + 4 * (b + n) + 4 * b * n
        if maxima:
            nbytes += 4 * b * -(-n // 128)
        return 2.0 * b * n * d / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    n, d = args[0].shape
    nbytes = 5 * n * d + 4 * n
    per = {"quantize_symmetric": 4, "quantize_symmetric_stochastic": 18,
           "dequantize_symmetric": 1}[name]
    return per * n * d / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3


def int_mm_padded(a, b_t):
    """torch._int_mm(a, b_t.T) with its operands zero-padded to the shapes
    it takes (rows of a > 16, k and columns multiples of 8); the port never
    calls it."""
    m, k = a.shape
    n = b_t.shape[0]
    pm, pk, pn = max(17 - m, 0), (-k) % 8, (-n) % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b_t = torch.nn.functional.pad(b_t, (0, pk, 0, pn))
    return torch._int_mm(a, b_t.T)[:m, :n]


def dense_library(name, args):
    """One PyTorch call computing the same function (a yardstick the port
    never calls), or None: cuBLAS int8 (torch._int_mm) plus the scale
    multiply for K5, the same on the decoded corpus for K6 (decode not
    timed), one promoting torch.mul for K8; no single call quantizes per
    row (K7)."""
    from osr_tpu_torch.ops.matmul import unpack_int4_signed

    if name == "int8_similarity" or name == "int4_similarity":
        q8, docs, qs, ds = args
        if name == "int4_similarity":
            docs = unpack_int4_signed(docs)
        return lambda: (
            int_mm_padded(q8, docs).float() * qs[:, None] * ds[None, :]
        )
    if name == "dequantize_symmetric":
        values, scales = args
        return lambda: torch.mul(values, scales[:, None])
    return None


def dense_numbers(name, args, plain_reps=3, maxima=False):
    """Kernel vs plain (error 0) and the times of one dense kernel on the
    main path's inputs ``args``; returns its record for the JSON line.
    With ``maxima``, K5/K6's launch that also writes the block maxima
    (scores and maxima each bit-equal to the plain ones), and the
    scores-only launch's time beside it."""
    kernel, plain = dense_calls(name, args, maxima)
    err = exact(name, kernel(), plain())
    torch.cuda.synchronize()
    ms = median_ms(kernel, reps=10)
    plain_ms = median_ms(plain, reps=plain_reps, warmup=1)
    lib = dense_library(name, args)
    library_ms = median_ms(lib, reps=5, warmup=1) if lib else None
    extra = ""
    if name.endswith("_similarity"):
        # cuBLAS's int8 product alone (int32 out, no scales), for scale.
        from osr_tpu_torch.ops.matmul import unpack_int4_signed

        q8, docs = args[0], args[1]
        if docs.dtype == torch.uint8:
            docs = unpack_int4_signed(docs)
        raw_ms = median_ms(lambda: int_mm_padded(q8, docs), reps=5)
        extra = f" int_mm_only_ms={raw_ms:.4f}"
        del docs
        if maxima:
            alone_ms = median_ms(dense_calls(name, args)[0], reps=10)
            extra += f" scores_only_ms={alone_ms:.4f}"
    t_ops, t_bytes = dense_bound(name, args, maxima)
    shape = " x ".join(str(a.shape[0]) for a in args[:2] if a.dim() == 2)
    log(
        f"kernel {name}{' with block maxima' if maxima else ''}: {shape} "
        f"(width {args[0].shape[1]}) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms="
        f"{'-' if library_ms is None else f'{library_ms:.4f}'}{extra} "
        f"bound_ms={max(t_ops, t_bytes):.4f} max_abs_err={err:.3e}"
    )
    return {
        "name": name,
        "route": "cuda",
        "source": SOURCE_OF[name],
        "replaces": KERNELS[name],
        "launches": 0,
        "block_maxima": maxima,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def dense_small_checks(dev):
    """K5, K6, K7 (both roundings) and K8 against their plain versions at
    ragged shapes off every tile: B=37, N=1,000, D=776 (776 % 16 = 8 and
    388 % 16 = 4: K5's and K6's wrappers pad); error 0. Then K5's and K6's
    edges."""
    rng = np.random.RandomState(9)
    b, n, d = 37, 1_000, 776
    q8 = torch.from_numpy(rng.randint(-128, 128, (b, d)).astype(np.int8))
    d8 = torch.from_numpy(rng.randint(-128, 128, (n, d)).astype(np.int8))
    d4 = torch.from_numpy(rng.randint(0, 256, (n, d // 2)).astype(np.uint8))
    qs = torch.from_numpy((rng.rand(b) / 127).astype(np.float32))
    ds = torch.from_numpy((rng.rand(n) / 127).astype(np.float32))
    x = torch.from_numpy(
        (rng.randn(n, d) * rng.rand(n, 1)).astype(np.float32)
    )
    x[0] = 0.0
    v = torch.from_numpy(rng.randint(-127, 128, (n, d)).astype(np.int8))
    cases = {
        "int8_similarity": (q8, d8, qs, ds),
        "int4_similarity": (q8, d4, qs, ds),
        "quantize_symmetric": (x,),
        "quantize_symmetric_stochastic": (x,),
        "dequantize_symmetric": (v, ds),
    }
    for name, args in cases.items():
        args = tuple(a.to(dev) for a in args)
        kernel, plain = dense_calls(name, args)
        err = exact(name, kernel(), plain())
        log(f"small ragged check {name}: B/N={b}/{n} D={d} "
            f"max_abs_err={err:.3e}")
    similarity_edge_checks(dev, int4=False)
    similarity_edge_checks(dev, int4=True)


# K5's edges (B, N, D), as tests/test_torch_quantize.py:K5_EDGES: widths
# below, at and off a 128-byte stage and off 16 bytes (padded by the
# wrapper), B and N off the 128 tiles, N off 4 (plain stores), N and B
# large enough that each persistent block walks several tiles, and widths
# of 1 to 16 stages.
K5_EDGES = (
    (5, 3, 1), (1, 1, 16), (64, 127, 24), (130, 129, 128), (1, 129, 100),
    (257, 1_031, 200), (130, 1, 256), (64, 1_031, 776), (257, 127, 768),
    (37, 300, 1_024), (130, 34_000, 768), (257, 33_795, 200),
    (17_000, 200, 64), (37, 300, 1_040), (130, 1_031, 2_048),
)
# K6's edges, as tests/test_torch_quantize.py:K6_EDGES: packed widths D/2
# below, at and off a 64-byte stage and off 16 bytes, B, N and the walks as
# above, and widths of 9 to 32 stages.
K6_EDGES = (
    (1, 1, 32), (64, 127, 48), (130, 129, 96), (257, 1_031, 128),
    (1, 129, 200), (130, 1, 256), (64, 1_031, 400), (257, 127, 776),
    (37, 300, 1_024), (130, 34_000, 768), (257, 33_795, 200),
    (17_000, 200, 64), (37, 300, 1_040), (130, 1_031, 2_048),
    (64, 34_000, 1_536),
)


def similarity_edge_checks(dev, int4):
    """K6 (int4) or K5 against its plain version at its edges, error 0;
    the wrapper pads (one corpus and one query copy) exactly where the
    corpus row (D/2 packed bytes, or D) is off 16 bytes."""
    from osr_tpu_torch.ops import matmul as M

    name = "int4_similarity" if int4 else "int8_similarity"
    kernel, plain = (
        (M.int4_similarity, M.int4_similarity_plain) if int4
        else (M.int8_similarity, M.int8_similarity_plain)
    )
    for b, n, d in K6_EDGES if int4 else K5_EDGES:
        rng = np.random.RandomState(b * n + d)
        q8 = rng.randint(-128, 128, (b, d)).astype(np.int8)
        docs = (rng.randint(0, 256, (n, d // 2)).astype(np.uint8) if int4
                else rng.randint(-128, 128, (n, d)).astype(np.int8))
        args = tuple(torch.from_numpy(a).to(dev) for a in (
            q8, docs, (rng.rand(b) / 127).astype(np.float32),
            (rng.rand(n) / 7).astype(np.float32),
        ))
        before = dict(M.PAD_COPIES)
        err = exact(name, kernel(*args), plain(*args))
        padded = int(docs.shape[1] % M.TMA_ALIGN != 0)
        if M.PAD_COPIES != {k: v + padded for k, v in before.items()}:
            fail(f"{name} at D={d}: operand copies {M.PAD_COPIES}, before "
                 f"{before}")
        log(f"{name} edge B={b} N={n} D={d}: max_abs_err={err:.3e}, "
            f"operand copies {padded}")


def device_corpus(n, dim, seed, dev):
    """synthetic_corpus_embeddings' recipe (50 clusters, noise 0.1, unit
    rows), drawn on the card from a seeded torch.Generator: 768M normals
    through NumPy would take tens of seconds on the host."""
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn(50, dim, generator=g, device=dev)
    assign = torch.randint(0, 50, (n,), generator=g, device=dev)
    emb = centers[assign]
    emb.add_(torch.randn(n, dim, generator=g, device=dev), alpha=0.1)
    emb.div_(emb.norm(dim=1, keepdim=True).clamp_min(1e-8))
    return emb


def dense_pass(engine, queries, top_k):
    """Every query through dispatch_vectors / collect_vectors in batches
    of DENSE_BATCH, all batches dispatched before the first is collected;
    returns (scores, ids) stacked."""
    handles = [
        engine.dispatch_vectors(queries[i : i + DENSE_BATCH], top_k)
        for i in range(0, len(queries), DENSE_BATCH)
    ]
    out = [engine.collect_vectors(h) for h in handles]
    return (np.concatenate([o[0] for o in out]),
            np.concatenate([o[1] for o in out]))


def check_dense_results(scores, ids, n_queries, n_docs):
    if scores.shape != (n_queries, TOP_K) or ids.shape != (n_queries, TOP_K):
        fail(f"dense results have shape {scores.shape}/{ids.shape}")
    if not np.all(np.isfinite(scores)):
        fail("dense scores are not finite")
    if np.any(np.diff(scores, axis=1) > 0):
        fail("dense results are not sorted by descending score")
    if ids.min() < 0 or ids.max() >= n_docs:
        fail("dense ids out of range")
    if np.any([len(set(r)) != len(r) for r in ids[:64]]):
        fail("a dense result repeats a document")


def dense_path(quantization, emb, doc_ids, queries, dev):
    """The dense main path for one quantization at full width, its checks
    and numbers. Returns (kernel records, launches of the run, summary)."""
    from osr_tpu_torch.ops import matmul as matmul_ops
    from osr_tpu_torch.ops import quantize as qz
    from osr_tpu_torch.ops import quantize_kernels as Q
    from osr_tpu_torch.ops import topk as T
    from osr_tpu_torch.retrieval.engine import (
        FUSED_MAXIMA_MIN_ROWS,
        DenseSearchEngine,
        dense_kernel_step,
    )

    sim = "int4_similarity" if quantization == "int4" else "int8_similarity"
    # The step takes K5/K6's block maxima at these shapes (dense_kernel_step).
    fused = (len(doc_ids) >= qz.BLOCK_SELECT_MIN_COLS
             and DENSE_BATCH >= FUSED_MAXIMA_MIN_ROWS)
    reset_all_launches()
    t0 = time.perf_counter()
    eng = DenseSearchEngine(doc_ids, emb, quantization=quantization,
                            device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores, ids = dense_pass(eng, queries, TOP_K)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = all_launches()
    copies = dict(matmul_ops.PAD_COPIES)
    label = f"dense {quantization} {len(doc_ids):,} x {DENSE_DIM}"
    log(f"{label}: engine built in {build_s:.2f} s (backend {eng.backend}); "
        f"{len(queries)} queries in {secs:.2f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} }; K5/K6 operand copies "
        f"{copies}")
    if any(copies.values()):
        fail(f"{label}: the {sim} wrapper copied operands ({copies})")
    if eng.backend != "cuda":
        fail(f"{label}: the engine does not take the CUDA kernels")
    for k in ("quantize_symmetric", sim, "topk_select"):
        if counts[k] == 0:
            fail(f"{label} launched no {k}")
    if T.SORT_ROUTE["cuda"]:
        fail(f"{label}: {T.SORT_ROUTE['cuda']} selections took the sort")
    if counts[sim + "_blockmax"] != (counts[sim] if fused else 0):
        fail(f"{label}: {counts[sim + '_blockmax']} of {counts[sim]} "
             f"{sim} launches wrote block maxima (fused path: {fused})")
    check_dense_results(scores, ids, len(queries), len(doc_ids))
    self_hit = float(np.mean(ids[:, 0] == np.arange(len(queries))))
    log(f"{label}: self-hit rate (top-1 is the query's own row) "
        f"{self_hit:.4f}")
    # int8 keeps a row's score against itself far above its cluster
    # neighbours' (cosine about 0.99); int4's coarser codes blur that
    # margin, so its rate is reported, not held to a floor.
    if quantization == "symmetric" and self_hit < 0.99:
        fail(f"{label}: self-hit rate {self_hit}")

    if quantization == "symmetric":
        pv, ps = Q.quantize_symmetric_plain(emb)
        if not (torch.equal(eng._docs, pv) and torch.equal(eng._scales, ps)):
            fail("the corpus codes differ from the plain quantizer's")
        del pv, ps
        log(f"{label}: corpus codes and scales equal the plain quantizer's")

    plain_eng = DenseSearchEngine.from_quantized(
        doc_ids, eng._docs, eng._scales, quantization=quantization,
        device="cuda", backend="torch",
    )
    sub = queries[:DENSE_CHECK]
    got, want = eng.search_vectors(sub, TOP_K), plain_eng.search_vectors(
        sub, TOP_K
    )
    if not (np.array_equal(got[1], want[1])
            and np.array_equal(got[0], want[0])):
        fail(f"{label}: kernel and backend='torch' engines disagree")
    log(f"{label}: {DENSE_CHECK} queries give the backend='torch' engine's "
        "ids and bit-equal scores")
    del plain_eng
    torch.cuda.empty_cache()

    # The kernels at the path's shapes, on the path's own inputs.
    batch = torch.from_numpy(queries[:DENSE_BATCH]).to(dev)
    q8, qs = qz.quantize_symmetric(batch)
    rows = [dense_numbers(sim, (q8, eng._docs, qs, eng._scales),
                          maxima=fused)]
    torch.cuda.empty_cache()

    step_ms = median_ms(
        lambda: dense_kernel_step(batch, eng._docs, eng._scales, TOP_K),
        reps=10,
    )
    passes = []
    for _ in range(5):
        t0 = time.perf_counter()
        dense_pass(eng, queries, TOP_K)
        passes.append(len(queries) / (time.perf_counter() - t0))
    qps = float(np.median(passes))
    eng.search_vectors(queries[:1], TOP_K)
    lats = []
    for i in range(40):
        t0 = time.perf_counter()
        eng.search_vectors(queries[i : i + 1], TOP_K)
        lats.append((time.perf_counter() - t0) * 1e3)
    busy = len(queries) / DENSE_BATCH * step_ms / (len(queries) / qps * 1e3)
    log(
        f"{label}: device step (K7 + {sim} + selection, B={DENSE_BATCH}) "
        f"{step_ms:.4f} ms; QPS (top_k={TOP_K}, B={DENSE_BATCH}, median of "
        f"5) {qps:.1f}; passes {[round(p, 1) for p in passes]}; device "
        f"step share of a pass {busy:.3f}; B=1 latency p50 "
        f"{np.percentile(lats, 50):.3f} ms, p95 "
        f"{np.percentile(lats, 95):.3f} ms"
    )
    del eng
    torch.cuda.empty_cache()
    return rows, counts


def quantization_round_trip(emb):
    """The op API's round trip (benchmarks/suites.py's quantization
    suite): quantize and dequantize the corpus, deterministic and
    stochastic; every reconstruction within one quantization step, the
    deterministic one within half a step, cosine >= 0.95. Returns (the
    launches of the run, the deterministic codes and scales)."""
    from osr_tpu_torch.ops import quantize as qz
    from osr_tpu_torch.ops import quantize_kernels as Q

    reset_all_launches()
    values, scales = qz.quantize_symmetric(emb)
    recon = qz.dequantize_symmetric(values, scales)
    sv, ss = Q.quantize_symmetric(emb, stochastic=True, seed=7)
    srecon = Q.dequantize_symmetric(sv, ss)
    torch.cuda.synchronize()
    counts = all_launches()
    # Half a step (one step when stochastic), plus the f32 rounding of
    # x / scale and of codes x scale: well under 1e-4 step for |code| <= 127.
    step = scales[:, None]
    if not bool(((recon - emb).abs() <= (0.5 + 1e-4) * step).all()):
        fail("round trip: an error above half a step")
    if not bool(((srecon - emb).abs() <= (1 + 1e-4) * step).all()):
        fail("round trip: a stochastic error above one step")
    cos = torch.nn.functional.cosine_similarity(recon, emb, dim=1).min()
    log(f"quantization round trip {emb.shape[0]:,} x {emb.shape[1]}: "
        "min cosine "
        f"{cos.item():.6f}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if cos.item() < 0.95:
        fail("round trip: cosine below 0.95")
    for k in ("quantize_symmetric", "quantize_symmetric_stochastic",
              "dequantize_symmetric"):
        if counts[k] == 0:
            fail(f"round trip launched no {k}")
    return counts, values, scales


def dense_phases(dev, bench_docs):
    """Phases 10 and 11; returns the dense kernels' records."""
    from osr_tpu_torch.index.dense import synthetic_corpus_embeddings
    from osr_tpu_torch.retrieval.engine import DenseSearchEngine

    t0 = time.perf_counter()
    emb = device_corpus(DENSE_DOCS, DENSE_DIM, 3, dev)
    queries = emb[:DENSE_QUERIES].cpu().numpy()  # corpus rows, as bench.py
    doc_ids = [f"d{i}" for i in range(DENSE_DOCS)]
    torch.cuda.synchronize()
    log(f"dense corpus {DENSE_DOCS} x {DENSE_DIM} drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    rows, launches = [], {}
    for quantization in ("symmetric", "int4"):
        r, counts = dense_path(quantization, emb, doc_ids, queries, dev)
        rows += r
        sim = r[0]["name"]
        launches[sim] = counts[sim]
        if quantization == "symmetric":
            launches["quantize_symmetric"] = counts["quantize_symmetric"]

    counts, values, scales = quantization_round_trip(emb)
    for k in ("quantize_symmetric_stochastic", "dequantize_symmetric"):
        launches[k] = counts[k]
    rows.append(dense_numbers("quantize_symmetric", (emb,)))
    batch = torch.from_numpy(queries[:DENSE_BATCH]).to(dev)
    batch_row = dense_numbers("quantize_symmetric", (batch,), plain_reps=5)
    log(f"kernel quantize_symmetric on one query batch ({DENSE_BATCH} x "
        f"{DENSE_DIM}): ms={batch_row['ms']:.4f} "
        f"bound_ms={batch_row['bound_ms']:.4f}")
    rows.append(dense_numbers("quantize_symmetric_stochastic", (emb,)))
    rows.append(dense_numbers("dequantize_symmetric", (values, scales)))
    del emb, values, scales
    torch.cuda.empty_cache()
    for r in rows:
        r["launches"] = launches[r["name"]]

    # For reference: bench.py's own dense shape (its corpus size x 768,
    # seed 3, the first 4,096 rows as one batch).
    bemb = synthetic_corpus_embeddings(bench_docs, dim=DENSE_DIM, seed=3)
    beng = DenseSearchEngine([str(i) for i in range(bench_docs)], bemb,
                             quantization="symmetric", device="cuda")
    qv = bemb[:BENCH_DENSE_BATCH]
    beng.search_vectors(qv, top_k=TOP_K)
    passes = []
    for _ in range(5):
        t0 = time.perf_counter()
        beng.search_vectors(qv, top_k=TOP_K)
        passes.append(len(qv) / (time.perf_counter() - t0))
    log(f"dense symmetric at bench.py's shape ({bench_docs} x {DENSE_DIM}, "
        f"B={BENCH_DENSE_BATCH}, top_k={TOP_K}): QPS median of 5 "
        f"{float(np.median(passes)):.1f}; passes "
        f"{[round(p, 1) for p in passes]}")
    return rows


# ----------------------------------------------------------------------
# Phase 12: the sharded engines (osr_tpu_torch/parallel/)
# ----------------------------------------------------------------------

SHARD_GROUP_TIMEOUT_S = 60  # every process group's collective timeout
SHARD_WAIT_S = 300  # the parent's wait for the two ranks of part (b)
SHARDED_SPARSE = (
    # (label, head dtype, top_k, engine options, the kernel it launches)
    ("int8 top_k=50", "int8", TOP_K, {}, "head_blockmax_i8"),
    ("int8 top_k=1000", "int8", DEEP_K, {}, "head_scores_i8"),
    ("int4 top_k=50", "int4", TOP_K, {}, "head_blockmax_i4"),
    ("int8 extraction", "int8", TOP_K,
     dict(narrow_m=NARROW_M, narrow_backend="extract"), "head_blocktopm_i8"),
    ("int4 extraction", "int4", TOP_K,
     dict(narrow_m=NARROW_M, narrow_backend="extract"), "head_blocktopm_i4"),
)
SHARDED_DENSE = (("symmetric", "int8_similarity"), ("int4", "int4_similarity"))


def add_counts(total, counts):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def sharded_step_inputs(sh, texts):
    """One batch's inputs to the sharded device step on the card: this
    rank's query slice and the whole batch's candidates (rows, cols)."""
    from osr_tpu_torch.index import postings as P

    lay = sh.index.layout
    enc = sh.encode_queries(texts)
    cand = P.tail_candidates_flat(
        lay.post_ptr, lay.post_rows, lay.post_weights, enc.tail_ids,
        enc.tail_counts, enc.tail_ptr, enc.head_ids.shape[0],
        num_rows=sh.num_rows,
    )
    ids, w = sh._query_slice(enc)
    return (ids, w, torch.from_numpy(cand.rows).cuda(),
            torch.from_numpy(cand.cols).cuda())


def run_sharded_step(sh, inputs, top_k):
    """The sharded device step of one batch: shard step, merge over d,
    candidate vector over the world, gather over q."""
    from osr_tpu_torch.parallel import sharded_search

    d = sh._dev
    return sharded_search(
        *inputs, d.head, d.head_scales, d.valid, comm=sh.comm,
        head_terms=sh.index.layout.head_terms, k=top_k,
        head_backend=sh.head_backend, block_prune=sh._block_prune(top_k),
    )


def sharded_step_ms(sh, flat, texts, top_k):
    """The device step of one batch (CUDA events, median of 10): the
    sharded engine's and the flat engine's fused_search, on the same
    queries and candidates."""
    from osr_tpu_torch.ops.bm25 import fused_search

    inputs = sharded_step_inputs(sh, texts)
    f = flat._dev
    sharded = median_ms(lambda: run_sharded_step(sh, inputs, top_k), reps=10)
    plain = median_ms(
        lambda: fused_search(
            *inputs, f.head, f.head_scales, f.valid,
            head_terms=flat.index.layout.head_terms, k=top_k,
            head_backend=flat.head_backend,
        ),
        reps=10,
    )
    return sharded, plain


def median_qps(engine, queries, top_k, runs=3):
    passes = []
    for _ in range(runs):
        t0 = time.perf_counter()
        engine.search(queries, top_k=top_k)
        passes.append(len(queries) / (time.perf_counter() - t0))
    return float(np.median(passes)), passes


def sharded_world_of_one(indexes, queries, emb, scratch):
    """Phase 12 (a): a world of one rank under NCCL, mesh (1, 1). Each
    sharded engine must equal the flat engine on the same index: sparse
    dict for dict (the standard plans the flat device merge, which reads
    the same candidate scores; extraction the host merge), dense ids and
    scores bit for bit, the hybrid (RRF) the flat HybridRetriever over the
    same two legs. Returns (the sharded
    engines' launches, the flat int8 top_k=50 results, the flat symmetric
    dense arrays)."""
    from datetime import timedelta

    import torch.distributed as dist

    from osr_tpu_torch import RetrieverRegistry
    from osr_tpu_torch.parallel import (
        ShardedDenseSearchEngine,
        ShardedHybridEngine,
        ShardedSparseSearchEngine,
        make_mesh,
    )
    from osr_tpu_torch.retrieval.engine import (
        DenseSearchEngine,
        SparseSearchEngine,
    )

    dist.init_process_group(
        "nccl", init_method=f"file://{scratch / 'world1.pg'}", rank=0,
        world_size=1, timeout=timedelta(seconds=SHARD_GROUP_TIMEOUT_S),
    )
    try:
        mesh = make_mesh(1)
        launches, want_sparse, world1 = {}, None, None
        texts = list(queries.values())[:BATCH]
        for label, dtype, k, opts, kernel in SHARDED_SPARSE:
            common = dict(batch_sizes=(BATCH,), cache_queries=False, **opts)
            # The standard sharded step reads its candidates' head scores
            # from the device scores, as the flat device merge does; the
            # extraction plan reads them from the host, as the host merge.
            flat = SparseSearchEngine(
                indexes[dtype], device="cuda",
                merge_backend="host" if opts else "device", **common,
            )
            want = flat.search(queries, top_k=k)
            sh = ShardedSparseSearchEngine(indexes[dtype], mesh, **common)
            if sh.comm.device.type != "cuda" or sh.head_backend != "cuda":
                fail("the world of one does not run on the card under NCCL")
            reset_all_launches()
            got = sh.search(queries, top_k=k)
            torch.cuda.synchronize()
            counts = all_launches()
            add_counts(launches, counts)
            if counts[kernel] == 0:
                fail(f"sharded {label} launched no {kernel}")
            bad = differing_dicts(got, want)
            if bad:
                fail(f"sharded {label}: {bad} queries differ from the flat "
                     "engine")
            check_results(got, queries, k)
            log(f"phase 12 (a) sharded {label}: equal to the flat engine "
                f"dict for dict; launches "
                f"{ {n: c for n, c in counts.items() if c} }")
            if label == "int8 top_k=50":
                want_sparse = want
                step, flat_step = sharded_step_ms(sh, flat, texts, k)
                qps, passes = median_qps(sh, queries, k)
                flat_qps, flat_passes = median_qps(flat, queries, k)
                log(f"phase 12 (a) device step int8 top_k={k}, B={BATCH}: "
                    f"sharded (1, 1) {step:.4f} ms, flat {flat_step:.4f} ms; "
                    f"QPS median of 3: sharded {qps:.1f} "
                    f"{[round(x, 1) for x in passes]}, flat {flat_qps:.1f} "
                    f"{[round(x, 1) for x in flat_passes]}")
                world1 = dict(step_ms=step, flat_step_ms=flat_step, qps=qps,
                              flat_qps=flat_qps)
            del flat, sh
            torch.cuda.empty_cache()

        doc_ids = [str(i) for i in range(emb.shape[0])]
        qv = emb[:DENSE_QUERIES]
        want_dense = None
        for quantization, kernel in SHARDED_DENSE:
            s1, i1 = DenseSearchEngine(
                doc_ids, emb, quantization=quantization, device="cuda"
            ).search_vectors(qv, top_k=TOP_K)
            reset_all_launches()
            sd = ShardedDenseSearchEngine(
                doc_ids, emb, mesh, quantization=quantization
            )
            s2, i2 = sd.search_vectors(qv, top_k=TOP_K)
            torch.cuda.synchronize()
            counts = all_launches()
            add_counts(launches, counts)
            for name in (kernel, "quantize_symmetric"):
                if counts[name] == 0:
                    fail(f"sharded dense {quantization} launched no {name}")
            if not (np.array_equal(i1, i2) and np.array_equal(s1, s2)):
                fail(f"sharded dense {quantization} differs from the flat "
                     "engine")
            check_dense_results(s2, i2, len(qv), len(doc_ids))
            log(f"phase 12 (a) sharded dense {quantization} "
                f"({emb.shape[0]} x {emb.shape[1]}, {len(qv)} queries, "
                f"top_k={TOP_K}): ids and scores equal to the flat engine "
                f"bit for bit; launches "
                f"{ {n: c for n, c in counts.items() if c} }")
            if quantization == "symmetric":
                want_dense = (s1, i1)
            del sd
            torch.cuda.empty_cache()

        hy = RetrieverRegistry.create({"type": "hybrid", "params": {
            "sparse_weight": 1.0, "dense_weight": 1.0, "fusion": "rrf",
            "fusion_depth": SURFACE_TOP_K, "embedding_dim": emb.shape[1],
            "device": "cuda", "cache_dir": None}})
        hy.sparse.engine = SparseSearchEngine(
            indexes["int8"], device="cuda", batch_sizes=(BATCH,),
            cache_queries=False, merge_backend="device",
        )
        hy.dense.engine = DenseSearchEngine(
            indexes["int8"].doc_ids, emb, quantization="symmetric",
            device="cuda",
        )
        want = hy.search(queries, top_k=SURFACE_TOP_K)
        del hy
        reset_all_launches()
        shy = ShardedHybridEngine(
            indexes["int8"], emb, mesh, sparse_weight=1.0, dense_weight=1.0,
            fusion_depth=SURFACE_TOP_K, fusion="rrf", batch_sizes=(BATCH,),
        )
        got = shy.search(queries, top_k=SURFACE_TOP_K)
        torch.cuda.synchronize()
        counts = all_launches()
        add_counts(launches, counts)
        bad = differing_dicts(got, want)
        if bad:
            fail(f"sharded hybrid: {bad} queries differ from the flat hybrid")
        log(f"phase 12 (a) sharded hybrid RRF (top_k={SURFACE_TOP_K}): equal "
            f"to the flat HybridRetriever over the same legs dict for dict; "
            f"launches { {n: c for n, c in counts.items() if c} }")
        del shy
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return launches, want_sparse, want_dense, world1


def two_rank_worker(rank, init_file, index_file, emb_file, queries, results):
    """Phase 12 (b): one of two ranks on the one card, under gloo, mesh
    (1, 2); puts (rank, True, its report) or (rank, False, a traceback)
    on ``results``."""
    import pickle
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    try:
        from osr_tpu_torch.convert import index_from_arrays
        from osr_tpu_torch.parallel import (
            ShardedDenseSearchEngine,
            ShardedSparseSearchEngine,
            make_mesh,
        )

        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=2, timeout=timedelta(seconds=SHARD_GROUP_TIMEOUT_S),
        )
        try:
            mesh = make_mesh(2)
            with open(index_file, "rb") as f:
                index = index_from_arrays(**pickle.load(f))
            emb = np.load(emb_file)
            sh = ShardedSparseSearchEngine(
                index, mesh, batch_sizes=(BATCH,), cache_queries=False
            )
            reset_all_launches()
            sparse = sh.search(queries, top_k=TOP_K)
            torch.cuda.synchronize()
            counts = all_launches()
            inputs = sharded_step_inputs(sh, list(queries.values())[:BATCH])
            step = median_ms(
                lambda: run_sharded_step(sh, inputs, TOP_K), reps=5
            )
            rows_sparse, transport = sh.rows_local, str(sh.comm.device)
            del sh, inputs
            torch.cuda.empty_cache()
            reset_all_launches()
            sd = ShardedDenseSearchEngine(
                [str(i) for i in range(emb.shape[0])], emb, mesh
            )
            dense = sd.search_vectors(emb[:DENSE_QUERIES], top_k=TOP_K)
            torch.cuda.synchronize()
            add_counts(counts, all_launches())
            report = dict(
                launches=counts, sparse=sparse, dense=dense, step_ms=step,
                rows=(rows_sparse, sd.rows_local), transport=transport,
            )
        finally:
            dist.destroy_process_group()
        results.put((rank, True, report))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def sharded_two_ranks(index8, emb, queries, want_sparse, want_dense, scratch):
    """Phase 12 (b): two spawned ranks on cuda:0 under gloo split the
    FiQA int8 head (2 x 28,928 rows) and the dense corpus (2 x 28,819
    rows); each must launch K2 and K5, and both must return the flat
    engine's results. Returns the two ranks' launches, summed."""
    import multiprocessing as mp
    import pickle
    import queue

    index_file = scratch / "index8.pkl"
    with open(index_file, "wb") as f:
        pickle.dump(index_state(index8), f)
    emb_file = scratch / "emb.npy"
    np.save(emb_file, emb)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(
            target=two_rank_worker,
            args=(r, str(scratch / "world2.pg"), str(index_file),
                  str(emb_file), queries, results),
        )
        for r in range(2)
    ]
    for p in procs:
        p.start()
    reports = {}
    try:
        deadline = time.monotonic() + SHARD_WAIT_S
        while len(reports) < 2:
            try:
                rank, ok, payload = results.get(
                    timeout=max(1.0, deadline - time.monotonic())
                )
            except queue.Empty:
                fail(f"phase 12 (b): ranks {sorted({0, 1} - set(reports))} "
                     f"did not answer in {SHARD_WAIT_S} s")
            if not ok:
                fail(f"phase 12 (b): rank {rank} failed:\n{payload}")
            reports[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    total = {}
    for rank in (0, 1):
        rep = reports[rank]
        for name in ("head_blockmax_i8", "int8_similarity"):
            if rep["launches"][name] == 0:
                fail(f"phase 12 (b): rank {rank} launched no {name}")
        bad = differing_dicts(rep["sparse"], want_sparse)
        if bad:
            fail(f"phase 12 (b): rank {rank}: {bad} queries differ from the "
                 "flat engine")
        s, i = rep["dense"]
        if not (np.array_equal(s, want_dense[0])
                and np.array_equal(i, want_dense[1])):
            fail(f"phase 12 (b): rank {rank}'s dense results differ from the "
                 "flat engine")
        add_counts(total, rep["launches"])
        log(f"phase 12 (b) rank {rank} of 2 on one card (gloo, transport "
            f"{rep['transport']}): shard rows sparse/dense {rep['rows']}; "
            f"sparse int8 top_k={TOP_K} equal to the flat engine dict for "
            f"dict, dense symmetric bit for bit; launches "
            f"{ {n: c for n, c in rep['launches'].items() if c} }; device "
            f"step (shard + gloo collectives) {rep['step_ms']:.4f} ms")
    return total


def sharded_phase(indexes, queries, emb, scratch):
    """Phase 12: (a) then (b); returns each kernel's sharded launches and
    part (a)'s int8 top_k=50 step and QPS, sharded and flat."""
    t0 = time.perf_counter()
    launches, want_sparse, want_dense, world1 = sharded_world_of_one(
        indexes, queries, emb, scratch
    )
    add_counts(launches, sharded_two_ranks(
        indexes["int8"], emb, queries, want_sparse, want_dense, scratch
    ))
    log(f"phase 12 (sharded engines) took {time.perf_counter() - t0:.1f} s")
    return launches, world1


# ----------------------------------------------------------------------
# Phase 13: the measurement entry points (osr_tpu_torch/bench/)
# ----------------------------------------------------------------------

# scaling runs at 200,000 docs, cut from 1M because its 1M index takes
# about 2 minutes to build on the host (phase 9 builds one already); it
# takes the int4 head (K3), which no other mode reaches. Its index is built
# once, by scaling --save-index into the phase's scratch directory, and the
# measured scaling run, profile-stages-1m and profile-host-scale load it:
# the last two take a dump by design and read this 200,000-doc int4 one,
# not the 1M int8 dump of their scripts' usage. dense-scale runs
# at 200,000 x 768, cut from its 1M default when the sharded and profiler
# modes took the script to 989 s on an H100 (over 900 s of its 1,200 s
# limit): phase 10 drives the same engines at 1M x 768 already (the
# default ran 56-59 s, the cut about 20 s). batch-curve runs at its
# defaults; storage and evidence (its probe and encoder steps; the encoder
# step is dense-encoder at its defaults) follow, then quality-at-scale,
# fusion-sweep (prose_modes) and pipeline-87k (pipeline_mode), then the
# sharded and profiler modes (sharded_modes,
# profiler_modes) and the stage and device-step profilers (stage_modes).
BENCH_SCALE_DOCS = 200_000
# int4-quality runs at 50,000 docs, cut from the script's 250,000 (72.5 s
# on an H100; 100,000 docs took 36.2-39.3 s) when phase 13 grew by nine
# modes; at its default it equalled the committed TPU row.
BENCH_QUALITY_DOCS = 50_000
# Paid for storage (12.9 s on an H100 machine), pipeline-87k (38.0 s) and
# evidence --only probe,encoder (21.7 s, of which the encoder step is the
# dense-encoder run it replaces, 8.3-10.4 s) when phase 13 grew by them:
# - phase 7 runs only its contriever experiment: prose_87k.yaml's bm25 and
#   hybrid blocks go through run_all_experiments on the card in
#   pipeline-87k, whose preds and quality phase 13 holds to a direct search
#   of each block (their two FiQA-scale experiments and direct builds took
#   about 40 s of phase 7);
# - phase 7's direct contriever check reuses the experiment's corpus and
#   query embeddings (a second BERT-base pass over 57,638 docs and 2,048
#   queries took about 30 s);
# - profile-search runs at its default B = 1,024 only (B = 8 and 128 took
#   29.9 s);
# - the prose harvest is no longer counted root by root (a second harvest
#   of every root, about 5 s).
BENCH_MODES = (
    # (the mode's arguments, the kernels each of its rows must launch)
    ((), ("head_blockmax_i8",)),
    (("hybrid", "--fusion", "rrf"),
     ("head_blockmax_i8", "quantize_symmetric", "int8_similarity")),
    (("scaling", "--docs", str(BENCH_SCALE_DOCS), "--head-dtype", "int4"),
     ("head_blockmax_i4",)),
    (("dense-scale", "--docs", str(BENCH_SCALE_DOCS)), None),
    (("batch-curve",), ("head_blockmax_i8",)),
    (("int4-quality", "--docs", str(BENCH_QUALITY_DOCS)), None),
)
BENCH_DENSE_KERNELS = {
    "symmetric": ("quantize_symmetric", "int8_similarity"),
    "int4": ("quantize_symmetric", "int4_similarity"),
}
BENCH_TIMEOUT_S = 300  # one mode's process; it is killed after
# The device-stage modes run at B = 2,048 (profile-trace's batch), cut
# from their scripts' 6,656: profile-device, profile-fused, profile-narrow,
# profile-blocksel, profile-topk2 and profile-topk-fix (their (B, R)
# matrices shrink from 1.53 GB to 0.47 GB); each ran at its default by
# hand on an H100 (PERF.md section 5). profile-hybrid runs at its
# defaults (B = 512).
STAGE_BATCH = 2_048
DEVICE_STAGE_MODES = (
    # (the mode, the kernels its row must launch, its row's checks)
    ("profile-device", ("head_blockmax_i8",), ("fused_equals_engine_step",)),
    ("profile-fused", ("head_blockmax_i8",),
     ("stage_d_equals_device_step", "stage_e_equals_device_step")),
    ("profile-narrow", ("head_blockmax_i8", "head_blocktopm_i8"),
     ("outputs_equal_across_m",)),
    ("profile-blocksel", ("topk_select",), ("scores_equal", "rows_equal")),
    ("profile-topk2", ("topk_select",), ("int_trick_exact",)),
    ("profile-topk-fix", ("head_scores_i8",),
     ("scan_equals_baseline", "scan_equals_baseline_scores")),
)
# The committed TPU rows of bench_results/int4_quality.jsonl (overlap@10,
# overlap@50): a quality artifact, printed beside the card's for the
# reader and no gate (the TPU's f32 head was XLA's default-precision
# product, the port's an f32 product with TF32 off).
TPU_HEAD_OVERLAPS = {"int8": (0.992, 0.9931), "int4": (0.9464, 0.9514)}
QAS_ARGS = ("quality-at-scale", "--query-mode", "noisy", "--dense-hashing",
            "--f32-control")


def bench_mode(args, refused=False, rows_expected=True):
    """``python -m osr_tpu_torch.bench *args`` in its own process, from this
    checkout; returns the JSON rows it printed, failing on a non-zero exit
    or a process that outlives BENCH_TIMEOUT_S (it is killed). With
    ``refused`` the mode must refuse: exit 1 and one row with no value and
    the reason. Without ``rows_expected`` it may print none."""
    label = " ".join(args) or "headline"
    t0 = time.perf_counter()
    try:
        res = subprocess.run(
            [sys.executable, "-m", "osr_tpu_torch.bench", *args],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=BENCH_TIMEOUT_S,
        )
    except subprocess.TimeoutExpired:
        fail(f"phase 13 {label}: no answer in {BENCH_TIMEOUT_S} s (killed)")
    if res.returncode != (1 if refused else 0):
        fail(f"phase 13 {label}: exit {res.returncode}:\n"
             f"{res.stderr[-4000:]}")
    rows = [json.loads(ln) for ln in res.stdout.splitlines()
            if ln.startswith("{")]
    if not rows and rows_expected:
        fail(f"phase 13 {label}: printed no row")
    if refused and (len(rows) != 1 or rows[0]["value"] is not None
                    or "need >=" not in rows[0]["error"]):
        fail(f"phase 13 {label}: no refusal: {rows}")
    log(f"phase 13 {label}: {time.perf_counter() - t0:.1f} s")
    for row in rows:
        log(f"phase 13 {label} row: {json.dumps(row)}")
    return rows


def check_launched(label, counts, kernels, total):
    for name in kernels:
        if not counts.get(name):
            fail(f"phase 13 {label}: launched no {name} ({counts})")
    add_counts(total, counts)


def check_headline(line, card, total):
    """The headline's last line: every key the tests fix, the median of 9
    passes, a probe pair per pass, the card, K2 in the passes and K7 + K5
    in the dense leg."""
    from osr_tpu_torch.bench import headline

    missing = set(headline.KEYS) - set(line)
    if missing:
        fail(f"phase 13 headline: keys missing {sorted(missing)}")
    passes = line["qps_passes"]
    if (line["metric"] != headline.METRIC or not line["value"] > 0
            or len(passes) != headline.PASSES
            or line["value"] != round(float(np.median(passes)), 1)):
        fail(f"phase 13 headline: value {line['value']} is not the median of "
             f"{headline.PASSES} passes {passes}")
    if not (len(line["contention_probe_ms"]) == len(line["host_probe_ms"])
            == headline.PASSES):
        fail("phase 13 headline: not one probe pair per pass")
    if line["device"] != card:
        fail(f"phase 13 headline: device {line['device']!r}, card {card!r}")
    if not line["topk_mode_approx_is_exact"]:
        fail("phase 13 headline: the approx leg's results differ from exact")
    if line["nonempty_results"] < 0.9 * NUM_QUERIES or not (
        line["host_threads"] > 0 and line["device_step_ms"] > 0
        and line["dense_int8_qps"] > 0
    ):
        fail("phase 13 headline: empty results or missing numbers")
    check_launched("headline passes", line["kernel_launches"],
                   ("head_blockmax_i8",), total)
    check_launched("headline dense leg", line["dense_kernel_launches"],
                   BENCH_DENSE_KERNELS["symmetric"], total)


def check_batch_curve(rows, card, total):
    """One row a batch size, in order, each timing the queries it says
    (as many as exist) and launching K2."""
    from osr_tpu_torch.bench import batch_curve

    if [r["batch"] for r in rows] != list(batch_curve.BATCHES):
        fail(f"phase 13 batch-curve: batches {[r['batch'] for r in rows]}")
    for r in rows:
        b = r["batch"]
        n = batch_curve.timed_count(b, NUM_QUERIES)
        if (r["queries_timed"] != n or not r["qps_median"] > 0
                or r["device"] != card):
            fail(f"phase 13 batch-curve B={b}: {r}")
        check_launched(f"batch-curve B={b}", r["kernel_launches"],
                       ("head_blockmax_i8",), total)


def check_int4_quality(rows, card, total):
    """The int8 row on K2, the int4 row on K3, each engine held to the
    plain head by the merge check in the mode; the overlaps printed beside
    the committed TPU row."""
    from osr_tpu_torch.bench import int4_quality

    if [r["head_dtype"] for r in rows] != ["int8", "int4"]:
        fail(f"phase 13 int4-quality: rows {rows}")
    for r in rows:
        dtype = r["head_dtype"]
        if (not r["merge_checked_candidates"] or r["device"] != card
                or not 0 < r["overlap_at_10"] <= 1
                or not 0 < r["overlap_at_50"] <= 1
                or r["num_queries"] < 0.9 * int4_quality.NUM_QUERIES):
            fail(f"phase 13 int4-quality {dtype}: {r}")
        check_launched(f"int4-quality {dtype}", r["kernel_launches"],
                       (int4_quality.KERNEL[dtype],), total)
        tpu = TPU_HEAD_OVERLAPS[dtype]
        log(f"phase 13 int4-quality {dtype} head against f32 at "
            f"{r['num_docs']} docs: overlap@10 {r['overlap_at_10']} (the TPU "
            f"row at 250,000 docs {tpu[0]}), overlap@50 "
            f"{r['overlap_at_50']} ({tpu[1]}); score MAE "
            f"{r['score_mae_on_f32_top50']}, relative "
            f"{r['score_mae_rel_top1']}; {r['merge_checked_candidates']} "
            "candidates within the merge slack of the plain head")


def check_dense_encoder(rows, card, total):
    """The kernel legs on the card's kernels (equal to backend='torch' bit
    for bit, which the mode checks), the others plain, every leg scored."""
    from osr_tpu_torch.bench import dense_encoder

    r = rows[-1]
    for key, _, kernels in dense_encoder.LEGS:
        want = "cuda" if kernels else "torch"
        recall = r[key].get(f"recall@{r['top_k']}", -1)
        if r["dense_backends"][key] != want or not 0 <= recall <= 1:
            fail(f"phase 13 dense-encoder {key}: backend "
                 f"{r['dense_backends'][key]}, recall {recall}")
    if r["kernel_route_equals_plain"] is not True or r["device"] != card:
        fail(f"phase 13 dense-encoder: {r}")
    check_launched("dense-encoder", r["kernel_launches"],
                   BENCH_DENSE_KERNELS["symmetric"] + ("int4_similarity",),
                   total)


def prose_modes(card, total, scratch):
    """quality-at-scale (noisy, dense hashing, f32 control) and
    fusion-sweep over this machine's prose harvest: at MIN_CHUNKS or more
    both CLIs at their defaults, below it both CLIs must refuse and the
    modes' functions run on the chunks there are. Then bm25_custom's IR
    metrics (and the sweep's sparse_only row) must equal a run whose head
    step is the plain version. Returns the chunks, quality-at-scale's
    object and the dataset of that plain run (pipeline-87k's, rebuilt)."""
    import contextlib

    from osr_tpu_torch.bench import fusion_sweep
    from osr_tpu_torch.bench import quality_at_scale as qas
    from osr_tpu_torch.testing import build_dataset, harvest_chunks

    t0 = time.perf_counter()
    roots = prose_roots()
    chunks = harvest_chunks(roots, 100_000)
    log(f"phase 13 prose harvest: {len(chunks)} chunks in all (floor "
        f"{qas.MIN_CHUNKS}), {time.perf_counter() - t0:.1f} s")
    if len(chunks) >= qas.MIN_CHUNKS:
        at_scale = bench_mode(QAS_ARGS)[-1]
        sweep = bench_mode(("fusion-sweep",))[-1]
    else:
        bench_mode(QAS_ARGS, refused=True)
        bench_mode(("fusion-sweep",), refused=True)
        log(f"below the at-scale floor: {len(chunks)} chunks")
        with contextlib.redirect_stdout(sys.stderr):
            at_scale = qas.run(
                chunks, num_queries=512, query_mode="noisy",
                dense_hashing=True, f32_control=True, roots=roots,
                device="cuda",
            )
            sweep = fusion_sweep.run(chunks, device="cuda")
    for label, out in (("quality-at-scale", at_scale),
                       ("fusion-sweep", sweep)):
        if out["num_docs"] != len(chunks) or out["device"] != card:
            fail(f"phase 13 {label}: {out['num_docs']} docs on "
                 f"{out['device']}")
        check_launched(label, out["kernel_launches"],
                       BENCH_DENSE_KERNELS["symmetric"], total)
        if not any(out["kernel_launches"].get(k) for k in INT8_HEAD_KERNELS):
            fail(f"phase 13 {label}: launched no head kernel")
    configs = [(r["config"], r.get("sparse_weight"), r.get("rrf_k"))
               for r in sweep["sweep"]]
    want = ([("sparse_only", None, None), ("dense_only", None, None)]
            + [("weighted", w, None) for w in fusion_sweep.WEIGHTED]
            + [("rrf", w, k) for w, _, k in fusion_sweep.RRF_POINTS])
    if configs != want:
        fail(f"phase 13 fusion-sweep: configs {configs}")

    ds = scratch / "prose_plain"
    build_dataset(ds, chunks, 512, mode="noisy")
    plain, plain_counts = quality_run(ds, ("bm25_custom",), scratch /
                                      "prose_plain_reports",
                                      head_backend="torch")
    if any(v for k, v in plain_counts.items() if k not in SELECT_KERNELS):
        fail(f"phase 13 plain-head quality run launched {plain_counts}")
    want = plain["bm25_custom"]
    got = at_scale["osr_tpu"]["bm25_custom"]
    sparse_only = sweep["sweep"][0]
    ir = sorted(k for k in want if "@" in k)
    diff = {k: (got[k], sparse_only[k], want[k]) for k in ir
            if got[k] != want[k] or sparse_only[k] != round(want[k], 4)}
    if not ir or diff:
        fail(f"phase 13 prose: the kernel head's bm25 IR metrics differ "
             f"from the plain head's: {diff}")
    bm = {k: round(v, 4) for k, v in got.items() if "@" in k}
    log(f"phase 13 quality-at-scale bm25_custom (noisy, "
        f"{at_scale['num_docs']} docs, {at_scale['num_queries']} queries): "
        f"{json.dumps(bm)}, equal "
        "to the plain head's; f32 head nDCG@10 "
        f"{at_scale['osr_tpu_f32head']['bm25_custom']['ndcg@10']:.4f}; "
        + ", ".join(f"{m} {s['ndcg@10']:.4f}" for m, s in
                    at_scale["osr_tpu_dense_hashing"].items()))
    log(f"phase 13 prose modes took {time.perf_counter() - t0:.1f} s")
    return chunks, at_scale, ds


def storage_mode(card):
    """storage at its defaults (host work only): every synthetic row
    passed, the unique-text rows measured or named in ``dropped``, the
    anchor's store rates positive and its reference half null, no kernel,
    this card's line."""
    from osr_tpu_torch.bench import storage

    row = bench_mode(("storage",))[-1]
    keys_and_card("storage", row, storage.KEYS, card)
    synthetic = row["synthetic"]
    if (list(synthetic) != list(storage.SUITE_ROWS)
            or not all(r["passed"] for r in synthetic.values())
            or row["kernel_launches"]):
        fail(f"phase 13 storage: {row}")
    codecs = row["codec_comparison"]
    for name in storage.UNIQUE_ROWS:
        named = f"codec_comparison.{name}" in row["dropped"]
        if (codecs[name] is None) != named or (
                codecs[name] and not codecs[name]["compression_ratio"] > 0):
            fail(f"phase 13 storage {name}: {codecs[name]}, dropped {named}")
    anchor = row["same_host_anchor"]
    if not all(anchor[k] > 0 for k in storage.OSR_KEYS) or any(
            anchor[k] is not None for k in storage.REF_KEYS):
        fail(f"phase 13 storage anchor: {anchor}")
    log("phase 13 storage: synthetic build "
        f"{synthetic['build']['docs_per_s']} docs/s (compression "
        f"{synthetic['build']['compression_ratio']}), scan "
        f"{synthetic['sequential_scan']['docs_per_s']} docs/s; unique text "
        + ", ".join(f"{n} {codecs[n]}" for n in storage.UNIQUE_ROWS)
        + f"; anchor ({anchor['num_docs']} docs) "
        + ", ".join(f"{k} {anchor[k]}" for k in storage.OSR_KEYS)
        + f"; dropped {sorted(row['dropped'])}")


EVIDENCE_STEPS = ("probe", "encoder")


def evidence_steps(card, total, scratch):
    """evidence --only probe,encoder --out DIR: both steps rc 0 with their
    logs under DIR, the probe's row this card, and the encoder's last row
    (the dense-encoder mode at its defaults, run only here) held by
    check_dense_encoder."""
    from osr_tpu_torch.bench import evidence

    out = scratch / "evidence"
    row = bench_mode(("evidence", "--only", ",".join(EVIDENCE_STEPS),
                      "--out", str(out)))[-1]
    keys_and_card("evidence", row, evidence.KEYS, card)
    steps = row["steps"]
    if (list(steps) != list(EVIDENCE_STEPS) or row["aborted"]
            or row["failed"] or any(
                st["rc"] != 0 or st["log"] != str(out / f"evidence_{n}.log")
                or not Path(st["log"]).is_file() for n, st in steps.items())):
        fail(f"phase 13 evidence: {row}")
    if (steps["probe"]["last_row"] or {}).get("device") != card:
        fail(f"phase 13 evidence probe: {steps['probe']}")
    check_dense_encoder([steps["encoder"]["last_row"]], card, total)
    log("phase 13 evidence: " + ", ".join(
        f"{n} rc {st['rc']} in {st['s']} s" for n, st in steps.items()))


def pipeline_mode(card, total, scratch, chunks, at_scale, ds):
    """pipeline-87k at its defaults over the same harvest, its summaries
    and preds under the phase's scratch directory (below MIN_CHUNKS the CLI
    must refuse and its function runs on the chunks there are): every
    experiment ok, a head kernel in each and K7 + K5 in the hybrid; each
    experiment's preds and quality equal a direct search of its block over
    ``ds``, the same dataset rebuilt by prose_modes; nDCG@10 printed beside
    quality-at-scale's."""
    import contextlib

    from osr_tpu_torch.bench import pipeline_87k
    from osr_tpu_torch.bench import quality_at_scale as qas
    from osr_tpu_torch.pipeline.config import load_config
    from osr_tpu_torch.storage.loaders import (
        load_corpus,
        load_qrels,
        load_queries,
    )

    out = scratch / "pipeline_87k"
    if len(chunks) >= qas.MIN_CHUNKS:
        row = bench_mode(("pipeline-87k", "--out", str(out)))[-1]
    else:
        bench_mode(("pipeline-87k",), refused=True)
        with contextlib.redirect_stdout(sys.stderr):
            row = pipeline_87k.run(chunks, out=str(out), device="cuda")
    keys_and_card("pipeline-87k", row, pipeline_87k.KEYS, card)
    blocks = {e["name"]: e["retriever"]
              for e in load_config(pipeline_87k.CONFIG)["experiments"]}
    if (row["num_docs"] != len(chunks)
            or list(row["experiments"]) != list(blocks)
            or row["num_queries"] != at_scale["num_queries"]):
        fail(f"phase 13 pipeline-87k: {row}")
    overall = json.loads((out / "overall_results.json").read_text())
    docs, queries, qrels = load_corpus(ds), load_queries(ds), load_qrels(ds)
    for name, e in row["experiments"].items():
        counts = e["kernel_launches"]
        if e["status"] != "ok" or not any(counts.get(k)
                                          for k in INT8_HEAD_KERNELS):
            fail(f"phase 13 pipeline-87k {name}: {e}")
        dense = blocks[name]["type"] == "hybrid"
        check_launched(f"pipeline-87k {name}", counts,
                       BENCH_DENSE_KERNELS["symmetric"] if dense else (),
                       total)
        check_against_direct(name, blocks[name], overall[name], docs,
                             queries, qrels, out, row["num_queries"])
        section, method = (("osr_tpu_dense_hashing", "hybrid_rrf_idf")
                           if dense else ("osr_tpu", "bm25_custom"))
        stages = {k: round(v, 3) for k, v in e["stage_times_s"].items()}
        log(f"phase 13 pipeline-87k {name}: nDCG@10 "
            f"{e['quality']['ndcg@10']:.4f} (quality-at-scale {method} "
            f"{at_scale[section][method]['ndcg@10']:.4f}); retrieval QPS "
            f"{e['retrieval_qps']:.1f}, pipeline QPS "
            f"{e['queries_per_second']:.1f}; stages (s) {json.dumps(stages)}; "
            f"launches {counts}; preds and quality equal a direct search of "
            "the same block")


# sharded-scale runs at 25,000 docs, cut from its 200,000 default for the
# same limit (the default took 55.1-59.0 s on an H100, 50,000 docs 26.0-33.3
# s before phase 13 grew by nine modes); every other option is the
# default: 8 ranks, mesh (2, 4), and each rank's step still takes K2 (the
# block-pruned selection follows the whole index's 196 blocks, more than
# 2 x top_k 50).
BENCH_SHARDED_DOCS = 25_000


def sharded_modes(card, total, world1):
    """sharded-scale at BENCH_SHARDED_DOCS (8 gloo ranks on this card, mesh
    (2, 4)) and sharded-overhead (a world of one under NCCL), standard and
    extraction: 0 mismatches and 0 differing dicts each, the head kernel
    on every rank and in both engines."""
    row = bench_mode(("sharded-scale", "--docs", str(BENCH_SHARDED_DOCS)))[-1]
    if (row["mismatched_queries_vs_single_device"]
            or row["differing_dicts_vs_flat"] or row["devices"] != 8
            or row["num_docs"] != BENCH_SHARDED_DOCS
            or row["mesh"] != {"q": 2, "d": 4} or row["device"] != card
            or row["platform"] != "cuda-gloo-shared"):
        fail(f"phase 13 sharded-scale: {row}")
    for rank, counts in enumerate(row["kernel_launches_by_rank"]):
        check_launched(f"sharded-scale rank {rank}", counts,
                       ("head_blockmax_i8",), {})
    add_counts(total, row["kernel_launches"])
    log(f"phase 13 sharded-scale ({row['num_docs']} docs, "
        f"{row['rows_per_shard']} rows a shard, 8 ranks): build "
        f"{row['build_s']} s, shard upload {row['shard_upload_s']} s, "
        f"search {row['sharded_search_s']} s; peak RSS a rank (MiB) "
        f"{row['rank_peak_rss_mb']}, device peak a rank (MiB) "
        f"{row['rank_device_peak_mb']}")
    for args, kernel in ((("sharded-overhead",), "head_blockmax_i8"),
                         (("sharded-overhead", "--narrow-m", str(NARROW_M),
                           "--narrow-backend", "extract"),
                          "head_blocktopm_i8")):
        label = " ".join(args)
        row = bench_mode(args)[-1]
        if (row["mismatched_queries_vs_flat"] or row["differing_dicts_vs_flat"]
                or row["head_backend"] != "cuda" or row["device"] != card):
            fail(f"phase 13 {label}: {row}")
        for engine, counts in row["kernel_launches_by_engine"].items():
            check_launched(f"{label} {engine}", counts, (kernel,), {})
        add_counts(total, row["kernel_launches"])
        log(f"phase 13 {label}: shard_map_overhead_pct "
            f"{row['shard_map_overhead_pct']} (QPS median of 5: sharded "
            f"{row['qps_sharded']}, flat {row['qps_flat']}); phase 12 (a): "
            f"step sharded / flat {world1['step_ms']:.4f} / "
            f"{world1['flat_step_ms']:.4f} ms (ratio "
            f"{world1['step_ms'] / world1['flat_step_ms']:.4f}), QPS median "
            f"of 3 {world1['qps']:.1f} / {world1['flat_qps']:.1f}")


def profiler_modes(card, total):
    """profile-trace (the trace's K2 events as many as the launches),
    profile-latency (K2 on every iteration) and profile-search (K2), at
    their defaults."""
    from osr_tpu_torch.bench import profile_latency, profile_search

    row = bench_mode(("profile-trace",))[-1]
    k2 = row["kernel_launches"].get("head_blockmax_i8", 0)
    if (row["kernel_trace_events"].get("head_blockmax_i8") != k2 or not k2
            or row["trace_files"]
            or not row["device_busy_share"] > 0 or row["device"] != card):
        fail(f"phase 13 profile-trace: {row}")
    add_counts(total, row["kernel_launches"])
    log(f"phase 13 profile-trace: {k2} K2 launches, as many K2 events in "
        f"the trace; device busy share {row['device_busy_share']}; QPS "
        f"{row['passes_qps']}; top device operations (count, ms a pass): "
        + "; ".join(f"{op['name'][:60]} ({op['count']}, "
                    f"{op['ms_per_pass']})" for op in row["top_device_ops"]))

    row = bench_mode(("profile-latency",))[-1]
    if (row["kernel_launches"].get("head_blockmax_i8") != 2 * row["iters"]
            or list(row["stages"]) != list(profile_latency.STAGES)
            or row["device"] != card):
        fail(f"phase 13 profile-latency: {row}")
    add_counts(total, row["kernel_launches"])
    log(f"phase 13 profile-latency B={row['batch']} p50 / p95 ms: "
        + ", ".join(f"{k} {v['p50']} / {v['p95']}"
                    for k, v in row["stages"].items())
        + f"; engine search() e2e {row['engine_search_e2e_ms']['p50']} / "
        f"{row['engine_search_e2e_ms']['p95']}")

    row = bench_mode(("profile-search",))[-1]
    b = row["batch"]
    if (row["device"] != card
            or profile_search.DEVICE_STAGE not in row["stages_ms"]
            or not row["device_step_event_ms"] > 0):
        fail(f"phase 13 profile-search B={b}: {row}")
    check_launched(f"profile-search B={b}", row["kernel_launches"],
                   ("head_blockmax_i8",), total)
    log(f"phase 13 profile-search B={b} ms a batch: "
        + ", ".join(f"{k} {v}" for k, v in row["stages_ms"].items())
        + f"; device step (CUDA events) {row['device_step_event_ms']}; "
        "batch_stages "
        + ", ".join(f"{k} {v}" for k, v in row["batch_stages_ms"].items()))


def keys_and_card(label, row, keys, card):
    """A mode's row holds every key of its module's KEYS and this card."""
    missing = set(keys) - set(row)
    if missing or row["device"] != card:
        fail(f"phase 13 {label}: keys missing {sorted(missing)}, device "
             f"{row['device']!r}")


def stage_modes(card, total, dump):
    """profile-stages-1m and profile-host-scale over the saved 200,000-doc
    int4 index, then profile-hybrid at its defaults and the device-stage
    modes at STAGE_BATCH, each row checked and its launches counted."""
    from osr_tpu_torch.bench import (
        profile_blocksel,
        profile_device,
        profile_fused,
        profile_host_scale,
        profile_hybrid,
        profile_narrow,
        profile_stages_1m,
        profile_topk2,
        profile_topk_fix,
    )

    row = bench_mode(("profile-stages-1m", "--load-index", str(dump)))[-1]
    keys_and_card("profile-stages-1m", row, profile_stages_1m.KEYS, card)
    if (not row["cand_total"] > 0 or row["num_docs"] != BENCH_SCALE_DOCS
            or row["head_dtype"] != "int4" or not row["qps"] > 0):
        fail(f"phase 13 profile-stages-1m: {row}")
    check_launched("profile-stages-1m", row["kernel_launches"],
                   ("head_blockmax_i4",), total)
    log(f"phase 13 profile-stages-1m ({row['num_docs']} docs, int4, "
        f"B={row['batch']}) ms: " + ", ".join(
            f"{k} {row[k]}" for k in profile_stages_1m.KEYS[6:16]))

    row = bench_mode(("profile-host-scale", "--load-index", str(dump)))[-1]
    keys_and_card("profile-host-scale", row, profile_host_scale.KEYS, card)
    if (row["host_runtime"] != "native" or row["kernel_launches"]
            or row["num_docs"] != BENCH_SCALE_DOCS
            or not row["candidates_per_q_mean"] > 0):
        fail(f"phase 13 profile-host-scale: {row}")
    log("phase 13 profile-host-scale: " + ", ".join(
        f"{k} {row[k]}" for k in profile_host_scale.KEYS[4:22]))

    row = bench_mode(("profile-hybrid",))[-1]
    keys_and_card("profile-hybrid", row, profile_hybrid.KEYS, card)
    stages = row["ms_per_batch"]
    events = row["device_step_event_ms"]
    if (list(stages) != list(profile_hybrid.HOST_STAGES
                             + profile_hybrid.DEVICE_WALLS)
            or sum(stages[k] for k in profile_hybrid.HOST_STAGES)
            > row["serial_wall_ms"] + 1e-3
            or not (events["sparse_dev"] > 0 and events["dense_dev"] > 0)):
        fail(f"phase 13 profile-hybrid: {row}")
    check_launched("profile-hybrid", row["kernel_launches"],
                   ("head_blockmax_i8",) + BENCH_DENSE_KERNELS["symmetric"],
                   total)
    log(f"phase 13 profile-hybrid ms a batch: {json.dumps(stages)}; wall "
        f"{row['serial_wall_ms']}; device steps (CUDA events) {events}")

    modules = {"profile-device": profile_device,
               "profile-fused": profile_fused,
               "profile-narrow": profile_narrow,
               "profile-blocksel": profile_blocksel,
               "profile-topk2": profile_topk2,
               "profile-topk-fix": profile_topk_fix}
    for mode, kernels, checks in DEVICE_STAGE_MODES:
        module = modules[mode]
        row = bench_mode((mode, "--batch", str(STAGE_BATCH)))[-1]
        keys_and_card(mode, row, module.KEYS, card)
        if row["batch"] != STAGE_BATCH or not all(row[c] is True
                                                  for c in checks):
            fail(f"phase 13 {mode}: {row}")
        for key in getattr(module, "DROPPED", {}):
            if row[key] is not None or key not in row["dropped"]:
                fail(f"phase 13 {mode}: dropped row {key} is {row[key]}")
        check_launched(mode, row["kernel_launches"], kernels, total)
        log(f"phase 13 {mode} B={STAGE_BATCH} ms: " + ", ".join(
            f"{k} {v}" for k, v in row.items()
            if k.endswith("_ms") and v is not None))


def bench_phase(card, scratch, world1):
    """Phase 13: each mode of ``python -m osr_tpu_torch.bench`` on the card;
    returns each kernel's launches, summed over the modes' measured
    passes (and over sharded-scale's ranks)."""
    t0 = time.perf_counter()
    total = {}
    dump = scratch / "scaling_int4"
    bench_mode(("scaling", "--docs", str(BENCH_SCALE_DOCS), "--head-dtype",
                "int4", "--save-index", str(dump)), rows_expected=False)
    for args, kernels in BENCH_MODES:
        if args and args[0] == "scaling":
            args = (*args, "--load-index", str(dump))
        rows = bench_mode(args)
        if not args:
            check_headline(rows[-1], card, total)
            continue
        mode = args[0]
        if mode == "batch-curve":
            check_batch_curve(rows, card, total)
            continue
        if mode == "int4-quality":
            check_int4_quality(rows, card, total)
            continue
        if mode == "dense-scale":
            if [r["quantization"] for r in rows] != ["symmetric", "int4"]:
                fail(f"phase 13 dense-scale: rows {rows}")
            for r in rows:
                if not r["qps"] > 0:
                    fail(f"phase 13 dense-scale {r['quantization']}: no QPS")
                check_launched(f"dense-scale {r['quantization']}",
                               r["kernel_launches"],
                               BENCH_DENSE_KERNELS[r["quantization"]], total)
            continue
        row = rows[-1]
        qps = row["qps"] if mode == "hybrid" else row["qps_exact"]
        queries = row["num_queries"]
        done = row["nonempty_results" if mode == "hybrid" else "nonempty"]
        if not qps > 0 or done < 0.9 * queries:
            fail(f"phase 13 {mode}: QPS {qps}, {done}/{queries} non-empty")
        check_launched(mode, row["kernel_launches"], kernels, total)
    storage_mode(card)
    evidence_steps(card, total, scratch)
    chunks, at_scale, ds = prose_modes(card, total, scratch)
    pipeline_mode(card, total, scratch, chunks, at_scale, ds)
    sharded_modes(card, total, world1)
    profiler_modes(card, total)
    stage_modes(card, total, dump)
    log(f"phase 13 (measurement entry points) took "
        f"{time.perf_counter() - t0:.1f} s; launches {total}")
    return total


def host_stages():
    """``--host-stages``: only the host stages of the sparse path, for
    comparing the runtimes of two checkouts in one call (``--tree``
    imports the port from another checkout). One FiQA-scale batch stage
    by stage on an engine whose head step is the plain version (no kernel
    to build; the host stages are the same), the tail walk of that batch
    six times, then the 1M index's tail walk, first batch and later
    ones."""
    import osr_tpu_torch
    from osr_tpu_torch import native
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine
    from osr_tpu_torch.testing import SyntheticDataGenerator

    lib = native.library()
    log(f"port {Path(osr_tpu_torch.__file__).parent}; host runtime "
        f"{getattr(lib, 'path', None) or lib._name}; {host_line(native)}")
    corpus, queries = make_corpus(), make_queries()
    index = SparseIndexBuilder(head_dtype="int8").build(corpus)
    del corpus
    texts = list(queries.values())[:BATCH]
    log(walk_line(f"FiQA, B={BATCH}, first of the process,",
                  tail_walk_ms(index, texts)))
    eng = SparseSearchEngine(
        index, device="cuda", batch_sizes=(BATCH,), cache_queries=False,
        head_backend="torch",
    )
    eng.search(queries, top_k=TOP_K)
    stages = median_stages(eng, texts, TOP_K)
    log(f"FiQA one batch stage by stage (int8, top_k={TOP_K}, B={BATCH}, "
        f"plain head step, ms, median of 3): "
        f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    del eng, index
    torch.cuda.empty_cache()
    gen = SyntheticDataGenerator(seed=42)
    m1_queries = gen.queries(
        M1_QUERIES, M1_VOCAB, avg_terms=11, word_prefix="t", min_terms=2
    )
    corpus = gen.zipf_corpus(
        M1_DOCS, M1_VOCAB, avg_len=130, word_prefix="t", min_len=5
    )
    index = SparseIndexBuilder(head_dtype="int8").build(corpus)
    del corpus
    log(walk_line(f"1M, B={M1_QUERIES},",
                  tail_walk_ms(index, list(m1_queries.values()))))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--host-stages", action="store_true",
        help="time only the sparse path's host stages (see host_stages)",
    )
    parser.add_argument(
        "--tree", type=Path,
        help="with --host-stages: the checkout whose port to import",
    )
    parser.add_argument(
        "--select", action="store_true",
        help="build, print the kernels' resources and run only the select "
             "kernel's checks and times (select_phase)",
    )
    args = parser.parse_args()
    if args.host_stages:
        if args.tree is not None:
            # Forget this checkout's port (its shared definitions are
            # bound above), so the stages import the other checkout's.
            sys.path.insert(0, str(args.tree.resolve()))
            for name in [m for m in sys.modules
                         if m.split(".")[0] == "osr_tpu_torch"]:
                del sys.modules[name]
        log(f"card: {card_line()}")
        host_stages()
        return 0
    if args.tree is not None:
        parser.error("--tree goes with --host-stages")
    if args.select:
        from osr_tpu_torch.ops import _build

        log(f"card: {card_line()}")
        _build.build_all()
        regs, smem = kernel_resources()
        log(f"registers per thread (ptxas): {regs}")
        log(f"shared memory per block, bytes: {smem}")
        log(json.dumps(select_phase(torch.device("cuda"))))
        return 0
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.ops import _build
    from osr_tpu_torch.ops.bm25 import fused_search, fused_search_extract
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel and host runtime build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc for sm_90a and {_build._cxx()}, in parallel)")
    load_host_runtime()
    walker_past_2_pow_24()
    regs, smem = kernel_resources()
    log(f"registers per thread (ptxas): {regs}")
    log(f"shared memory per block, bytes (ptxas static + dynamic): {smem}")
    log(f"TMA + wgmma kernels' SASS instruction counts: {check_sass()}")

    for name in HEAD_KERNELS:
        err = check_kernel(name, *small_case(name, dev))
        log(f"small ragged check {name}: max_abs_err={err:.3e}")
    for dtype in ("int8", "int4"):
        ring_checks(dtype, dev)
    blocktopm_small_checks(dev)
    dense_small_checks(dev)

    t0 = time.perf_counter()
    corpus, queries = make_corpus(), make_queries()
    index8 = SparseIndexBuilder(head_dtype="int8").build(corpus)
    index4 = SparseIndexBuilder(head_dtype="int4").build(corpus)
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
    k1_is_k2_scores(*bench_case(eng8, texts))
    log("FiQA shape int8: K1's scores equal K2's bit for bit")
    for dtype, eng in (("int8", eng8), ("int4", eng4)):
        blocktopm_is_topm_of_blockmax(*bench_case(eng, texts))
        log(f"FiQA shape {dtype}: K4 equals the per-block top-{NARROW_M} "
            "of K2/K3's scores bit for bit")
    scores, _ = kernel_call("head_scores_i8", *bench_case(eng8, texts))
    select_row = select_phase(dev, own=[(
        "fiqa-bm25.top1000 full row, K1's own scores", scores, DEEP_K)])
    rows.append(select_row)
    del scores
    torch.cuda.empty_cache()
    # K4-i8 here for comparison with K2 at one shape; its row comes from
    # the 1M path.
    blocktopm_numbers("head_blocktopm_i8", *bench_case(eng8, texts))
    rows.append(
        blocktopm_numbers("head_blocktopm_i4", *bench_case(eng4, texts))
    )
    torch.cuda.empty_cache()
    by_name = {r["name"]: r for r in rows}

    # The main path, and the two paths that reach K1 and K3.
    base = {}
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
        if counts["topk_select"] == 0 or counts["topk_sort_route"]:
            fail(f"{label}: a selection took the sort ({counts})")
        by_name[kernel]["launches"] = counts[kernel]
        select_row["launches"] += counts["topk_select"]
        base[label] = results
    fiqa_plans(index8, base["main path int8 top_k=50"], queries, "int8")
    by_name["head_blocktopm_i4"]["launches"] = fiqa_plans(
        index4, base["int4 top_k=50"], queries, "int4"
    )
    del base

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
    extract_ms = median_ms(
        lambda: fused_search_extract(
            ids, w, d.head, d.head_scales, d.valid,
            head_terms=index8.layout.head_terms, k=TOP_K, narrow_m=NARROW_M,
            head_backend="cuda",
        ),
        reps=10,
    )
    log(f"device step int8 top_k={TOP_K}, B={BATCH}, extraction (K4): "
        f"{extract_ms:.4f} ms")

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
    stages = median_stages(eng8, texts, TOP_K)
    log(
        f"one batch stage by stage (int8, top_k={TOP_K}, B={BATCH}, ms, median "
        f"of 3): {json.dumps({k: round(v, 3) for k, v in stages.items()})}; "
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
    bench_docs = index8.num_docs
    del eng8, eng4, lat_engine, d, ids, w  # phase 12 reuses the indexes
    torch.cuda.empty_cache()
    log(f"sparse phases done at {time.perf_counter() - t_start:.1f} s")

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as scratch:
        surface = retrieval_surface(corpus, queries, Path(scratch))
        log(f"retrieval surface done at {time.perf_counter() - t_start:.1f} s")
        pipeline = experiment_pipeline(corpus, Path(scratch))
        log(f"experiment pipeline done at {time.perf_counter() - t_start:.1f} s")
        benchmarks = benchmark_suites(Path(scratch))
    del corpus
    torch.cuda.empty_cache()
    log(f"benchmark suites done at {time.perf_counter() - t_start:.1f} s")

    rows.append(million_path(dev))
    log(f"1M path done at {time.perf_counter() - t_start:.1f} s")

    rows += dense_phases(dev, bench_docs)
    log(f"dense phases done at {time.perf_counter() - t_start:.1f} s")

    from osr_tpu_torch.index.dense import synthetic_corpus_embeddings

    bemb = synthetic_corpus_embeddings(bench_docs, dim=DENSE_DIM, seed=3)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as scratch:
        sharded, world1 = sharded_phase(
            {"int8": index8, "int4": index4}, queries, bemb, Path(scratch)
        )
    del bemb, index8, index4
    torch.cuda.empty_cache()
    log(f"sharded engines done at {time.perf_counter() - t_start:.1f} s")

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as scratch:
        bench = bench_phase(card, Path(scratch), world1)
    for r in rows:
        if r["name"] in surface:
            r["surface_launches"] = surface[r["name"]]
            r["pipeline_launches"] = pipeline[r["name"]]
        r["benchmarks_launches"] = benchmarks[r["name"]]
        r["sharded_launches"] = sharded.get(r["name"], 0)
        r["bench_launches"] = bench.get(r["name"], 0)
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
