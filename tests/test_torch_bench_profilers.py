"""The sharded pair and the three search profilers ported as modes of
``python -m osr_tpu_torch.bench`` (sharded-scale, sharded-overhead,
profile-trace, profile-latency, profile-search) against the JAX scripts
they port and osr_tpu's engines, all on the CPU at small sizes from
seeds.

sharded-scale spawns a world of 4 gloo ranks, mesh (2, 2);
sharded-overhead runs its world of one gloo rank in the test's process.
Tolerance against osr_tpu's flat SparseSearchEngine on the same corpus
and queries: ``common.same_results`` (the rule of
tests/test_torch_bench.py: the same doc ids in the same order but at
near-ties, scores within rtol 1e-5; the two head steps differ in f32
summation order, the host merge is shared). Against the port's own
engines: equal dict for dict. The scripts' stage names are read from
their source with ``ast``.
"""

import ast
import json
from pathlib import Path

import pytest
import torch.distributed as dist

from osr_tpu_torch.bench import (
    common,
    profile_latency,
    profile_search,
    profile_trace,
    sharded_overhead,
    sharded_scale,
)

REPO = Path(__file__).resolve().parents[1]
DOCS = 3_000
VOCAB = 12_000
# At 3,000 docs the head has 24 blocks of 128 rows: top_k 10 keeps the
# block-pruned selection (24 > 2 x 10), which K2 serves on the card.
TOP_K = 10


def _jax_results(corpus, queries, batch, top_k):
    """osr_tpu's flat engine over the same corpus and queries."""
    from osr_tpu.index.builder import SparseIndexBuilder
    from osr_tpu.retrieval.engine import SparseSearchEngine

    index = SparseIndexBuilder(method="bm25").build(corpus)
    return SparseSearchEngine(
        index, batch_sizes=(batch,), cache_queries=False, topk_mode="exact"
    ).search(queries, top_k=top_k)


def _port_results(corpus, queries, batch, top_k):
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    index = SparseIndexBuilder(method="bm25").build(corpus)
    return SparseSearchEngine(
        index, device="cpu", batch_sizes=(batch,), cache_queries=False,
        topk_mode="exact",
    ).search(queries, top_k=top_k)


# ----------------------------------------------------------------------
# common: the scripts' mismatch rule, one definition of the stages
# ----------------------------------------------------------------------


def _scripts_rule(res_a, res_b, queries, tol=1e-4):
    """tools/bench_sharded_cpu.py:128-143, as written there."""
    mismatches = 0
    for qid in queries:
        a, b = res_a[qid], res_b[qid]
        amin = min(a.values(), default=0.0)
        bmin = min(b.values(), default=0.0)
        bad = any(
            a[d] > bmin + tol * max(1.0, abs(bmin))
            for d in set(a) - set(b)
        ) or any(
            b[d] > amin + tol * max(1.0, abs(amin))
            for d in set(b) - set(a)
        ) or any(
            abs(a[d] - b[d]) > tol * max(1.0, abs(b[d]))
            for d in set(a) & set(b)
        )
        mismatches += bool(bad)
    return mismatches


BASE = {"d1": 5.0, "d2": 4.0, "d3": 3.0}
MISMATCH_CASES = {
    # case: (the other side's results, substantive)
    "equal": (dict(BASE), False),
    "tie swap at the k-th place": ({"d1": 5.0, "d2": 4.0, "d9": 3.0}, False),
    "tie within tol": ({"d1": 5.0, "d2": 4.0, "d9": 3.0002}, False),
    "unique doc above the k-th score": (
        {"d1": 5.0, "d2": 4.0, "d9": 3.5}, True),
    "shared doc off by more than tol": (
        {"d1": 5.0, "d2": 4.01, "d3": 3.0}, True),
    "shared doc off by less than tol": (
        {"d1": 5.0, "d2": 4.0003, "d3": 3.0}, False),
    "empty against results": ({}, True),
    "negative scores": ({"d1": -1.0}, True),
}


@pytest.mark.parametrize("case", sorted(MISMATCH_CASES))
def test_substantive_mismatches_is_the_scripts_rule(case):
    """Both ways round, the shared rule counts what the script's inline
    loop counts, and that is the case's verdict."""
    other, substantive = MISMATCH_CASES[case]
    for a, b in ((BASE, other), (other, BASE)):
        res_a, res_b = {"q": a, "r": dict(BASE)}, {"q": b, "r": dict(BASE)}
        want = _scripts_rule(res_a, res_b, res_b)
        assert want == int(substantive)
        assert common.substantive_mismatches(res_a, res_b) == want


def test_differing_dicts_counts_any_difference():
    a = {"q": dict(BASE), "r": {"d1": 1.0}}
    assert common.differing_dicts(a, {"q": dict(BASE), "r": {"d1": 1.0}}) == 0
    swapped = {"q": {"d2": 4.0, "d1": 5.0, "d3": 3.0}, "r": {"d1": 1.5}}
    assert common.differing_dicts(a, swapped) == 1
    with pytest.raises(RuntimeError):
        common.differing_dicts(a, {"q": dict(BASE)})


def test_chip_smoke_keeps_no_copy_of_the_shared_definitions():
    """chip_smoke.py defines none of batch_stages, median_stages,
    median_ms and index_state: it imports those it calls from
    bench/common.py."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    defined = {n.name for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef)}
    shared = {"batch_stages", "median_stages", "median_ms", "index_state"}
    assert not shared & defined
    imported = {a.name for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)
                and n.module == "osr_tpu_torch.bench.common"
                for a in n.names}
    assert shared - {"batch_stages"} <= imported


def test_foreign_modules_sees_jax():
    """The ranks' import check finds JAX where it is loaded (this test
    process loads it through tests/conftest.py)."""
    import jax  # noqa: F401

    assert "jax" in common.foreign_modules()


# ----------------------------------------------------------------------
# sharded-scale: 4 gloo ranks, mesh (2, 2)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def scale_run():
    row, res = sharded_scale.run(docs=DOCS, num_queries=64, topk=TOP_K,
                                 devices=4, device="cpu")
    return row, res


def test_sharded_scale_counts_and_mesh(scale_run):
    row, res = scale_run
    assert row["mismatched_queries_vs_single_device"] == 0
    assert row["differing_dicts_vs_flat"] == 0
    assert row["mesh"] == {"q": 2, "d": 2} and row["devices"] == 4
    assert row["rows_per_shard"] % 128 == 0
    assert row["rows_per_shard"] * 2 >= DOCS
    assert row["vocab_size"] <= min(4 * DOCS, 400_000)
    assert row["platform"] == "cpu-gloo" and row["device"] == "cpu"
    assert len(row["rank_peak_rss_mb"]) == 4
    assert row["rank_device_peak_mb"] == [None] * 4
    assert row["kernel_launches_by_rank"] == [{}] * 4
    assert len(res) == 64


def test_sharded_scale_equals_osr_tpu(scale_run):
    """Rank 0's results against osr_tpu's flat engine on the script's
    corpus and queries (vocabulary min(4 x docs, 400,000), 11-term
    queries, at least 2 terms)."""
    from osr_tpu.testing import SyntheticDataGenerator as JaxGen

    _, got = scale_run
    gen = JaxGen(seed=42)
    vocab = min(4 * DOCS, 400_000)
    corpus = gen.zipf_corpus(DOCS, vocab, avg_len=130, word_prefix="t",
                             min_len=5)
    queries = gen.queries(64, vocab, avg_terms=11, word_prefix="t",
                          min_terms=2)
    assert got.keys() == queries.keys()
    assert common.same_results(got, _jax_results(corpus, queries, 64, TOP_K))


# ----------------------------------------------------------------------
# sharded-overhead: a world of one gloo rank in this process
# ----------------------------------------------------------------------

OVERHEAD_PLANS = {
    "standard": {},
    "extraction": dict(narrow_m=8, narrow_backend="extract"),
}


@pytest.mark.parametrize("plan", sorted(OVERHEAD_PLANS))
def test_sharded_overhead_equals_flat_and_osr_tpu(plan):
    row, got = sharded_overhead.run(
        docs=DOCS, vocab=VOCAB, num_queries=128, topk=TOP_K, passes=2,
        device="cpu", **OVERHEAD_PLANS[plan],
    )
    assert not dist.is_initialized()  # destroyed on the way out
    assert row["mismatched_queries_vs_flat"] == 0
    assert row["differing_dicts_vs_flat"] == 0
    assert row["mesh"] == {"q": 1, "d": 1} and row["devices"] == 1
    assert row["head_backend"] == "torch"
    assert len(row["qps_sharded_passes"]) == 2 == len(row["qps_flat_passes"])
    assert row["qps_sharded"] == sorted(row["qps_sharded_passes"])[1]
    assert row["shard_map_overhead_pct"] == round(
        100.0 * (1.0 - row["qps_sharded"] / row["qps_flat"]), 1)
    assert row["narrow_backend"] == OVERHEAD_PLANS[plan].get(
        "narrow_backend", "xla")
    assert row["kernel_launches_by_engine"] == {"sharded": {}, "flat": {}}
    corpus, queries = common.workload(DOCS, VOCAB, 128)
    assert common.same_results(got, _jax_results(corpus, queries, 128,
                                                 TOP_K))


def test_sharded_overhead_destroys_its_group_on_failure(monkeypatch):
    """A failure inside the world leaves no process group behind."""
    from osr_tpu_torch import parallel

    def broken(*args, **kwargs):
        raise RuntimeError("engine failed")

    monkeypatch.setattr(parallel, "ShardedSparseSearchEngine", broken)
    with pytest.raises(RuntimeError, match="engine failed"):
        sharded_overhead.run(docs=500, vocab=2_000, num_queries=8, passes=1,
                             device="cpu")
    assert not dist.is_initialized()


# ----------------------------------------------------------------------
# profile-trace
# ----------------------------------------------------------------------

TRACE = dict(docs=DOCS, vocab=VOCAB, batch=64, topk=TOP_K, passes=2,
             device="cpu")


def test_profile_trace_writes_nothing_without_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    summary = profile_trace.run(**TRACE)
    assert summary["trace_files"] == [] and not list(tmp_path.iterdir())
    assert len(summary["passes_qps"]) == 2
    assert summary["device_busy_share"] is None  # no device here
    assert summary["top_device_ops"] == [] and summary["kernel_launches"] == {}
    assert summary["kernel_trace_events"] == {}


def test_profile_trace_writes_one_chrome_trace(tmp_path):
    out = tmp_path / "trace"
    summary = profile_trace.run(out=str(out), **TRACE)
    assert summary["trace_files"] == [str(out / "trace.json")]
    assert [p.name for p in out.iterdir()] == ["trace.json"]
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"search_pass_0", "search_pass_1"} <= names
    assert "search_pass_2" not in names


K2_NAMES = (
    "void (anonymous namespace)::head_wgmma_kernel<true, 0>(CUtensorMap_st, "
    "CUtensorMap_st, unsigned char const*, float*, float*, int*, int, int, "
    "int, int, int)",
    "_ZN12_GLOBAL__N_117head_wgmma_kernelILb1ELi0EEEv14CUtensorMap_st",
)
OTHER_NAMES = (
    "void head_wgmma_kernel<true, 2>(CUtensorMap_st)",
    "void head_wgmma_kernel<false, 0>(CUtensorMap_st)",
    "_ZN12_GLOBAL__N_117head_wgmma_kernelILb1ELi1EEEv14CUtensorMap_st",
    "void at::native::radixSortKVInPlace<2, -1, 128, 32, float, long>",
)


@pytest.mark.parametrize("name", K2_NAMES + OTHER_NAMES)
def test_profile_trace_names_k2_alone(name):
    """K2 is head_wgmma_kernel<true, 0> (csrc/head_wgmma.cu: kInt8, and
    kEpiBlockMax = 0), demangled or mangled; K1, K3 and K4-i8 are not;
    each head kernel's pattern matches its own instantiation alone."""
    k2 = profile_trace.event_pattern("head_blockmax_i8")
    assert bool(k2.search(name)) == (name in K2_NAMES)
    matching = [k for k in profile_trace.HEAD_INSTANCES
                if profile_trace.event_pattern(k).search(name)]
    assert len(matching) <= 1


# ----------------------------------------------------------------------
# profile-latency and profile-search: the scripts' stages
# ----------------------------------------------------------------------


def _latency_stage_names():
    """The keys of the ``stages`` literal of tools/profile_latency.py."""
    tree = ast.parse((REPO / "tools/profile_latency.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "stages"
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no stages literal")


def _search_stage_names():
    """The ``t["..."]`` keys tools/profile_search.py sets, in the order
    of the source."""
    tree = ast.parse((REPO / "tools/profile_search.py").read_text())
    found = []
    for node in ast.walk(tree):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AugAssign)
                   else [])
        for t in targets:
            if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id == "t"
                    and isinstance(t.slice, ast.Constant)):
                found.append((t.lineno, t.slice.value))
    return list(dict.fromkeys(name for _, name in sorted(found)))


@pytest.fixture(scope="module")
def latency_run():
    return profile_latency.run(docs=DOCS, vocab=VOCAB, topk=TOP_K, iters=12,
                               device="cpu")


def test_profile_latency_stage_names_are_the_scripts(latency_run):
    summary, _ = latency_run
    want = _latency_stage_names()
    assert len(want) == 7
    got = list(summary["stages"])
    assert [n for n in got if n != "result_dicts_ms"] == want
    assert got == list(profile_latency.STAGES)
    for name in got:
        assert summary["stages"][name]["p50"] <= summary["stages"][name][
            "p95"]
    assert set(summary["engine_search_e2e_ms"]) == {"p50", "p95"}


def test_profile_latency_stages_compute_the_engines_results(latency_run):
    """The stage-by-stage path's results equal engine.search dict for
    dict and osr_tpu's engine within the merge rule."""
    _, got = latency_run
    corpus, pool = common.workload(DOCS, VOCAB, profile_latency.NUM_TEXTS)
    queries = {q: pool[q] for q in got}
    assert len(queries) == 12
    assert got == _port_results(corpus, queries, 1, TOP_K)
    assert common.same_results(got, _jax_results(corpus, queries, 1, TOP_K))


@pytest.fixture(scope="module")
def search_run():
    return profile_search.run(docs=DOCS, vocab=VOCAB, batch=64, topk=TOP_K,
                              device="cpu")


def test_profile_search_stage_names_are_the_scripts(search_run):
    row, _ = search_run
    want = _search_stage_names()
    assert len(want) == 5 and profile_search.DEVICE_STAGE in want
    assert list(row["stages_ms"]) == want
    assert row["device_step_event_ms"] is None  # no CUDA events here
    assert list(row["batch_stages_ms"])[:3] == [
        "osr.sparse.search", "osr.sparse.encode", "osr.sparse.dispatch"]
    assert row["batch"] == 64 and row["batches"] == profile_search.BATCHES


def test_profile_search_stages_compute_the_engines_results(search_run):
    _, got = search_run
    corpus = common.make_corpus(DOCS, VOCAB)
    pool = common.make_queries(6 * 64, VOCAB)
    queries = dict(list(pool.items())[: profile_search.BATCHES * 64])
    assert got.keys() == queries.keys()
    assert got == _port_results(corpus, queries, 64, TOP_K)
    assert common.same_results(got, _jax_results(corpus, queries, 64, TOP_K))
