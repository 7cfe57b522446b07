"""The port's benchmark suites (osr_tpu_torch/benchmarks/) and the
selection helpers and validators they use, mirrored from
tests/test_benchmarks.py with every suite on ``device="cpu"``, and held
against osr_tpu on the same seeded inputs:

- ``fast_topk``, ``merge_topk`` and ``approx_topk_threshold`` give
  osr_tpu's indices and values exactly, ties included (integer-valued
  scores; a merge whose parts tie across parts);
- ``spearman_correlation`` and ``CorrectnessValidator`` give equal values
  and dicts;
- each suite's correctness metrics (everything but its timings and the
  grades derived from them) equal osr_tpu's at the sizes of
  ``test_integration_runner_small``;
- ``run_quality_benchmark``'s bm25 and tfidf IR metrics equal osr_tpu's;
- ``BEIRCompatibleSearch`` gives osr_tpu's results dict for dict.

osr_tpu (and JAX) are imported inside the tests that need them: the test
marked ``cuda`` runs on the card's machine, which has neither, with
``python -m pytest --noconftest -m cuda tests/test_torch_benchmarks.py``.
"""

import json

import numpy as np
import pytest
import torch

from osr_tpu_torch.benchmarks.framework import (
    BenchmarkResult,
    format_results_table,
    generate_report,
    grade_performance,
    measure_size,
)
from osr_tpu_torch.benchmarks.integration import IntegrationRunner
from osr_tpu_torch.testing import (
    CorrectnessValidator,
    SyntheticDataGenerator,
    spearman_correlation,
)

SMALL_SUITES = {
    "bm25": {"num_docs": 120, "vocab_size": 400},
    "topk": {"n": 4000, "batch": 4, "k": 20},
    "quantization": {"num_docs": 300, "dim": 64},
    "storage": {"num_docs": 200},
}
# Metrics that time something, and so differ between runs and packages.
TIMINGS = {
    "engine_s", "csr_baseline_s", "speedup", "qps", "int8_s", "fp32_s",
    "docs_per_s", "reads_per_s", "open_plus_first_read_ms",
}


@pytest.fixture
def jax_ref():
    pytest.importorskip("jax")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    return torch.device("cuda")


# ----------------------------------------------------------------------
# The 13 tests of tests/test_benchmarks.py, on the port
# ----------------------------------------------------------------------


def test_grading():
    assert grade_performance(2.5, 1.0) == "A+"
    assert grade_performance(1.0, 1.0) == "C"
    assert grade_performance(0.6, 1.0) == "D"
    assert grade_performance(0.1, 1.0) == "F"
    assert grade_performance(5.0, 0.0) == "A+"


def test_measure_size():
    a = np.zeros((10, 10), np.float32)
    assert measure_size(a) == 400
    assert measure_size([a, a]) > 800
    assert measure_size({"x": a}) > 400


def test_report_generation(tmp_path):
    outputs = [
        {
            "suite": "demo",
            "duration_s": 0.1,
            "num_benchmarks": 1,
            "num_passed": 1,
            "all_passed": True,
            "error": None,
            "results": [
                BenchmarkResult(
                    "case", True, 0.1, {"metric": 1.0}, grade="A"
                ).to_dict()
            ],
        }
    ]
    report = generate_report(outputs, tmp_path / "r.md")
    assert "demo" in report and "PASS" in report and "grade A" in report
    assert (tmp_path / "r.md").exists()
    table = format_results_table([{"a": 1, "b": 0.5}], ["a", "b"])
    assert "| 1 | 0.5000 |" in table


def test_spearman():
    assert spearman_correlation([1, 2, 3], [10, 20, 30]) == pytest.approx(1.0)
    assert spearman_correlation([1, 2, 3], [30, 20, 10]) == pytest.approx(-1.0)
    assert spearman_correlation([1.0], [2.0]) == 1.0


def test_validators():
    v = CorrectnessValidator.validate_scores(
        np.array([1.0, 2.0]), np.array([1.0, 2.0005])
    )
    assert v["passed"]
    v = CorrectnessValidator.validate_scores(
        np.array([1.0, 5.0]), np.array([1.0, 2.0])
    )
    assert not v["passed"]
    r = CorrectnessValidator.validate_topk_ranking([1, 2, 3], [1, 2, 4])
    assert r["precision_at_k"] == pytest.approx(2 / 3)
    assert r["rank_spearman"] == pytest.approx(1.0)
    # reversed common ordering -> negative rank correlation
    r2 = CorrectnessValidator.validate_topk_ranking(
        [3, 2, 1], [1, 2, 3], min_overlap=0.5
    )
    assert r2["rank_spearman"] == pytest.approx(-1.0)


def test_synthetic_generator_deterministic():
    g1 = SyntheticDataGenerator(seed=42)
    g2 = SyntheticDataGenerator(seed=42)
    assert g1.zipf_corpus(5, 50) == g2.zipf_corpus(5, 50)
    assert g1.queries(3, 50) == g2.queries(3, 50)
    np.testing.assert_array_equal(g1.embeddings(4, 16), g2.embeddings(4, 16))


def test_integration_runner_small(tmp_path):
    runner = IntegrationRunner(
        out_dir=tmp_path,
        suites=["bm25", "topk", "quantization", "storage"],
        suite_kwargs=SMALL_SUITES,
        device="cpu",
    )
    overall = runner.run()
    assert overall["all_passed"], json.dumps(overall, default=str)[:2000]
    assert (tmp_path / "integration_report.md").exists()
    assert (tmp_path / "bm25_results.json").exists()
    # No card: no head_kernel_parity row (it needs the kernels).
    bm25 = next(s for s in overall["suites"] if s["suite"] == "bm25")
    assert "head_kernel_parity" not in {r["name"] for r in bm25["results"]}


def _quality_dataset(root):
    """tests/test_benchmarks.py's dataset: 60 Zipf docs, query qN made of
    three of docN's rarest terms, docN its one relevant doc."""
    gen = SyntheticDataGenerator()
    corpus = gen.zipf_corpus(60, 300, avg_len=30)
    ds = root / "ds"
    ds.mkdir()
    with open(ds / "corpus.jsonl", "w") as f:
        for d, rec in corpus.items():
            f.write(json.dumps({"_id": d, **rec}) + "\n")
    with open(ds / "queries.jsonl", "w") as f:
        for i in range(8):
            words = corpus[f"doc{i}"]["text"].split()
            rare = sorted(set(words), key=lambda w: -int(w[4:]))[:3]
            f.write(json.dumps({"_id": f"q{i}", "text": " ".join(rare)}) + "\n")
    (ds / "qrels").mkdir()
    with open(ds / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for i in range(8):
            f.write(f"q{i}\tdoc{i}\t1\n")
    return ds


def test_quality_benchmark(tmp_path):
    from osr_tpu_torch.benchmarks.quality import run_quality_benchmark

    ds = _quality_dataset(tmp_path)
    results = run_quality_benchmark(
        ds, methods=("bm25", "tfidf"), out_dir=tmp_path / "out", top_k=10,
        device="cpu",
    )
    assert "error" not in results["bm25"]
    assert results["bm25"]["ndcg@10"] > 0.5  # rare-term queries hit their doc
    assert (tmp_path / "out" / "ds_quality_report.md").exists()
    assert (tmp_path / "out" / "ds_quality_results.csv").exists()


def test_yaml_config_runner(tmp_path):
    import yaml

    from osr_tpu_torch.benchmarks.integration import load_benchmark_config, main

    cfg = {
        "out_dir": str(tmp_path / "out"),
        "seed": 7,
        "suites": {"storage": {"num_docs": 50}},
    }
    p = tmp_path / "bench.yaml"
    p.write_text(yaml.safe_dump(cfg))
    loaded = load_benchmark_config(p)
    assert loaded["suites"] == {"storage": {"num_docs": 50}}
    assert main(["--config", str(p), "--cpu"]) == 0
    assert (tmp_path / "out" / "integration_report.md").exists()

    bad = tmp_path / "bad.yaml"
    bad.write_text(yaml.safe_dump({"suites": {"nope": {}}}))
    with pytest.raises(ValueError):
        load_benchmark_config(bad)


def test_yaml_benchmark_runner(tmp_path):
    """python -m osr_tpu_torch bench --config reproduces the test_results
    tree from a YAML spec (reference bench/core/benchmark_runner.py)."""
    import yaml

    from osr_tpu_torch.benchmarks.runner import (
        BenchmarkConfig,
        load_benchmark_config,
        run_from_config,
    )

    cfg_path = tmp_path / "spec.yaml"
    cfg_path.write_text(
        yaml.safe_dump(
            {
                "name": "tiny",
                "seed": 7,
                "num_threads": 1,
                "output_dir": str(tmp_path / "out"),
                "suites": {
                    "topk": {"n": 2000, "batch": 4, "k": 20},
                    "quantization": {},
                },
            }
        )
    )
    cfg = load_benchmark_config(cfg_path)
    assert isinstance(cfg, BenchmarkConfig)
    overall = run_from_config(cfg, device="cpu")
    assert overall["all_passed"], overall
    assert (tmp_path / "out" / "topk_results.json").exists()
    assert (tmp_path / "out" / "quantization_results.json").exists()
    assert overall["config"]["seed"] == 7

    # unknown suite / key rejected
    bad = tmp_path / "bad.yaml"
    bad.write_text("suites: {nope: {}}\n")
    with pytest.raises(ValueError, match="Unknown benchmark suites"):
        load_benchmark_config(bad)
    bad.write_text("bogus_key: 1\n")
    with pytest.raises(ValueError, match="Unknown benchmark config keys"):
        load_benchmark_config(bad)


def test_cli_bench_config(tmp_path, capsys):
    import yaml

    from osr_tpu_torch.cli import main

    cfg_path = tmp_path / "spec.yaml"
    cfg_path.write_text(
        yaml.safe_dump(
            {
                "suites": {"topk": {"n": 1000, "batch": 2, "k": 10}},
                "output_dir": str(tmp_path / "res"),
            }
        )
    )
    rc = main(["--platform", "cpu", "bench", "--config", str(cfg_path)])
    assert rc == 0
    assert (tmp_path / "res" / "topk_results.json").exists()
    line = json.loads(capsys.readouterr().out)
    assert line == {"all_passed": True, "total_benchmarks": 3,
                    "total_passed": 3, "output_dir": str(tmp_path / "res")}


def test_beir_compatible_search_adapter(tmp_path):
    """BEIRCompatibleSearch duck-types beir's BaseSearch: search(corpus,
    queries, top_k) -> {qid: {doc_id: score}} with REAL ranking, plus the
    mmap store for document fetch."""
    from tests.reference_impl import DenseOracleScorer, zipf_corpus

    from osr_tpu_torch.benchmarks.beir_adapter import BEIRCompatibleSearch

    corpus_raw = zipf_corpus(num_docs=120, vocab_size=400, avg_len=40)
    corpus = {
        d: {"text": rec["text"], "title": ""} for d, rec in corpus_raw.items()
    }
    queries = {"q1": "term200 term340", "q2": "term150"}
    s = BEIRCompatibleSearch(
        method="bm25", store_path=tmp_path / "c.osrd", cache_queries=False,
        device="cpu",
    )
    try:
        results = s.search(corpus, queries, top_k=5)
        assert set(results) == {"q1", "q2"}
        oracle = DenseOracleScorer(corpus_raw, method="bm25")
        want_idx, want_scores = oracle.topk("term200 term340", 5)
        want = {
            oracle.doc_ids[i] for i, sc in zip(want_idx, want_scores) if sc > 0
        }
        assert set(results["q1"]) == want
        # store fetch joins text back
        docs = s.get_documents(list(results["q1"])[:2])
        assert all(d is not None and d.text for d in docs)
        assert s.index_stats["num_docs"] == 120
    finally:
        s.close()


def test_storage_suite_real_text(jax_ref):
    """The storage suite on real English prose (osr_tpu's list of the
    reference project's markdown), where zlib compresses (>1.2x); skips
    when those files are absent, as osr_tpu's test does."""
    from osr_tpu.benchmarks.suites import REAL_PROSE_FILES

    from osr_tpu_torch.benchmarks.suites import (
        StorageSuite,
        real_prose_paragraphs,
    )

    if not real_prose_paragraphs(REAL_PROSE_FILES):
        pytest.skip("reference prose not mounted")
    s = StorageSuite(num_docs=300, text_source="real",
                     prose_files=REAL_PROSE_FILES)
    s.setup()
    try:
        results = s.run()
    finally:
        s.cleanup()
    by_name = {r.name: r for r in results}
    assert all(r.passed for r in results)
    assert by_name["build"].metrics["compression_ratio"] > 1.2


def test_storage_suite_real_text_needs_files():
    from osr_tpu_torch.benchmarks.suites import StorageSuite

    with pytest.raises(ValueError):
        StorageSuite(text_source="nope")
    s = StorageSuite(num_docs=5, text_source="real", prose_files=["missing.md"])
    with pytest.raises(RuntimeError):
        s.setup()
    s.cleanup()


# ----------------------------------------------------------------------
# Selection helpers against osr_tpu
# ----------------------------------------------------------------------


def _scores(kind, shape, seed):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.randn(*shape).astype(np.float32)
    if kind == "integers":  # many exact ties
        return rng.randint(0, 6, shape).astype(np.float32)
    # Distinct f32 values that tie in bf16: the coarse stage sees ties.
    base = rng.randint(0, 8, shape).astype(np.float32)
    return base + rng.randint(0, 4, shape).astype(np.float32) * 2.0**-12


TOPK_CASES = [
    ("random", (4, 5000), 100),
    ("integers", (3, 3000), 50),
    ("bf16_ties", (3, 4000), 40),
    ("integers", (2, 100), 7),
    ("random", (2, 30), 50),  # k > N
]


@pytest.mark.parametrize("kind,shape,k", TOPK_CASES)
@pytest.mark.parametrize("fn", ["fast_topk", "approx_topk_threshold"])
def test_selection_matches_osr_tpu(jax_ref, fn, kind, shape, k):
    import importlib

    import jax.numpy as jnp

    from osr_tpu_torch.ops import topk as ttopk

    jtopk = importlib.import_module("osr_tpu.ops.topk")

    x = _scores(kind, shape, seed=shape[1])
    want_v, want_i = getattr(jtopk, fn)(jnp.asarray(x), k=k)
    got_v, got_i = getattr(ttopk, fn)(torch.from_numpy(x), k=k)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_approx_threshold_masks_on_wide_rows(jax_ref):
    """At N=50,000 (TopKSuite's width) the threshold path runs (782
    samples >= 4 k) and still gives osr_tpu's selection."""
    import importlib

    import jax.numpy as jnp

    from osr_tpu_torch.ops import topk as ttopk

    jtopk = importlib.import_module("osr_tpu.ops.topk")

    for kind in ("random", "integers"):
        x = _scores(kind, (4, 50_000), seed=3)
        want = jtopk.approx_topk_threshold(jnp.asarray(x), k=100)
        got = ttopk.approx_topk_threshold(torch.from_numpy(x), k=100)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["random", "integers"])
def test_merge_topk_matches_osr_tpu(jax_ref, kind):
    """Parts whose scores tie across parts: ties go to the lower position
    in the concatenation, whatever the ids."""
    import importlib

    import jax.numpy as jnp

    from osr_tpu_torch.ops import topk as ttopk

    jtopk = importlib.import_module("osr_tpu.ops.topk")

    rng = np.random.RandomState(9)
    widths = (12, 20, 7)
    parts = [_scores(kind, (5, w), seed=w) for w in widths]
    ids = rng.permutation(sum(widths)).astype(np.int32)[::-1].copy()
    id_parts = np.split(np.tile(ids, (5, 1)), np.cumsum(widths)[:-1], axis=1)
    for k in (10, 39, 60):
        want = jtopk.merge_topk(
            [jnp.asarray(p) for p in parts],
            [jnp.asarray(i) for i in id_parts], k,
        )
        got = ttopk.merge_topk(
            [torch.from_numpy(p) for p in parts],
            [torch.from_numpy(np.ascontiguousarray(i)) for i in id_parts], k,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ops_exports():
    import osr_tpu_torch.ops as ops
    from osr_tpu_torch.ops import topk as ttopk

    for name in ("block_topk", "fast_topk", "merge_topk",
                 "approx_topk_threshold"):
        assert getattr(ops, name) is getattr(ttopk, name)
    assert ops.topk is ttopk  # the module, a documented divergence


# ----------------------------------------------------------------------
# Validators and suites against osr_tpu
# ----------------------------------------------------------------------


def test_validators_match_osr_tpu(jax_ref):
    from osr_tpu import testing as jt

    rng = np.random.RandomState(4)
    a, b = rng.randn(50), rng.randn(50)
    ties = rng.randint(0, 4, 40).astype(np.float64)
    for x, y in ((a, b), (ties, ties[::-1]), ([1.0], [2.0]), (a, a)):
        assert spearman_correlation(x, y) == jt.spearman_correlation(x, y)
    V, JV = CorrectnessValidator, jt.CorrectnessValidator
    got, want = a.astype(np.float32), (a + 1e-4 * b).astype(np.float32)
    for kw in ({}, {"atol": 1e-5, "rtol": 1e-6}):
        assert V.validate_scores(got, want, **kw) == JV.validate_scores(
            got, want, **kw
        )
    for g, w, kw in (([1, 2, 3], [1, 2, 4], {}),
                     ([3, 2, 1, 9], [1, 2, 3, 4], {"min_overlap": 0.5}),
                     ([], [], {}), ([5], [5, 6], {})):
        assert V.validate_topk_ranking(g, w, **kw) == JV.validate_topk_ranking(
            g, w, **kw
        )
    recon = a.reshape(5, 10) + 0.1 * b.reshape(5, 10)
    for kw in ({}, {"min_cosine": 0.999}):
        assert V.validate_quantization(
            a.reshape(5, 10), recon, **kw
        ) == JV.validate_quantization(a.reshape(5, 10), recon, **kw)


def test_performance_benchmark_matches_osr_tpu(jax_ref):
    """compare_implementations gives osr_tpu's keys for each
    implementation on the same thunks (plain, torch and nested results),
    a positive median, the baseline's speedup 1.0 and every other speedup
    as the baseline's median over its own."""
    from osr_tpu import testing as jt

    from osr_tpu_torch.testing import PerformanceBenchmark

    a = np.random.RandomState(5).randn(32, 32).astype(np.float32)
    t = torch.from_numpy(a)
    thunks = {
        "numpy": lambda: a @ a,
        "torch": lambda: t @ t,
        "nested": lambda: (t @ t, {"x": [t + 1]}),
    }
    got = PerformanceBenchmark(warmup=1, runs=3).compare_implementations(
        thunks, "numpy"
    )
    want = jt.PerformanceBenchmark(warmup=1, runs=3).compare_implementations(
        thunks, "numpy"
    )
    assert list(got) == list(want) == list(thunks)
    for name, row in got.items():
        assert set(row) == set(want[name]) == {
            "median_s", "speedup_vs_baseline"
        }
        assert row["median_s"] > 0
        assert row["speedup_vs_baseline"] == (
            got["numpy"]["median_s"] / row["median_s"]
        )
    assert got["numpy"]["speedup_vs_baseline"] == 1.0
    assert want["numpy"]["speedup_vs_baseline"] == 1.0


@pytest.mark.parametrize("before", [None, "3"])
def test_run_from_config_scopes_thread_cap(monkeypatch, before):
    """num_threads sets OMP/MKL_NUM_THREADS for the suite run only: the
    run sees the cap, and the process's values (set or unset) are back
    after it."""
    import os

    from osr_tpu_torch.benchmarks import runner as R

    seen = {}

    class Runner:
        def __init__(self, **kwargs):
            pass

        def run(self):
            seen.update({k: os.environ.get(k) for k in R._THREAD_VARS})
            return {"all_passed": True}

    monkeypatch.setattr(R, "IntegrationRunner", Runner)
    for k in R._THREAD_VARS:
        if before is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, before)
    R.run_from_config(R.config_from_dict({"num_threads": 1}), device="cpu")
    assert seen == {k: "1" for k in R._THREAD_VARS}
    assert {k: os.environ.get(k) for k in R._THREAD_VARS} == {
        k: before for k in R._THREAD_VARS
    }


def _run_suite(suite):
    suite.setup()
    try:
        return {r.name: r for r in suite.run()}
    finally:
        suite.cleanup()


@pytest.mark.parametrize("name", sorted(SMALL_SUITES))
def test_suite_metrics_match_osr_tpu(jax_ref, name):
    """Every row of the port's suite (CPU) against the same row of
    osr_tpu's (JAX on the CPU): the same rows, pass flags and correctness
    metrics."""
    from osr_tpu.benchmarks.suites import ALL_SUITES as JAX_SUITES
    from osr_tpu_torch.benchmarks.suites import ALL_SUITES

    kwargs = SMALL_SUITES[name]
    cls = ALL_SUITES[name]
    extra = {"device": "cpu"} if cls.uses_device else {}
    got = _run_suite(cls(**kwargs, **extra))
    want = _run_suite(JAX_SUITES[name](**kwargs))
    assert list(got) == list(want)
    for row, w in want.items():
        g = got[row]
        assert g.passed == w.passed is True, row
        assert g.error is w.error is None
        keys = set(w.metrics) - TIMINGS
        assert set(g.metrics) - TIMINGS == keys, row
        assert {k: g.metrics[k] for k in keys} == {
            k: w.metrics[k] for k in keys
        }, row


def test_quality_benchmark_matches_osr_tpu(jax_ref, tmp_path):
    from osr_tpu.benchmarks.quality import run_quality_benchmark as jrun
    from osr_tpu_torch.benchmarks.quality import run_quality_benchmark

    ds = _quality_dataset(tmp_path)
    methods = ("bm25", "tfidf")
    got = run_quality_benchmark(ds, methods=methods, out_dir=tmp_path / "t",
                                top_k=10, device="cpu")
    want = jrun(ds, methods=methods, out_dir=tmp_path / "j", top_k=10)
    for m in methods:
        ir = {k for k in want[m] if "@" in k}
        assert ir and {k: got[m][k] for k in ir} == {k: want[m][k] for k in ir}
        for k in ("method", "num_queries", "num_docs", "top_k"):
            assert got[m][k] == want[m][k]


def test_beir_adapter_matches_osr_tpu(jax_ref, tmp_path):
    from osr_tpu.benchmarks.beir_adapter import BEIRCompatibleSearch as J
    from osr_tpu_torch.benchmarks.beir_adapter import BEIRCompatibleSearch

    corpus = SyntheticDataGenerator(seed=3).zipf_corpus(300, 900, avg_len=40)
    queries = SyntheticDataGenerator(seed=5).queries(24, 900, avg_terms=4)
    for method in ("bm25", "tfidf"):
        got_s = BEIRCompatibleSearch(method=method,
                                     store_path=tmp_path / f"t_{method}.osrd",
                                     device="cpu")
        want_s = J(method=method, store_path=tmp_path / f"j_{method}.osrd")
        try:
            got = got_s.search(corpus, queries, top_k=10)
            want = want_s.search(corpus, queries, top_k=10)
            assert list(got) == list(want)
            for qid, w in want.items():
                assert list(got[qid]) == list(w), (method, qid)
                np.testing.assert_allclose(
                    list(got[qid].values()), list(w.values()), rtol=1e-6
                )
            assert got_s.index_stats == want_s.index_stats
            hits = [d for r in got.values() for d in r][:5]
            for g, w in zip(got_s.get_documents(hits),
                            want_s.get_documents(hits)):
                assert (g.id, g.text, g.title) == (w.id, w.text, w.title)
        finally:
            got_s.close()
            want_s.close()


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------


@pytest.mark.cuda
def test_suites_on_card_launch_kernels(cuda):
    """BM25Suite and QuantizationSuite on the card: every row passes, the
    head_kernel_parity row holds K1 == K2 and K1 within tolerance of the
    plain scores, and K1, K5, K7 and K8 launch; the symmetric quality
    metrics equal the CPU run's (K7 and K8 bit-equal to their plain
    versions)."""
    from osr_tpu_torch.benchmarks.suites import BM25Suite, QuantizationSuite
    from osr_tpu_torch.ops import head, matmul, quantize_kernels

    for mod in (head, matmul, quantize_kernels):
        mod.reset_launches()
    bm25 = _run_suite(BM25Suite(device="cuda"))
    quant = _run_suite(QuantizationSuite(device="cuda"))
    torch.cuda.synchronize()
    assert all(r.passed for r in {**bm25, **quant}.values())
    parity = bm25["head_kernel_parity"].metrics
    assert parity["k1_equals_k2_scores"] and parity["within_tolerance_of_plain"]
    assert parity["masked_rows_neg_inf"] and parity["kernel_s"] > 0
    assert head.LAUNCHES["head_scores_i8"] > 0
    assert matmul.LAUNCHES["int8_similarity"] > 0
    assert quantize_kernels.LAUNCHES["quantize_symmetric"] > 0
    assert quantize_kernels.LAUNCHES["dequantize_symmetric"] > 0
    assert quant["int8_matmul_speed"].metrics["int8_s"] > 0
    cpu = _run_suite(QuantizationSuite(device="cpu"))
    row = "quantize_symmetric_quality"
    assert quant[row].metrics == cpu[row].metrics
