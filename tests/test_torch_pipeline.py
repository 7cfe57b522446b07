"""The port's experiment pipeline (osr_tpu_torch/pipeline/), mirrored from
tests/test_pipeline.py with every retriever on ``device: cpu`` (its CLI
test is in tests/test_torch_cli.py), and held against
``osr_tpu.pipeline.run_all_experiments`` on the same dataset files.

Tolerance, port against osr_tpu, for bm25, dense (``hashing_idf`` int8)
and the hybrid RRF-IDF alike: the same quality dict, preds equal (answers
string-equal, the same doc ids in the same order, scores within rtol
1e-5) and the same error report. The port's quantizer gives
``osr_tpu``'s codes and scales bit for bit, half steps included (K7's
scale is absmax times f32(1/127), as osr_tpu's XLA computes it), so a
run with ``osr_tpu``'s codes substituted for the port's quantizer is
``osr_tpu``'s too.
"""

import json

import numpy as np
import pytest
import torch

from osr_tpu_torch.testing import SyntheticDataGenerator, build_dataset


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """tests/test_pipeline.py's dataset (the port's seeded Zipf generator:
    this file imports nothing of tests/ so that it runs on the card
    machine): query qN is drawn from doc dN's rare terms, so dN is its
    relevant doc."""
    root = tmp_path_factory.mktemp("datasets")
    ds = root / "synth"
    ds.mkdir()
    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(80, 400, avg_len=40)
    with open(ds / "corpus.jsonl", "w") as f:
        for doc_id, doc in corpus.items():
            f.write(
                json.dumps({"_id": doc_id, "text": doc["text"], "title": doc["title"]})
                + "\n"
            )
    with open(ds / "queries.jsonl", "w") as f:
        for i in range(12):
            words = corpus[f"doc{i}"]["text"].split()
            rare = sorted(set(words), key=lambda w: -int(w[4:]))[:3]
            f.write(json.dumps({"_id": f"q{i}", "text": " ".join(rare)}) + "\n")
    (ds / "qrels").mkdir()
    with open(ds / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for i in range(12):
            f.write(f"q{i}\tdoc{i}\t1\n")
    return root


CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def config_file(dataset_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("results")
    cfg = {
        "output_dir": str(out),
        "datasets_root": str(dataset_dir),
        "experiments": [
            {
                "name": "synth_bm25",
                "dataset": "synth",
                "retriever": {
                    "type": "bm25",
                    "params": {"top_k": 10, "cache_matrices": False, **CPU},
                },
                "reader": {"type": "extractive", "params": {"max_answer_length": 100}},
            },
            {
                "name": "synth_dense",
                "dataset": "synth",
                "retriever": {
                    "type": "dpr",
                    "params": {"top_k": 10, "embedding_dim": 32, **CPU},
                },
                "reader": {"type": "generative", "params": {}},
            },
        ],
    }
    yaml = pytest.importorskip("yaml")
    path = tmp_path_factory.mktemp("cfg") / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, out


def test_run_all_experiments(config_file):
    from osr_tpu_torch.pipeline.config import load_config
    from osr_tpu_torch.pipeline.experiment import run_all_experiments

    path, out = config_file
    cfg = load_config(str(path))
    overall = run_all_experiments(cfg)
    assert overall["synth_bm25"]["status"] == "ok"
    assert overall["synth_dense"]["status"] == "ok"
    q = overall["synth_bm25"]["quality"]
    assert q["recall@10"] >= 0.9
    assert q["ndcg@10"] > 0.5
    assert (out / "overall_results.json").exists()
    preds = json.loads((out / "synth_bm25_preds.json").read_text())
    assert len(preds) == 12
    assert all(p["answer"] for p in preds)
    summary = json.loads((out / "synth_bm25_summary.json").read_text())
    assert summary["queries_processed"] == 12
    assert summary["queries_per_second"] > 0
    assert summary["hardware_info"]["platform"] in ("cpu", "gpu")


def test_config_validation(tmp_path):
    from osr_tpu_torch.pipeline.config import (
        ConfigError,
        load_config,
        validate_config,
    )

    with pytest.raises(ConfigError):
        validate_config({"experiments": []})
    with pytest.raises(ConfigError):
        validate_config({"experiments": [{"name": "x"}]})
    p = tmp_path / "bad.yaml"
    p.write_text("output_dir: x\n")
    with pytest.raises(ConfigError):
        load_config(p)
    with pytest.raises(FileNotFoundError):
        load_config(tmp_path / "missing.yaml")
    # A dict needs no YAML; defaults are filled in.
    cfg = validate_config({"experiments": [
        {"name": "a", "dataset": "d", "retriever": "bm25"}]})
    assert cfg["output_dir"] == "results" and cfg["datasets_root"] == "datasets"


def test_ablation(dataset_dir, tmp_path):
    from osr_tpu_torch.pipeline.ablation import (
        deep_update,
        generate_ablation_configs,
        run_ablation,
    )

    assert deep_update({"a": {"b": 1, "c": 2}}, {"a": {"b": 9}}) == {
        "a": {"b": 9, "c": 2}
    }
    base = {
        "name": "synth_bm25",
        "dataset": "synth",
        "retriever": {"type": "bm25",
                      "params": {"top_k": 10, "cache_matrices": False, **CPU}},
        "reader": {"type": "extractive", "params": {}},
    }
    ablations = [
        {"name": "k5", "retriever": {"params": {"top_k": 5}}},
        {"name": "b0", "retriever": {"params": {"b": 0.0}}},
    ]
    cfgs = generate_ablation_configs(base, ablations)
    assert cfgs[0]["name"] == "synth_bm25_k5"
    assert cfgs[0]["retriever"]["params"]["top_k"] == 5
    assert cfgs[1]["retriever"]["params"]["b"] == 0.0
    assert cfgs[1]["retriever"]["params"]["top_k"] == 10
    assert cfgs[1]["retriever"]["params"]["device"] == "cpu"

    results = run_ablation(
        base,
        {"datasets_root": str(dataset_dir)},
        tmp_path / "ablations",
        ablations,
    )
    assert all(r["status"] == "ok" for r in results.values())
    assert (tmp_path / "ablations" / "ablation_results.json").exists()


def test_error_analysis():
    from osr_tpu.pipeline import errors as want_mod
    from osr_tpu_torch.pipeline.errors import (
        categorize_errors,
        generate_error_report,
    )

    preds = [
        {"qid": "q_ok", "answer": "real answer", "contexts": [{"docid": "d1"}]},
        {"qid": "q_nogold", "answer": "a", "contexts": [{"docid": "d1"}]},
        {"qid": "q_noret", "answer": "a", "contexts": []},
        {"qid": "q_miss", "answer": "a", "contexts": [{"docid": "dX"}]},
        {"qid": "q_reader", "answer": "No sufficient context available.",
         "contexts": [{"docid": "d5"}]},
    ]
    qrels = {
        "q_ok": {"d1": 1},
        "q_noret": {"d2": 1},
        "q_miss": {"d3": 1},
        "q_reader": {"d5": 1},
    }
    buckets = categorize_errors(preds, qrels)
    assert buckets["ok"] == ["q_ok"]
    assert buckets["no_gold_standard"] == ["q_nogold"]
    assert buckets["no_retrieval"] == ["q_noret"]
    assert buckets["retriever_miss"] == ["q_miss"]
    assert buckets["reader_issue"] == ["q_reader"]

    report = generate_error_report(preds, qrels)
    assert report["total_predictions"] == 5
    assert report["retrieval_performance"]["avg_recall"] == pytest.approx(
        (1 + 0 + 0 + 1) / 4
    )
    assert report == want_mod.generate_error_report(preds, qrels)


def test_efficiency_benchmark():
    from osr_tpu_torch.pipeline.efficiency import (
        benchmark_index_scaling,
        run_comprehensive_benchmark,
    )

    gen = SyntheticDataGenerator(seed=42)
    corpus = gen.zipf_corpus(60, 200, avg_len=20)
    queries = gen.queries(6, 200, avg_terms=4)
    report = run_comprehensive_benchmark(
        corpus, queries, top_k=5, batch_sizes=(1, 4), device="cpu"
    )
    assert report["throughput_qps"] > 0
    assert report["build"]["build_time_s"] > 0
    assert "p50_ms" in report["latency"]["batch_1"]

    scaling = benchmark_index_scaling(corpus, sizes=(20, 40))
    assert len(scaling) == 2
    assert scaling[1]["corpus_size"] == 40


def test_monitoring(tmp_path):
    from osr_tpu_torch.utils.monitoring import StatsMonitor

    mon = StatsMonitor(tmp_path, log_interval=0, track_device_memory=True)
    q = mon.start_query("q1")
    mon.end_query(q, num_results=5)
    q2 = mon.start_query("q2")
    mon.end_query(q2, error="boom")
    stats = mon.get_current_stats()
    assert stats["total_queries"] == 2
    assert stats["successful_queries"] == 1
    assert stats["failed_queries"] == 1
    assert stats["success_rate"] == 0.5
    logs = list(tmp_path.glob("stats_*.jsonl"))
    last = json.loads(logs[0].read_text().splitlines()[-1])
    assert last["total_queries"] >= 1
    assert set(last["device_memory_mb"]) == {
        f"cuda:{i}" for i in range(torch.cuda.device_count())
    }
    mon.reset_stats()
    assert mon.get_current_stats()["total_queries"] == 0


def test_hardware_detection():
    from osr_tpu_torch.utils.hardware import (
        detect_hardware_capabilities,
        get_optimization_recommendations,
        recommended_batch_size,
    )

    caps = detect_hardware_capabilities()
    assert caps["cores"] >= 1
    assert caps["num_devices"] >= 1
    assert caps["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")
    assert recommended_batch_size(caps) >= 8
    assert recommended_batch_size({"platform": "gpu", "num_devices": 2}) == 256
    recs = get_optimization_recommendations(caps)
    assert "scoring" in recs


def test_validate_backend():
    from osr_tpu_torch.utils.hardware import validate_backend

    v = validate_backend(device="cpu")
    assert v["ok"], v
    assert v["platform"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            validate_backend()  # cuda by default


def test_block_and_time_synchronizes_cuda_results(monkeypatch):
    """block_and_time synchronizes each CUDA device its (nested) result
    lives on, and nothing for host results."""
    from osr_tpu_torch.utils import timing

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    timing.block_and_time(lambda: {"a": [torch.zeros(2)], "b": 3})
    assert synced == []
    assert timing._cuda_devices(
        (torch.zeros(1), [torch.zeros(1, device="meta")]), set()
    ) == set()
    out = timing.time_fn(lambda: np.zeros(3), warmup=1, runs=3)
    assert out["runs"] == 3 and out["min_s"] <= out["median_s"]


# ---------------------------------------------------------------------------
# The port against osr_tpu on the same dataset files
# ---------------------------------------------------------------------------

PROSE_YAML = "osr_tpu/configs/prose_87k.yaml"
DENSE_EXP = {
    "name": "prose87k_dense_idf",
    "dataset": "prose87k",
    "retriever": {"type": "dpr", "params": {
        "top_k": 100, "encoder": "hashing_idf", "cache_matrices": False}},
    "reader": {"type": "llm", "params": {}},
}


def _prose_config(load, root, out, device):
    """prose_87k.yaml's two experiments plus a dense-only one, read by
    ``load`` (either package's load_config), datasets under ``root``."""
    cfg = load(PROSE_YAML)
    cfg["experiments"].append(json.loads(json.dumps(DENSE_EXP)))
    cfg["datasets_root"] = str(root)
    cfg["output_dir"] = str(out)
    if device is not None:
        for exp in cfg["experiments"]:
            exp["retriever"]["params"]["device"] = device
    return cfg


def _jax_codes(x):
    """osr_tpu's quantize_symmetric, as the port's quantizer's stand-in."""
    from osr_tpu.ops import quantize as jq

    codes, scales = jq.quantize_symmetric(x.float().numpy())
    return (torch.from_numpy(np.array(codes)),
            torch.from_numpy(np.array(scales)))


@pytest.fixture(scope="module")
def prose_runs(tmp_path_factory):
    """The slice-level case: 3,000 Zipf chunks of >= 48 words, 256 noisy
    queries with graded qrels (the port's build_dataset), prose_87k.yaml's
    experiments through osr_tpu's pipeline, the port's, and the port's with
    osr_tpu's quantizer codes."""
    pytest.importorskip("jax")
    from osr_tpu.pipeline import config as jconfig, experiment as jexp
    from osr_tpu_torch.ops import quantize as tq
    from osr_tpu_torch.pipeline import config as tconfig, experiment as texp

    root = tmp_path_factory.mktemp("prose")
    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(
        3_000, 20_000, avg_len=60, word_prefix="t", min_len=48
    )
    made, _ = build_dataset(
        root / "prose87k", [d["text"] for d in corpus.values()], 256,
        mode="noisy",
    )
    assert made == 256
    runs = {}
    runs["osr_tpu"] = jexp.run_all_experiments(_prose_config(
        jconfig.load_config, root, root / "osr_tpu", None))
    runs["port"] = texp.run_all_experiments(_prose_config(
        tconfig.load_config, root, root / "port", "cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tq, "quantize_symmetric", _jax_codes)
        runs["port_jax_codes"] = texp.run_all_experiments(_prose_config(
            tconfig.load_config, root, root / "port_jax_codes", "cpu"))
    return root, runs


def _preds(root, run, name):
    return json.loads((root / run / f"{name}_preds.json").read_text())


def _same_preds(got, want):
    assert [p["qid"] for p in got] == [p["qid"] for p in want]
    for g, w in zip(got, want):
        assert g["answer"] == w["answer"], g["qid"]
        assert g["contexts"] == w["contexts"], g["qid"]
        assert list(g["retriever_scores"]) == list(w["retriever_scores"])
        np.testing.assert_allclose(
            list(g["retriever_scores"].values()),
            list(w["retriever_scores"].values()), rtol=1e-5,
        )


EXPERIMENTS = ("prose87k_bm25", "prose87k_hybrid_rrf_idf", "prose87k_dense_idf")


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_pipeline_matches_osr_tpu(prose_runs, name):
    root, runs = prose_runs
    want = runs["osr_tpu"][name]
    for run in ("port", "port_jax_codes"):
        got = runs[run][name]
        assert got["status"] == want["status"] == "ok", got
        assert got["queries_processed"] == want["queries_processed"] == 256
        assert got["queries_failed"] == 0
        assert got["num_corpus"] == 3_000
    for run in ("port", "port_jax_codes"):
        assert runs[run][name]["quality"] == pytest.approx(
            want["quality"], rel=1e-12
        )
        _same_preds(_preds(root, run, name), _preds(root, "osr_tpu", name))


def test_pipeline_error_reports_match_osr_tpu(prose_runs):
    from osr_tpu.pipeline.errors import generate_error_report as want_report
    from osr_tpu_torch.pipeline.errors import generate_error_report
    from osr_tpu_torch.storage.loaders import load_qrels

    root, _ = prose_runs
    qrels = load_qrels(root / "prose87k")
    for name in EXPERIMENTS:
        want = want_report(_preds(root, "osr_tpu", name), qrels)
        for run in ("port", "port_jax_codes"):
            got = generate_error_report(_preds(root, run, name), qrels)
            assert got == want, (run, name)


def test_quantizer_divergence_is_the_only_difference(prose_runs):
    """The port's own corpus codes and scales equal osr_tpu's bit for bit
    over the hybrid's HashingEncoder vectors (bit-equal across packages),
    whose half steps a one-ulp scale difference would flip."""
    from osr_tpu.ops import quantize as jq
    from osr_tpu_torch.encoders import HashingEncoder
    from osr_tpu_torch.ops import quantize as tq
    from osr_tpu_torch.storage.loaders import load_corpus

    root, _ = prose_runs
    corpus = load_corpus(root / "prose87k")
    emb = HashingEncoder(dim=768, idf=True).encode(
        [d["text"] for d in corpus.values()]
    )
    t_codes, t_scales = (t.numpy() for t in tq.quantize_symmetric(torch.from_numpy(emb)))
    j_codes, j_scales = (np.asarray(a) for a in jq.quantize_symmetric(emb))
    np.testing.assert_array_equal(t_scales, j_scales)
    np.testing.assert_array_equal(t_codes, j_codes)
    half = np.abs(emb / j_scales[:, None])
    assert np.any(np.abs(half - np.floor(half) - 0.5) < 1e-4)


def test_summary_serializes_with_torch_device(dataset_dir, tmp_path):
    """A torch.device in a retriever block's params runs and leaves every
    summary and overall_results.json serializable."""
    from osr_tpu_torch import run_all_experiments

    cfg = {
        "datasets_root": str(dataset_dir),
        "output_dir": str(tmp_path),
        "experiments": [{
            "name": "dev", "dataset": "synth",
            "retriever": {"type": "bm25", "params": {
                "top_k": 5, "cache_matrices": False,
                "device": torch.device("cpu")}},
        }],
    }
    overall = run_all_experiments(cfg)
    assert overall["dev"]["status"] == "ok", overall
    json.dumps(overall)
    assert json.loads((tmp_path / "overall_results.json").read_text())[
        "dev"]["queries_processed"] == 12


def test_experiment_on_cuda_fails_without_a_card(dataset_dir, tmp_path):
    """A retriever left on the default device (cuda) is reported failed on
    a machine with no card; nothing runs quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    from osr_tpu_torch import run_all_experiments

    cfg = {
        "datasets_root": str(dataset_dir),
        "output_dir": str(tmp_path),
        "experiments": [{"name": "gpu", "dataset": "synth", "retriever": "bm25"}],
    }
    overall = run_all_experiments(cfg)
    assert overall["gpu"]["status"] == "failed"
    assert "no CUDA device" in overall["gpu"]["error"]


@pytest.mark.cuda
def test_pipeline_on_card_matches_cpu(dataset_dir, tmp_path):
    """bm25 (K2) and a dense hashing experiment (K7 + K5) through
    run_all_experiments on the card give the CPU's summaries (quality) and
    preds (scores within rtol 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    from osr_tpu_torch import run_all_experiments
    from osr_tpu_torch.ops import head, matmul, quantize_kernels

    def cfg(device):
        return {
            "datasets_root": str(dataset_dir),
            "output_dir": str(tmp_path / device),
            "experiments": [
                {"name": "bm25", "dataset": "synth",
                 "retriever": {"type": "bm25", "params": {
                     "top_k": 10, "cache_matrices": False, "device": device}},
                 "reader": "extractive"},
                {"name": "dense", "dataset": "synth",
                 "retriever": {"type": "dpr", "params": {
                     "top_k": 10, "encoder": "hashing_idf",
                     "embedding_dim": 128, "device": device}},
                 "reader": "generative"},
            ],
        }

    for mod in (head, matmul, quantize_kernels):
        mod.reset_launches()
    out = {d: run_all_experiments(cfg(d)) for d in ("cuda", "cpu")}
    assert head.LAUNCHES["head_blockmax_i8"] + head.LAUNCHES["head_scores_i8"] > 0
    assert quantize_kernels.LAUNCHES["quantize_symmetric"] > 0
    assert matmul.LAUNCHES["int8_similarity"] > 0
    for name in ("bm25", "dense"):
        assert out["cuda"][name]["status"] == "ok"
        assert out["cuda"][name]["quality"] == pytest.approx(
            out["cpu"][name]["quality"], abs=1e-12
        )
        _same_preds(
            json.loads((tmp_path / "cuda" / f"{name}_preds.json").read_text()),
            json.loads((tmp_path / "cpu" / f"{name}_preds.json").read_text()),
        )


@pytest.mark.slow
def test_prose_87k_matches_osr_tpu(tmp_path, capsys):
    """osr_tpu/configs/prose_87k.yaml over this machine's prose harvest
    (tools/bench_quality_at_scale.py's roots and windows, the noisy regime,
    512 queries, as tools/run_pipeline_87k.py builds it) through both
    packages on the CPU: nDCG@10 equal within the int8 near-tie band of
    bench_results/quality_real_text.json (0.0009, the at-scale noisy
    regime's osr-minus-reference delta, which its f32 head removes)."""
    from pathlib import Path

    from osr_tpu.pipeline import config as jconfig, experiment as jexp
    from osr_tpu_torch.pipeline import config as tconfig, experiment as texp
    from osr_tpu_torch.testing import harvest_chunks
    from tools import bench_quality_at_scale as tool

    repo = Path(__file__).resolve().parents[1]
    band = json.loads(
        (repo / "bench_results" / "quality_real_text.json").read_text()
    )["at_scale_noisy"]["ndcg10_delta_osr_minus_ref"]
    chunks = harvest_chunks(tool.PROSE_ROOTS, max_chunks=100_000)
    assert chunks == tool.harvest_chunks(100_000)
    assert len(chunks) >= 20_000
    made, grade1 = build_dataset(tmp_path / "prose87k", chunks, 512, mode="noisy")
    out = {}
    for pkg, cfg_mod, exp_mod, device in (
        ("osr_tpu", jconfig, jexp, None), ("port", tconfig, texp, "cpu")
    ):
        cfg = cfg_mod.load_config(repo / PROSE_YAML)
        cfg["datasets_root"] = str(tmp_path)
        cfg["output_dir"] = str(tmp_path / pkg)
        if device:
            for exp in cfg["experiments"]:
                exp["retriever"]["params"]["device"] = device
        out[pkg] = exp_mod.run_all_experiments(cfg)
    figures = {
        pkg: {name: r["quality"]["ndcg@10"] for name, r in res.items()}
        for pkg, res in out.items()
    }
    with capsys.disabled():
        print(f"\nprose harvest: {len(chunks)} docs, {made} queries, "
              f"{grade1} grade-1 qrels; nDCG@10 {json.dumps(figures)}")
    for name, want in figures["osr_tpu"].items():
        assert out["port"][name]["status"] == "ok"
        assert abs(figures["port"][name] - want) <= band, name
    if len(chunks) == 87_289:
        committed = {
            "prose87k_bm25": 0.6222, "prose87k_hybrid_rrf_idf": 0.6935}
        for name, value in committed.items():
            assert round(figures["port"][name], 4) == value, name


@pytest.mark.parametrize("mode", ["quote", "sample", "noisy"])
def test_build_dataset_matches_the_tool(tmp_path, mode):
    """The port's build_dataset writes tools/bench_quality_at_scale.py's
    files byte for byte (the same draws, the same qrels)."""
    pytest.importorskip("jax")
    from tools import bench_quality_at_scale as tool

    corpus = SyntheticDataGenerator(seed=7).zipf_corpus(
        400, 3_000, avg_len=60, word_prefix="w", min_len=30
    )
    chunks = [d["text"] for d in corpus.values()]
    got = build_dataset(tmp_path / "port", chunks, 40, mode=mode)
    want = tool.build_dataset(tmp_path / "tool", chunks, 40, mode=mode)
    assert got == want and got[0] > 0
    for name in ("corpus.jsonl", "queries.jsonl", "qrels/test.tsv"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "tool" / name
        ).read_bytes(), name


def test_harvest_chunks_matches_the_tool(tmp_path, monkeypatch):
    """harvest_chunks over a tree of prose files gives the tool's chunks
    (file order, windows, the 2 KiB floor, exact-duplicate removal,
    max_chunks)."""
    from osr_tpu_torch.testing import harvest_chunks
    from tools import bench_quality_at_scale as tool

    rng = np.random.RandomState(3)
    words = [f"word{i}" for i in range(500)]
    root = tmp_path / "prose"
    (root / "sub").mkdir(parents=True)
    dup = " ".join(rng.choice(words, 400))
    for i, name in enumerate(["b.md", "a.txt", "sub/c.rst", "d.py",
                              "e.md", "f.txt"]):
        text = dup if i >= 4 else " ".join(rng.choice(words, 100 + 150 * i))
        (root / name).write_text(text)
    (root / "tiny.md").write_text("too short " * 20)
    monkeypatch.setattr(tool, "PROSE_ROOTS", (str(root), str(tmp_path / "no")))
    for limit in (None, 7):
        got = harvest_chunks((str(root), str(tmp_path / "no")), max_chunks=limit)
        assert got == tool.harvest_chunks(limit) and got
