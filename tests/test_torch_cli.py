"""The port's CLI (osr_tpu_torch/cli.py), mirrored from
tests/test_pipeline.py's CLI test with ``--platform cpu``, for every
ported subcommand: run, ablate, validate, evaluate, errors and
bench --dataset. Outputs are held against osr_tpu's CLI where the command
is deterministic (validate, evaluate, errors)."""

import json

import pytest
import torch
import yaml

from tests.reference_impl import zipf_corpus


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    ds = root / "synth"
    ds.mkdir()
    corpus = zipf_corpus(num_docs=80, vocab_size=400, avg_len=40)
    with open(ds / "corpus.jsonl", "w") as f:
        for doc_id, doc in corpus.items():
            f.write(json.dumps({"_id": doc_id, "text": doc["text"]}) + "\n")
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


@pytest.fixture(scope="module")
def config_file(dataset_dir, tmp_path_factory):
    """tests/test_pipeline.py's config, with no device named: the CLI's
    --platform sets it (the dense block is a plain type string)."""
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
                    "params": {"top_k": 10, "cache_matrices": False},
                },
                "reader": {"type": "extractive", "params": {"max_answer_length": 100}},
            },
            {"name": "synth_dense", "dataset": "synth", "retriever": "dpr",
             "reader": "generative"},
        ],
    }
    path = tmp_path_factory.mktemp("cfg") / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, out


def test_cli_run_and_validate(config_file, dataset_dir, capsys):
    from osr_tpu.cli import main as want_main
    from osr_tpu_torch.cli import main

    path, out = config_file
    assert main(["--platform", "cpu", "validate", str(dataset_dir / "synth"),
                 "--stats"]) == 0
    got = capsys.readouterr().out
    assert want_main(["validate", str(dataset_dir / "synth"), "--stats"]) == 0
    assert got == capsys.readouterr().out
    assert main(["--platform", "cpu", "run", "--config", str(path)]) == 0
    captured = capsys.readouterr()
    assert "Completed 2/2 experiments" in captured.out
    overall = json.loads((out / "overall_results.json").read_text())
    assert overall["synth_dense"]["queries_processed"] == 12

    refs = {f"q{i}": "term1 answer text" for i in range(12)}
    refs_path = out / "refs.json"
    refs_path.write_text(json.dumps(refs))
    preds = str(out / "synth_bm25_preds.json")
    for args in (
        ["evaluate", "--predictions", preds, "--references", str(refs_path)],
        ["errors", "--predictions", preds, "--dataset",
         str(dataset_dir / "synth")],
    ):
        assert main(["--platform", "cpu", *args]) == 0
        got = capsys.readouterr().out
        assert want_main(args) == 0
        assert got == capsys.readouterr().out


def test_cli_ablate_and_bench(config_file, dataset_dir, tmp_path, capsys):
    from osr_tpu_torch.cli import main

    path, _ = config_file
    assert main(["--platform", "cpu", "ablate", "--config", str(path),
                 "--experiment", "synth_bm25", "--output-dir",
                 str(tmp_path)]) == 0
    assert "Completed 8/8 ablations" in capsys.readouterr().out
    assert main(["--platform", "cpu", "bench", "--dataset",
                 str(dataset_dir / "synth"), "--top-k", "5",
                 "--max-queries", "6", "--output",
                 str(tmp_path / "bench.json")]) == 0
    slim = json.loads(capsys.readouterr().out)
    assert slim["throughput_qps"] > 0 and "batch_1" in slim["latency"]
    # --config takes a benchmark spec: an experiment config is refused.
    with pytest.raises(ValueError, match="Unknown benchmark config keys"):
        main(["bench", "--config", str(path)])
    with pytest.raises(SystemExit):  # neither --dataset nor --config
        main(["bench"])


def test_platform_pins_every_retriever_block():
    from osr_tpu_torch.cli import _pin_device

    exp = {"retriever": "dpr"}
    _pin_device(exp, "cpu")
    assert exp["retriever"] == {"type": "dpr", "params": {"device": "cpu"}}
    exp = {"retriever": {"type": "bm25", "params": None}}
    _pin_device(exp, "cuda")
    assert exp["retriever"]["params"] == {"device": "cuda"}
    exp = {"retriever": {"type": "bm25", "params": {"device": "cpu"}}}
    _pin_device(exp, None)
    assert exp["retriever"]["params"] == {"device": "cpu"}


def test_cli_default_platform_needs_a_card(config_file, tmp_path, capsys):
    """Without --platform cpu the retrievers run on cuda: with no card
    every experiment fails and the command says so."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    from osr_tpu_torch.cli import main

    path, _ = config_file
    assert main(["run", "--config", str(path), "--output-dir",
                 str(tmp_path)]) == 1
    assert "Completed 0/2 experiments" in capsys.readouterr().out
