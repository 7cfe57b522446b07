"""The last three tools ported as modes of ``python -m osr_tpu_torch.bench``
(storage, pipeline-87k, evidence) against the JAX scripts they port and
osr_tpu's functions, on the CPU at small sizes from seeds.

Where a script writes under ``bench_results/`` or ``results/`` its
functions run from a copy in the test's temporary directory. Tolerances:
the storage rows' ``passed`` flags, ``compression_ratio`` and ``file_mb``
equal (the rates are wall times and are not compared); the anchor store's
``get_stats()`` counts and every text read back equal; pipeline-87k's
nDCG@10 within 0.0009 of osr_tpu's (the band of
tests/test_torch_pipeline.py's prose_87k test: the at-scale noisy
regime's int8 near-tie delta in bench_results/quality_real_text.json);
the evidence queue's step names, order, timeouts and options equal the
script's.
"""

import argparse
import ast
import contextlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from osr_tpu_torch.bench import common, evidence, pipeline_87k, storage
from osr_tpu_torch.bench import quality_at_scale as qas

REPO = Path(__file__).resolve().parents[1]
BAND = 0.0009  # tests/test_torch_pipeline.py's prose_87k band
PROSE_FILES = [str(REPO / n) for n in ("README.md", "ROADMAP.md",
                                        "DEVELOPMENT.md")]


def _script_first_root():
    """The first of the unique-text roots tools/bench_storage.py hard-codes
    (``roots = (Path(...), ...)`` in run_codec_comparison)."""
    tree = ast.parse((REPO / "tools" / "bench_storage.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "roots"):
            return Path(node.value.elts[0].args[0].value)
    raise AssertionError("no roots in tools/bench_storage.py")


SITE_PACKAGES = _script_first_root()


def _quiet(fn, *args, **kwargs):
    """``fn`` with standard output captured: (its value, the JSON lines it
    printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn(*args, **kwargs)
    return value, [json.loads(ln) for ln in buf.getvalue().splitlines()
                   if ln.startswith("{")]


def _script_copy(tmp_path, monkeypatch, name):
    """``tools/<name>`` copied into ``tmp_path/tools`` (with an empty
    ``tmp_path/bench_results``) and loaded from there."""
    tools = tmp_path / "tools"
    tools.mkdir(exist_ok=True)
    (tmp_path / "bench_results").mkdir(exist_ok=True)
    shutil.copy(REPO / "tools" / name, tools / name)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script inserts
    spec = importlib.util.spec_from_file_location(
        f"_copy_{Path(name).stem}", tools / name
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stamps(pattern):
    """Each file of the repo matching ``pattern`` (where the scripts wrote)
    and its modification time."""
    return {p: p.stat().st_mtime_ns for p in REPO.glob(pattern)}


# ----------------------------------------------------------------------
# storage
# ----------------------------------------------------------------------

STORE_DOCS = 300


@pytest.fixture
def storage_script(tmp_path, monkeypatch):
    """tools/bench_storage.py from a copy, with osr_tpu's REAL_PROSE_FILES
    pointed at PROSE_FILES."""
    from osr_tpu.benchmarks import suites

    monkeypatch.setattr(suites, "REAL_PROSE_FILES", tuple(PROSE_FILES))
    return _script_copy(tmp_path, monkeypatch, "bench_storage.py")


def _same_suite_rows(got, want):
    assert list(got) == list(want) == list(storage.SUITE_ROWS)
    for name, w in want.items():
        g = got[name]
        assert set(g) == set(w), name
        assert g["passed"] is w["passed"] is True, name
        for key in ("compression_ratio", "file_mb"):
            assert g.get(key) == w.get(key), (name, key)


@pytest.mark.parametrize("source", ["synthetic", "real"])
def test_storage_suite_rows_equal_the_script(storage_script, source):
    """The synthetic rows, and the real rows over the repo's own markdown
    (given to the port as --prose-files, to osr_tpu's suite through
    REAL_PROSE_FILES): the same names and passed flags, equal compression
    ratio and file size."""
    want = storage_script.run_suite(source, STORE_DOCS)
    files = PROSE_FILES if source == "real" else ()
    _same_suite_rows(storage.run_suite(source, STORE_DOCS, files), want)


@pytest.fixture
def recorded_docs(monkeypatch):
    """Every document osr_tpu's DocumentStore is given, in order."""
    from osr_tpu.storage import doc_store

    seen = []
    inner = doc_store.DocumentStore.add_documents

    def add_documents(self, docs):
        docs = list(docs)
        seen.append(docs)
        return inner(self, docs)

    monkeypatch.setattr(doc_store.DocumentStore, "add_documents",
                        add_documents)
    return seen


def test_storage_codec_rows_equal_the_script(storage_script, recorded_docs):
    """The codec rows, zstd with a trained dictionary included, on
    identical documents: the resampled rows over PROSE_FILES and the
    unique-text rows over the script's first root; equal compression
    ratio and file size, and the unique-text harvest equal to the
    script's windows."""
    if not SITE_PACKAGES.is_dir():
        pytest.skip(f"{SITE_PACKAGES}, the script's first root, is absent")
    want = storage_script.run_codec_comparison(STORE_DOCS)
    from osr_tpu_torch.benchmarks.suites import real_prose_paragraphs

    dropped = {}
    got, _ = _quiet(storage.codec_comparison, STORE_DOCS,
                    real_prose_paragraphs(PROSE_FILES), [str(SITE_PACKAGES)],
                    dropped)
    assert dropped == {} and list(got) == list(want)
    for key, w in want.items():
        if isinstance(w, dict):
            assert set(got[key]) == set(w), key
            for k in ("compression_ratio", "file_mb"):
                assert got[key][k] == w[k], (key, k)
        else:
            assert got[key] == w, key
    unique = [d.text for docs in recorded_docs for d in docs
              if d.id.startswith("u")]
    chunks = storage.unique_chunks([str(SITE_PACKAGES)], STORE_DOCS)
    assert len(chunks) == STORE_DOCS
    assert unique[:STORE_DOCS] == chunks


def test_storage_unique_harvest_skips_a_missing_root(tmp_path):
    """A missing root is skipped, not the end of the harvest (the script
    stopped at one)."""
    root = tmp_path / "docs"
    root.mkdir()
    words = " ".join(f"word{i}" for i in range(400))
    (root / "a.md").write_text(words)
    (root / "b.rst").write_text(words.upper())
    got = storage.unique_chunks([str(tmp_path / "absent"), str(root)], 10)
    assert len(got) == 6 and all(len(c) >= storage.MIN_CHARS for c in got)
    assert got[0] == " ".join(words.split()[:120])
    assert storage.unique_chunks([str(root)], 2) == got[:2]


def test_storage_anchor_store_equals_osr_tpus(tmp_path):
    """The anchor's store over the script's seeded Zipf corpus: the
    corpus osr_tpu's generator gives, the same get_stats() counts as
    osr_tpu's DocumentStore.build_from_corpus, the same text read back
    for every id; its rates positive."""
    from osr_tpu.storage.doc_store import DocumentStore as JaxStore
    from osr_tpu.testing import SyntheticDataGenerator
    from osr_tpu_torch.storage.doc_store import DocumentStore

    n = 2000
    corpus = storage.anchor_corpus(n)
    assert corpus == SyntheticDataGenerator(seed=42).zipf_corpus(
        n, 50_000, avg_len=130, word_prefix="t", min_len=5
    )
    rates = storage.osr_anchor(corpus, tmp_path / "port.osrd")
    assert list(rates) == list(storage.OSR_KEYS)
    assert all(v > 0 for v in rates.values())
    want = JaxStore.build_from_corpus(corpus, tmp_path / "ref.osrd")
    got = DocumentStore(tmp_path / "port.osrd")
    try:
        w, g = want.get_stats(), got.get_stats()
        for key in ("num_documents", "compression_ratio", "file_bytes"):
            assert g[key] == w[key], key
        for doc_id, doc in corpus.items():
            assert got.get_document(doc_id).text == doc["text"]
            assert want.get_document(doc_id).text == doc["text"]
    finally:
        got.close()
        want.close()


@pytest.mark.parametrize("case", ["no_prose_no_windows", "no_zstd"])
def test_storage_null_rows_are_named(case, tmp_path, monkeypatch):
    """The rows that cannot run are null and named in ``dropped``: without
    prose files the real suite and the resampled codec rows, without
    ``zstandard`` every zstd row, without windows under --roots the
    unique-text rows, always the anchor's reference half."""
    from osr_tpu_torch.storage import doc_store

    root = tmp_path / "roots"
    root.mkdir()
    if case == "no_zstd":
        monkeypatch.setattr(doc_store, "_zstd", None)
        prose = PROSE_FILES
        (root / "a.md").write_text(" ".join(f"w{i}" for i in range(600)))
    else:
        prose = [str(tmp_path / "absent.md")]
    row, printed = _quiet(storage.run, docs=60, ref_docs=200,
                          prose_files=prose, roots=[str(root)], device="cpu")
    assert printed == [row] and list(row) == list(storage.KEYS)
    assert row["kernel_launches"] == {} and row["device"] == "cpu"
    codecs, dropped = row["codec_comparison"], row["dropped"]
    if case == "no_zstd":
        nulls = {"zstd_l1", "zstd_l3", "zstd_dict_l3",
                 "zstd_dict_l3_unique_text"}
        assert row["real"] is not None
    else:
        nulls = set(storage.CODECS) | set(storage.UNIQUE_ROWS)
        assert row["real"] is None and dropped["real"] == storage.NO_PROSE
    for name in set(storage.CODECS) | set(storage.UNIQUE_ROWS):
        reason = dropped.get(f"codec_comparison.{name}")
        assert (codecs[name] is None) is (name in nulls) is bool(reason), name
        if case == "no_zstd" and reason:
            assert reason == storage.NO_ZSTD
    anchor = row["same_host_anchor"]
    for key in storage.REF_KEYS:
        assert anchor[key] is None
        assert dropped[f"same_host_anchor.{key}"] == storage.NO_REF
    assert all(anchor[k] > 0 for k in storage.OSR_KEYS)
    assert anchor["num_docs"] == 200
    assert len(dropped) == len(nulls) + len(storage.REF_KEYS) + (
        case != "no_zstd")


def test_storage_writes_only_under_out(tmp_path, monkeypatch, capsys):
    """Without --out nothing is written (the script wrote
    bench_results/storage_real_text.json); with it the whole result."""
    root = tmp_path / "roots"
    root.mkdir()
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before = _stamps("bench_results/storage*")
    args = ["--docs", "40", "--ref-docs", "100", "--roots", str(root)]
    assert storage.main(args) == 0
    assert list(cwd.iterdir()) == []
    out = tmp_path / "o" / "storage.json"
    assert storage.main(args + ["--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(out.read_text()) == json.loads(lines[-1])
    assert _stamps("bench_results/storage*") == before


# ----------------------------------------------------------------------
# pipeline-87k
# ----------------------------------------------------------------------


def _prose_tree(root, files=24, words=600, seed=11):
    """Seeded prose files: Zipf-drawn words of 3-9 letters in .md, .rst
    and .txt files."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = sorted({"".join(rng.choice(letters, rng.randint(3, 10)))
                    for _ in range(3_000)})
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    root.mkdir(parents=True)
    for i in range(files):
        ws = [vocab[j] for j in rng.choice(len(vocab), words, p=p)]
        (root / f"doc{i}{('.md', '.rst', '.txt')[i % 3]}").write_text(
            " ".join(ws))
    return root


@pytest.fixture(scope="module")
def prose_root(tmp_path_factory):
    return _prose_tree(tmp_path_factory.mktemp("prose") / "tree")


PIPE_QUERIES = 64


def test_pipeline_87k_matches_osr_tpu(prose_root, tmp_path, monkeypatch,
                                      capsys):
    """prose_87k.yaml over a seeded prose tree (the floor lowered to its
    size) through the mode and through osr_tpu's run_all_experiments on
    the tool's dataset files for the same chunks: every status ok, the
    same query and qrel counts, nDCG@10 within BAND; the summaries written
    under --out only."""
    from osr_tpu.pipeline import config as jconfig, experiment as jexp
    from tools import bench_quality_at_scale as tool

    chunks = qas.harvest(None, [str(prose_root)])
    monkeypatch.setattr(qas, "MIN_CHUNKS", len(chunks))
    out = tmp_path / "port"
    rc = pipeline_87k.main(["--cpu", "--roots", str(prose_root),
                            "--num-queries", str(PIPE_QUERIES),
                            "--out", str(out)])
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and list(row) == list(pipeline_87k.KEYS)
    assert row["num_docs"] == len(chunks) and row["device"] == "cpu"
    assert row["kernel_launches"] == {} and row["harvest_s"] >= 0
    assert (out / "overall_results.json").is_file()

    made, grade1 = tool.build_dataset(tmp_path / "ds" / "prose87k", chunks,
                                      PIPE_QUERIES, mode="noisy")
    assert (row["num_queries"], row["grade1_qrels"]) == (made, grade1)
    cfg = jconfig.load_config(pipeline_87k.CONFIG)
    cfg["datasets_root"] = str(tmp_path / "ds")
    cfg["output_dir"] = str(tmp_path / "osr_tpu")
    want = jexp.run_all_experiments(cfg)
    assert list(row["experiments"]) == list(want)
    for name, w in want.items():
        g = row["experiments"][name]
        assert w["status"] == g["status"] == "ok", name
        assert abs(g["quality"]["ndcg@10"] - w["quality"]["ndcg@10"]) <= BAND
        assert set(g["quality"]) == set(w["quality"])
        assert set(g["stage_times_s"]) >= {"build", "retrieve", "read"}
        assert g["retrieval_qps"] > 0 and g["queries_per_second"] > 0
        assert g["kernel_launches"] == {}
        assert (out / f"{name}_summary.json").is_file()


def test_pipeline_87k_refuses_below_the_floor(prose_root, capsys):
    """Below 20,000 chunks the mode prints the line with no value and the
    reason and exits 1, as quality-at-scale does."""
    chunks = qas.harvest(None, [str(prose_root)])
    rc = pipeline_87k.main(["--cpu", "--roots", str(prose_root)])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 1
    assert line == {
        "metric": pipeline_87k.METRIC, "value": None,
        "num_docs": len(chunks),
        "error": f"only {len(chunks)} chunks harvested; need >=20000 for "
                 "the at-scale claim",
    }


def test_pipeline_87k_exits_1_when_an_experiment_fails(
        prose_root, tmp_path, monkeypatch, capsys):
    """run_all_experiments records a failed experiment and goes on; the
    mode exits 1 unless every experiment is ok, and writes nothing without
    --out."""
    monkeypatch.setattr(qas, "MIN_CHUNKS", 10)
    cfg = {"experiments": [
        {"name": "good", "dataset": "d",
         "retriever": {"type": "bm25", "params": {
             "top_k": 10, "cache_matrices": False}}},
        {"name": "bad", "dataset": "d",
         "retriever": {"type": "no_such_retriever"}},
    ]}
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    rc = pipeline_87k.main(["--cpu", "--roots", str(prose_root),
                            "--num-queries", "16", "--config", str(path)])
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 1 and row["output_dir"] is None
    assert row["experiments"]["good"]["status"] == "ok"
    assert row["experiments"]["bad"]["status"] == "failed"
    assert "no_such_retriever" in row["experiments"]["bad"]["error"]
    assert list(cwd.iterdir()) == []


# ----------------------------------------------------------------------
# evidence
# ----------------------------------------------------------------------

# The script each step ran, and the mode that ports it.
SCRIPT_MODE = {
    "tools/profile_narrow.py": "profile-narrow", "bench.py": "headline",
    "tools/bench_hybrid.py": "hybrid",
    "tools/bench_sharded_tpu.py": "sharded-overhead",
    "tools/bench_dense_encoder.py": "dense-encoder",
    "tools/bench_quality_at_scale.py": "quality-at-scale",
    "tools/bench_dense_scale.py": "dense-scale",
    "tools/bench_scaling.py": "scaling",
}


@pytest.fixture
def evidence_script(tmp_path, monkeypatch):
    script = _script_copy(tmp_path, monkeypatch, "run_tpu_evidence.py")
    monkeypatch.setattr(script, "ROOT", tmp_path)  # .scaling_dumps there
    return script


def _argv(argv, *dumps):
    """A queue entry's argv, resolved (the port's callables take the dumps
    directory, the script's nothing)."""
    return list(argv(*dumps) if callable(argv) else argv)


@pytest.mark.parametrize("dumped", [False, True])
def test_evidence_queue_is_the_scripts(evidence_script, tmp_path, dumped):
    """The port's queue has the script's step names in its order, its
    timeouts, and each step runs the script's mode with the script's
    options; scale5m and scale10m gain --load-index where a dump of the
    script's name is in the dumps directory, resolved at run time."""
    dumps = tmp_path / ".scaling_dumps"
    if dumped:
        for name in ("5m_int4_f4096", "10m_int4_f1024"):
            (dumps / name).mkdir(parents=True)
            (dumps / name / "meta.json").write_text("{}")
    want = evidence_script.QUEUE
    assert [(n, t) for n, t, _ in evidence.QUEUE] == [(n, t)
                                                      for n, t, _ in want]
    assert len(want) == 17
    for (name, _, argv), (_, _, script_argv) in zip(evidence.QUEUE, want):
        got, ref = _argv(argv, dumps), _argv(script_argv)
        assert got[0] == ref[0] == sys.executable
        if name == "probe":
            assert got[1] == "-c"
            continue
        assert got[1:4] == ["-m", "osr_tpu_torch.bench",
                            SCRIPT_MODE[ref[1]]], name
        assert got[4:] == ref[2:], name
        assert ("--load-index" in got) is (dumped and name.startswith(
            "scale")), name


def test_every_step_parses_in_its_mode(monkeypatch):
    """Each step's options are accepted by its mode's own parser (parsed,
    not run)."""
    import importlib

    class Parsed(Exception):
        pass

    inner = argparse.ArgumentParser.parse_args

    def parse_only(self, args=None, namespace=None):
        raise Parsed(inner(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_only)
    dumps = Path("/nonexistent")
    for name, _, argv in evidence.QUEUE:
        argv = _argv(argv, dumps)
        if name == "probe":
            compile(argv[2], "<probe>", "exec")
            continue
        module = importlib.import_module(
            f"osr_tpu_torch.bench.{argv[3].replace('-', '_')}")
        with pytest.raises(Parsed) as parsed:
            module.main(argv[4:])
        ns = vars(parsed.value.args[0])
        if "--docs" in argv:
            assert ns["docs"] == int(argv[argv.index("--docs") + 1]), name


def _py(code):
    return [sys.executable, "-c", code]


def _row(obj):
    return _py(f"print({json.dumps(json.dumps(obj))})")


@pytest.fixture
def card(monkeypatch):
    """main() as on a machine with a card (its line, not nvidia-smi's)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(evidence, "device_name", lambda dev: "test card")


def test_evidence_runner_records_and_goes_on(tmp_path, monkeypatch, card,
                                             capsys):
    """A step past its timeout is recorded as "timeout" (the processes it
    started killed with it) and the queue continues; a failing step is
    recorded and the exit code is 1; launches are summed over the last
    rows; logs appear under --out."""
    pid_file = tmp_path / "grandchild.pid"
    straggler = (
        "import subprocess, sys, time\n"
        "p = subprocess.Popen([sys.executable, '-c', "
        "'import time; time.sleep(60)'])\n"
        f"open({str(pid_file)!r}, 'w').write(str(p.pid))\n"
        "time.sleep(60)\n"
    )
    queue = (
        ("first", 30, _row({"kernel_launches": {"k": 2}})),
        ("slow", 2, _py(straggler)),
        ("bad", 30, _py("import sys; print('{\"kernel_launches\": "
                        "{\"k\": 1, \"j\": 3}}'); sys.exit(3)")),
        ("last", 30, _row({"x": 1})),
    )
    monkeypatch.setattr(evidence, "QUEUE", queue)
    out = tmp_path / "logs"
    t0 = time.time()
    rc = evidence.main(["--out", str(out)])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 1 and time.time() - t0 < 25
    steps = summary["steps"]
    assert list(steps) == ["first", "slow", "bad", "last"]
    assert [s["rc"] for s in steps.values()] == [0, "timeout", 3, 0]
    assert summary["failed"] == ["slow", "bad"] and not summary["aborted"]
    assert summary["kernel_launches"] == {"k": 3, "j": 3}
    assert steps["last"]["last_row"] == {"x": 1}
    assert steps["slow"]["last_row"] is None
    assert summary["device"] == "test card"
    for name, step in steps.items():
        assert step["log"] == str(out / f"evidence_{name}.log")
        assert Path(step["log"]).is_file()
    pid = int(pid_file.read_text())
    for _ in range(50):
        try:
            state = Path(f"/proc/{pid}/stat").read_text().split()[2]
        except FileNotFoundError:
            break
        if state == "Z":
            break
        time.sleep(0.1)
    else:
        pytest.fail(f"the timed-out step's child {pid} still runs")


def test_evidence_probe_failure_aborts(tmp_path, monkeypatch, card, capsys):
    """A failing probe stops the queue; the summary says so and the exit
    code is 1; without --out no log is kept."""
    queue = (("probe", 30, _py("import sys; sys.exit(1)")),
             ("after", 30, _row({})))
    monkeypatch.setattr(evidence, "QUEUE", queue)
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before = _stamps("bench_results/*evidence*")
    rc = evidence.main([])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 1 and summary["aborted"] is True
    assert list(summary["steps"]) == ["probe"]
    assert summary["steps"]["probe"]["log"] is None
    assert list(cwd.iterdir()) == []
    assert _stamps("bench_results/*evidence*") == before


@pytest.mark.parametrize("args, ran", [
    (["--only", "b,c"], ["b", "c"]),
    (["--skip", "a,c"], ["b", "dumped"]),
    (["--only", "a,dumped", "--skip", "a"], ["dumped"]),
])
def test_evidence_only_and_skip(args, ran, tmp_path, monkeypatch, card,
                                capsys):
    """--only and --skip filter the steps, which keep the queue's order;
    a callable argv is resolved when its step starts, over --dumps; all
    steps passing, the exit code is 0."""
    dumps = tmp_path / "dumps"
    queue = (
        ("a", 30, _row({})),
        ("b", 30, _py(f"import os; os.makedirs({str(dumps / 'x')!r}); "
                      f"open({str(dumps / 'x' / 'meta.json')!r}, 'w')")),
        ("c", 30, _row({})),
        ("dumped", 30, lambda d: _py(
            "import json, sys; print(json.dumps({'argv': sys.argv[1:]}))")
         + evidence.load_if_dumped(d, "x")),
    )
    monkeypatch.setattr(evidence, "QUEUE", queue)
    rc = evidence.main(args + ["--dumps", str(dumps)])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and list(summary["steps"]) == ran
    if "dumped" in ran:
        want = (["--load-index", str(dumps / "x")] if "b" in ran else [])
        assert summary["steps"]["dumped"]["last_row"] == {"argv": want}


def test_evidence_refuses_an_unknown_step(card, capsys):
    with pytest.raises(SystemExit) as exc:
        evidence.main(["--only", "probe,nosuch"])
    assert exc.value.code == 2
    assert "nosuch" in capsys.readouterr().err


# ----------------------------------------------------------------------
# without a card
# ----------------------------------------------------------------------


@pytest.mark.parametrize("mode, module", [
    ("pipeline-87k", pipeline_87k), ("evidence", evidence),
])
def test_mode_without_a_card_prints_no_value(mode, module):
    """pipeline-87k and evidence print the JSON line with no value and the
    reason and exit 1 without a CUDA device."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "osr_tpu_torch.bench", mode], cwd=REPO,
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert res.returncode == 1, res.stderr
    line = json.loads(res.stdout.splitlines()[-1])
    assert line == {"metric": module.METRIC, "value": None,
                    "unit": "queries/s", "error": common.NO_CARD}


def test_storage_runs_without_a_card(tmp_path):
    """storage is host work: without a CUDA device it runs and names the
    CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "osr_tpu_torch.bench", "storage", "--docs",
         "40", "--ref-docs", "100", "--roots", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env,
    )
    assert res.returncode == 0, res.stderr
    row = json.loads(res.stdout.splitlines()[-1])
    assert row["device"] == "cpu" and row["metric"] == storage.METRIC
    assert all(r["passed"] for r in row["synthetic"].values())


def test_modes_keep_their_scripts_row_keys():
    """storage keeps every key of the script's result and of its anchor
    (read from tools/bench_storage.py with ast)."""
    tree = ast.parse((REPO / "tools" / "bench_storage.py").read_text())
    keys = {
        node.value for d in ast.walk(tree) if isinstance(d, ast.Dict)
        for node in d.keys if isinstance(node, ast.Constant)
    } | {
        t.slice.value for t in ast.walk(tree)
        if isinstance(t, ast.Subscript) and isinstance(t.ctx, ast.Store)
        and isinstance(t.slice, ast.Constant)
    }
    anchor = {k for k in keys if k.startswith(("ref_", "osr_"))}
    assert anchor == set(storage.OSR_KEYS) | set(storage.REF_KEYS)
    top = {"synthetic", "real", "codec_comparison", "same_host_anchor",
           "note"}
    assert top <= keys and top <= set(storage.KEYS)
    codec = {k for k in keys if k.startswith(("zlib_", "zstd_"))}
    assert codec == set(storage.CODECS) | set(storage.UNIQUE_ROWS)
