"""Tiny CPU runs of every cell through the harness: a sound run is
correct; the configuration's lower-precision control, and the program
broken underneath in each way a cell can break, are not. The card's own
check (``main``) is skipped here: ``execute`` runs the rest of a run."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from perfbench import run
from perfbench.cell import ROOT, load_bench

CELLS = [w["name"] for w in load_bench()["workloads"]]
SEED = 2**33 + 17  # wider than 32 bits, as the driver's are
SECONDS = 1.0


def execute(cell, **kw):
    return run.execute(cell, SEED, SECONDS, False, device="cpu", **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    cell = tiny_cell(name)
    line = execute(cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    # the CPU has no device trace: the host clock's metrics alone read
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end
                                    if m["source"] == "host_clock"}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_cell, name):
    line = execute(tiny_cell(name), control=True)
    assert not line["correct"], line["checks"]


def test_traced_run_on_the_cpu_reads_no_device_metric(tiny_cell):
    cell = tiny_cell("fiqa-bm25.top1000")
    line = run.execute(cell, SEED, SECONDS, True, device="cpu")
    assert line["correct"]
    # no device events on the CPU: the host clock's metrics alone read
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer
                                    if m["source"] == "host_clock"}
    assert line["device"]["busy_s"] == 0.0
    assert line["breakdown"]["idle_gaps"]


# Faults planted in the program, each where its answers are produced.

def sparse_fault(kind):
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    orig, memo = SparseSearchEngine.search, {}

    def search(self, queries, top_k=10):
        res = orig(self, queries, top_k)
        if kind == "stale":  # the state the first call left, unchanged
            return memo.setdefault("first", res)
        keys = list(res)
        if kind == "half":  # the second half answered from the first
            h = len(keys) // 2
            for a, b in zip(keys[h:], keys[:h]):
                res[a] = res[b]
        if kind == "altered":  # each answer's last document replaced
            for q in keys:
                if res[q]:
                    last = list(res[q])[-1]
                    score = res[q].pop(last)
                    res[q][f"doc{(int(last[3:]) + 1) % 3000}"] = score
        return res

    return SparseSearchEngine, "search", search


def dense_batch_fault(kind):
    from osr_tpu_torch.retrieval.engine import DenseSearchEngine

    orig, memo = DenseSearchEngine.collect_vectors, {}

    def collect(self, handle):
        scores, rows = orig(self, handle)
        if kind == "stale":
            return memo.setdefault("first", (scores, rows))
        scores, rows = scores.copy(), rows.copy()
        h = len(rows) // 2
        if kind == "half":
            scores[h:], rows[h:] = scores[:len(rows) - h], rows[:len(rows) - h]
        if kind == "altered":
            rows[:, -1] = (rows[:, -1] + 1) % 20000
        return scores, rows

    return DenseSearchEngine, "collect_vectors", collect


def dense_request_fault(kind):
    from osr_tpu_torch.retrieval.engine import DenseSearchEngine

    orig, memo = DenseSearchEngine.search, {}

    def search(self, queries, top_k=10, min_score=0.0):
        res = orig(self, queries, top_k, min_score)
        (qid, answer), = res.items()
        if kind == "stale":
            return {qid: memo.setdefault("first", answer)}
        if kind == "half":  # every second request gets the one before's
            prev = memo.get("prev", answer)
            memo["prev"] = answer
            memo["n"] = memo.get("n", 0) + 1
            return {qid: prev if memo["n"] % 2 == 0 else answer}
        last = list(answer)[-1]
        score = answer.pop(last)
        answer[str((int(last) + 1) % 20000)] = score
        return {qid: answer}

    return DenseSearchEngine, "search", search


FAULTS = {"fiqa-bm25.top1000": sparse_fault,
          "nq-contriever-int8.batch": dense_batch_fault,
          "nq-contriever-int8.interactive": dense_request_fault}


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny_cell, monkeypatch, name, kind):
    cls, attr, broken = FAULTS[name](kind)
    cell = tiny_cell(name)
    monkeypatch.setattr(cls, attr, broken)
    line = execute(cell)
    assert not line["correct"], (kind, line["checks"])


def test_no_jax_after_a_run_of_each_driver():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from perfbench import run\n"
        "from perfbench.cell import Cell, load_bench\n"
        "from perfbench.tests.conftest import shrink\n"
        "for name in ('fiqa-bm25.top1000', 'nq-contriever-int8.batch',\n"
        "             'nq-contriever-int8.interactive'):\n"
        "    line = run.execute(shrink(Cell(load_bench(), name)), 5, 0.5,\n"
        "                       False, device='cpu')\n"
        "    assert line['correct'], line\n"
        "print(json.dumps(run.foreign_modules()))\n"
    )
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_harness_alone_gives_no_result(card, tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/ cannot run a
    cell: the program is missing."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card_is_not_correct(card, name):
    """The control at the cell's own size on the card (three seeds in the
    records; one here)."""
    from perfbench.cell import Cell

    cell = Cell(load_bench(), name)
    line = run.execute(cell, SEED, 5.0, False, control=True)
    assert not line["correct"], line["checks"]
    assert np.isfinite(line["checks"]["rank_gap"]["value"])
