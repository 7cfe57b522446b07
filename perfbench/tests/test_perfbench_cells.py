"""Every cell of BENCHMARK.json resolves from its files, and the file keeps
to the rules of its format (names, units, bounds, what each cell
reports)."""

import json
import re

import pytest

from perfbench import cell as C

BENCH = C.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_from_its_files(name):
    cell = C.Cell(BENCH, name)
    assert cell.traffic["driver"]
    from perfbench import drivers

    assert drivers.load(cell.traffic["driver"])
    reported = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(C.reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in reported
    assert cell.config["limits"] and cell.config["control"]
    assert cell.chips == 1


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert entry["file"].startswith("perfbench/configs/")
    cfg = json.loads((C.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["assumed"]
