"""The benchmark's CPU tests: ``pytest perfbench/tests`` from the
checkout's root. Tests that need the card are marked ``cuda`` and skip
without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def shrink(cell):
    """The cell at a size a test run holds on the CPU (the traffic's
    shape, the configuration's widths kept where the CPU allows)."""
    c = cell.config
    if c["name"].startswith("fiqa"):
        c["corpus"].update(num_docs=3000, vocab=12000)
        c["index"]["head_terms"] = 512
        c["engine"]["batch_sizes"] = [128]
        cell.traffic.update(queries_per_call=256, query_sets=2)
    else:
        c["corpus"].update(num_docs=20000, dim=64, block_rows=4096)
        c["queries"]["pool"] = 256
        if "batch" in cell.traffic:
            cell.traffic["batch"] = 64
    return cell


@pytest.fixture
def tiny_cell():
    from perfbench.cell import Cell, load_bench

    return lambda name: shrink(Cell(load_bench(), name))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
