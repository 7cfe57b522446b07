"""Importing the PyTorch port loads neither JAX nor osr_tpu."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PROBE = """
import sys
import osr_tpu_torch
from osr_tpu_torch.retrieval.engine import SparseSearchEngine
from osr_tpu_torch import SparseIndexBuilder, index_from_arrays
import osr_tpu_torch.ops.head, osr_tpu_torch.ops._build, osr_tpu_torch.native
import osr_tpu_torch.retrieval.registry, osr_tpu_torch.retrieval.service
import osr_tpu_torch.retrieval.fusion, osr_tpu_torch.encoders
import osr_tpu_torch.index.cache, osr_tpu_torch.index.learned
import osr_tpu_torch.storage
from osr_tpu_torch import (
    Document, DocumentStore, HashingEncoder, HybridRetriever,
    RetrievalService, RetrieverRegistry,
)
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "osr_tpu", "ml_dtypes")
    or m.startswith(("jax.", "jaxlib.", "osr_tpu."))
)
print("LOADED", bad)
"""


def test_port_imports_without_jax_or_osr_tpu():
    out = subprocess.run(
        [sys.executable, "-c", PROBE],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_package_import_is_lazy():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, osr_tpu_torch; "
         "print(sorted(m for m in sys.modules if m.startswith('osr_tpu_torch')))"],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['osr_tpu_torch']"


DENSE_PROBE = """
import sys
import chip_smoke
from osr_tpu_torch import DenseSearchEngine, dense_engine_from_arrays
import osr_tpu_torch.index.dense, osr_tpu_torch.ops.quantize
import osr_tpu_torch.ops.quantize_kernels, osr_tpu_torch.ops.matmul
import osr_tpu_torch.testing
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "osr_tpu", "ml_dtypes")
    or m.startswith(("jax.", "jaxlib.", "osr_tpu."))
)
print("LOADED", bad)
"""


def test_dense_modules_import_without_jax_or_osr_tpu():
    """The dense slice (index/dense.py, ops/quantize*.py, ops/matmul.py,
    the engine, convert.py) and chip_smoke.py load neither JAX nor
    osr_tpu."""
    out = subprocess.run(
        [sys.executable, "-c", DENSE_PROBE],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
