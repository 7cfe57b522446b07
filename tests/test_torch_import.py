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


PIPELINE_PROBE = """
import sys
import osr_tpu_torch.pipeline, osr_tpu_torch.cli, osr_tpu_torch.__main__
import osr_tpu_torch.encoders, osr_tpu_torch.bert, osr_tpu_torch.convert
import osr_tpu_torch.readers, osr_tpu_torch.metrics, osr_tpu_torch.utils
import osr_tpu_torch.storage.loaders, osr_tpu_torch.testing
from osr_tpu_torch import (
    HFEncoder, ReaderRegistry, load_config, run_all_experiments,
)
from osr_tpu_torch.testing import build_standin_encoder, harvest_chunks
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "osr_tpu", "ml_dtypes", "transformers", "yaml")
    or m.startswith(("jax.", "jaxlib.", "osr_tpu.", "transformers."))
)
print("LOADED", bad)
"""


def test_pipeline_modules_import_without_jax_osr_tpu_or_transformers():
    """The pipeline, CLI, encoders, bert, readers, metrics and utils load
    neither JAX, osr_tpu, transformers nor PyYAML (load_config imports
    yaml when it reads a file)."""
    out = subprocess.run(
        [sys.executable, "-c", PIPELINE_PROBE],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


SURFACE_PROBE = """
import sys
import osr_tpu_torch, osr_tpu_torch.index, osr_tpu_torch.retrieval
import osr_tpu_torch.ops, osr_tpu_torch.benchmarks
print("LAZY", sorted(m for m in sys.modules if m.startswith("osr_tpu_torch")))
from osr_tpu_torch import tokenize, Tokenizer, __version__
from osr_tpu_torch.index import (
    tokenize, Tokenizer, SparseIndexBuilder, SparseIndex, HybridLayout,
    pack_flat, choose_head_terms, tail_candidates_flat, merge_host,
    dense_tail_scores,
)
from osr_tpu_torch.retrieval import (
    SparseSearchEngine, DenseSearchEngine, RetrieverRegistry,
    RetrievalService,
)
from osr_tpu_torch.ops import (
    block_topk, fast_topk, merge_topk, approx_topk_threshold,
)
from osr_tpu_torch.benchmarks import (
    BenchmarkResult, BenchmarkSuite, grade_performance, run_benchmark_suite,
    generate_report, IntegrationRunner,
)
import osr_tpu_torch.benchmarks.framework, osr_tpu_torch.benchmarks.suites
import osr_tpu_torch.benchmarks.integration, osr_tpu_torch.benchmarks.runner
import osr_tpu_torch.benchmarks.quality
import osr_tpu_torch.benchmarks.beir_adapter
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "osr_tpu", "ml_dtypes", "yaml", "transformers",
             "beir")
    or m.startswith(("jax.", "jaxlib.", "osr_tpu.", "yaml.", "beir."))
)
print("LOADED", bad)
"""


def test_surface_and_benchmarks_import_without_jax_osr_tpu_or_yaml():
    """The package exports of osr_tpu's import surface and the benchmark
    modules load neither JAX, osr_tpu, PyYAML, transformers nor beir; the
    package and its index, retrieval, ops and benchmarks subpackages load
    no submodule when imported."""
    out = subprocess.run(
        [sys.executable, "-c", SURFACE_PROBE],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    lazy = [ln for ln in out.stdout.splitlines() if ln.startswith("LAZY")]
    assert lazy == [
        "LAZY ['osr_tpu_torch', 'osr_tpu_torch.benchmarks', "
        "'osr_tpu_torch.index', 'osr_tpu_torch.ops', "
        "'osr_tpu_torch.retrieval']"
    ], out.stdout


SURFACES = {
    "osr_tpu": "osr_tpu_torch",
    "osr_tpu.index": "osr_tpu_torch.index",
    "osr_tpu.retrieval": "osr_tpu_torch.retrieval",
    "osr_tpu.benchmarks": "osr_tpu_torch.benchmarks",
    "osr_tpu.parallel": "osr_tpu_torch.parallel",
}


def test_every_osr_tpu_export_resolves_on_the_port():
    """Every name in __all__ of osr_tpu, osr_tpu.index, osr_tpu.retrieval,
    osr_tpu.benchmarks and osr_tpu.parallel resolves on the matching osr_tpu_torch package
    and stands in its __all__; the package version is osr_tpu's."""
    import importlib

    import pytest

    pytest.importorskip("jax")
    for ref_name, port_name in SURFACES.items():
        ref = importlib.import_module(ref_name)
        port = importlib.import_module(port_name)
        for name in ref.__all__:
            assert name in port.__all__, (port_name, name)
            value = getattr(port, name)
            assert value is not None, (port_name, name)
            if name != "__version__":
                assert getattr(value, "__name__", name) == name
    assert importlib.import_module("osr_tpu_torch").__version__ == (
        importlib.import_module("osr_tpu").__version__
    )


PARALLEL_PROBE = """
import sys
import osr_tpu_torch.parallel
print("LAZY", sorted(m for m in sys.modules if m.startswith("osr_tpu_torch")))
from osr_tpu_torch.parallel import (
    make_mesh, pick_mesh_shape, ShardedSparseSearchEngine,
    ShardedDenseSearchEngine, ShardedHybridEngine, sharded_search,
    sharded_search_extract,
)
import osr_tpu_torch.parallel.mesh, osr_tpu_torch.parallel.sharded
import torch.distributed as dist
print("GROUP", dist.is_available() and dist.is_initialized())
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "osr_tpu", "ml_dtypes")
    or m.startswith(("jax.", "jaxlib.", "osr_tpu."))
)
print("LOADED", bad)
"""


def test_parallel_imports_without_jax_osr_tpu_or_a_process_group():
    """osr_tpu_torch.parallel loads no submodule when imported, and its
    modules load neither JAX nor osr_tpu and start no process group."""
    out = subprocess.run(
        [sys.executable, "-c", PARALLEL_PROBE],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "LAZY ['osr_tpu_torch', 'osr_tpu_torch.parallel']" in lines, lines
    assert "GROUP False" in lines, lines
    assert "LOADED []" in lines, lines


BENCH_PROBE = """
import sys
import osr_tpu_torch.bench
print("LAZY", sorted(m for m in sys.modules if m.startswith("osr_tpu_torch")))
import osr_tpu_torch.bench.common, osr_tpu_torch.bench.headline
import osr_tpu_torch.bench.scaling, osr_tpu_torch.bench.hybrid
import osr_tpu_torch.bench.dense_scale, osr_tpu_torch.bench.__main__
import osr_tpu_torch.bench.batch_curve, osr_tpu_torch.bench.int4_quality
import osr_tpu_torch.bench.quality_at_scale, osr_tpu_torch.bench.fusion_sweep
import osr_tpu_torch.bench.dense_encoder
import osr_tpu_torch.bench.sharded_scale, osr_tpu_torch.bench.sharded_overhead
import osr_tpu_torch.bench.profile_trace, osr_tpu_torch.bench.profile_latency
import osr_tpu_torch.bench.profile_search
import osr_tpu_torch.bench.profile_stages_1m
import osr_tpu_torch.bench.profile_host_scale
import osr_tpu_torch.bench.profile_hybrid, osr_tpu_torch.bench.profile_device
import osr_tpu_torch.bench.profile_fused, osr_tpu_torch.bench.profile_narrow
import osr_tpu_torch.bench.profile_blocksel, osr_tpu_torch.bench.profile_topk2
import osr_tpu_torch.bench.profile_topk_fix
import osr_tpu_torch.bench.storage, osr_tpu_torch.bench.pipeline_87k
import osr_tpu_torch.bench.evidence
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "osr_tpu", "ml_dtypes", "transformers", "yaml")
    or m.startswith(("jax.", "jaxlib.", "osr_tpu.", "transformers.", "yaml."))
)
print("LOADED", bad)
"""


def test_bench_imports_without_jax_osr_tpu_transformers_or_yaml():
    """osr_tpu_torch.bench loads none of its modules when imported, and
    its modules load neither JAX, osr_tpu, transformers nor PyYAML."""
    out = subprocess.run(
        [sys.executable, "-c", BENCH_PROBE],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "LAZY ['osr_tpu_torch', 'osr_tpu_torch.bench']" in lines, lines
    assert "LOADED []" in lines, lines
