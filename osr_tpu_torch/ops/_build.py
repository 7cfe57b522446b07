"""Build and bind the hand-written code of ``osr_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles on first use, with ``nvcc`` for
``sm_90a`` (Hopper), into its own shared library with a plain C
interface under ``build/osr_tpu_torch/`` at the repository root, and is
loaded with ctypes. Pointers and the CUDA stream cross the boundary as
``c_void_p``. ``csrc/host_runtime.cc``, the C++ host runtime that
``osr_tpu_torch/native.py`` binds, compiles there too, with ``$CXX`` (or
``g++``) for the host's own CPU; it needs no CUDA toolkit, so the CPU
path builds it as well. Libraries are named by a hash of their source,
the shared headers (``csrc/*.cuh``, for the kernels), the compiler and
the flags, so an edited source, header or flag rebuilds. Sources build in
parallel: one compiler process per file, all started together. Nothing is
built when the module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "osr_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
HOST_SOURCE = CSRC / "host_runtime.cc"
# -ffp-contract=off: GCC contracts a*b+c into an FMA by default, which
# rounds differently from NumPy's separate operations; the runtime's
# results are bit-identical to its NumPy twins only without it.
HOST_FLAGS = (
    "-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-fPIC",
    "-shared", "-fvisibility=hidden",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build with the CUDA toolkit "
        "(PATH or /usr/local/cuda/bin)"
    )


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def host_target() -> Path:
    """Where the host runtime's library for this source, compiler and set
    of flags lives (it may not be built yet)."""
    h = hashlib.sha256(HOST_SOURCE.read_bytes())
    h.update(" ".join((_cxx(), *HOST_FLAGS)).encode())
    return BUILD_DIR / f"lib{HOST_SOURCE.stem}-{h.hexdigest()[:12]}.so"


def _host_job() -> Tuple[Path, Path, List[str]]:
    return HOST_SOURCE, host_target(), [_cxx(), *HOST_FLAGS]


def _compile(jobs: Sequence[Tuple[Path, Path, List[str]]]) -> None:
    """Run every (source, library, compiler and flags) job at once; each
    compiler writes a temporary file that replaces the library when it
    succeeds. Raises RuntimeError with each failed compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, failed = [], []
    for src, out, compiler in jobs:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [*compiler, "-o", str(tmp), str(src)]
        try:
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            )
        except OSError as e:
            failed.append(f"{src.name}: cannot run {cmd[0]}: {e}")
            continue
        procs.append((src, out, tmp, cmd[0], proc))
    for src, out, tmp, compiler, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(
                f"{src.name} ({compiler}, exit {proc.returncode}):\n"
                f"{log.decode(errors='replace')}"
            )
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("compile failed for " + "\n".join(failed))


def build_host() -> Path:
    """The host runtime's library, compiled first if it is not built yet
    (one compiler for all processes that ask at once: the others wait on
    a file lock). Raises RuntimeError with the compiler's output when the
    compile fails."""
    out = host_target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{HOST_SOURCE.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            _compile([_host_job()])
    return out


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "head_wgmma":
        lib.osr_head_i8_scores.restype = ci
        lib.osr_head_i8_scores.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        for dtype in ("i8", "i4"):
            blockmax = getattr(lib, f"osr_head_{dtype}_blockmax")
            blockmax.restype = ci
            blockmax.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
            blocktopm = getattr(lib, f"osr_head_{dtype}_blocktopm")
            blocktopm.restype = ci
            blocktopm.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.osr_head_wgmma_smem_bytes.restype = ci
        lib.osr_head_wgmma_smem_bytes.argtypes = [ci]
    elif name == "similarity_wgmma":
        for entry in (lib.osr_similarity_i8, lib.osr_similarity_i4):
            entry.restype = ci
            entry.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        for entry in (lib.osr_similarity_i8_blockmax,
                      lib.osr_similarity_i4_blockmax):
            entry.restype = ci
            entry.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.osr_similarity_wgmma_smem_bytes.restype = ci
        lib.osr_similarity_wgmma_smem_bytes.argtypes = [ci]
    elif name == "quantize":
        lib.osr_quantize_symmetric.restype = ci
        lib.osr_quantize_symmetric.argtypes = [
            vp, vp, vp, ci, ci, ci, ctypes.c_uint, vp,
        ]
        lib.osr_dequantize_symmetric.restype = ci
        lib.osr_dequantize_symmetric.argtypes = [vp, vp, vp, ci, ci, vp]
    elif name == "topk_select":
        lib.osr_topk_select.restype = ci
        lib.osr_topk_select.argtypes = [
            vp, vp, vp, ci, ci, ctypes.c_longlong, ci, ci, vp,
        ]
        lib.osr_topk_select_max_k.restype = ci
        lib.osr_topk_select_max_k.argtypes = []
    lib.osr_cuda_error_string.restype = ctypes.c_char_p
    lib.osr_cuda_error_string.argtypes = [ci]
    return lib


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, and the
    host runtime if it has none (one compiler process per source, run
    concurrently), and load the kernel libraries."""
    with _lock:
        sources = sorted(CSRC.glob("*.cu"))
        jobs = [
            (src, _target(src), [_nvcc(), *NVCC_FLAGS])
            for src in sources
            if not _target(src).exists()
        ]
        if not host_target().exists():
            jobs.append(_host_job())
        if jobs:
            _compile(jobs)
        for src in sources:
            if src.stem not in _libs:
                _libs[src.stem] = _bind(
                    src.stem, ctypes.CDLL(str(_target(src)))
                )
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.osr_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
