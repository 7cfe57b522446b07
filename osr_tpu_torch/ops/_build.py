"""Build and bind the hand-written CUDA kernels of ``osr_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles on first use, with ``nvcc`` for
``sm_90a`` (Hopper), into its own shared library with a plain C
interface under ``build/osr_tpu_torch/`` at the repository root, and is
loaded with ctypes. Pointers and the CUDA stream cross the boundary as
``c_void_p``. Libraries are named by a hash of their source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds. Sources build in parallel: one ``nvcc`` per file, all started
together. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "osr_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


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
        lib.osr_similarity_wgmma_smem_bytes.restype = ci
        lib.osr_similarity_wgmma_smem_bytes.argtypes = [ci]
    elif name == "quantize":
        lib.osr_quantize_symmetric.restype = ci
        lib.osr_quantize_symmetric.argtypes = [
            vp, vp, vp, ci, ci, ci, ctypes.c_uint, vp,
        ]
        lib.osr_dequantize_symmetric.restype = ci
        lib.osr_dequantize_symmetric.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.osr_cuda_error_string.restype = ctypes.c_char_p
    lib.osr_cuda_error_string.argtypes = [ci]
    return lib


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library (one
    ``nvcc`` process per source, run concurrently) and load them all."""
    with _lock:
        sources = sorted(CSRC.glob("*.cu"))
        todo = [s for s in sources if not _target(s).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = []
            for src in todo:
                out = _target(src)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append(
                    (src, out, tmp, subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
                    ))
                )
            failed = []
            for src, out, tmp, proc in procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{src.name}:\n{log.decode(errors='replace')}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
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
