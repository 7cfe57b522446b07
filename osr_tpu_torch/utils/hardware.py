"""Hardware detection, CUDA-first (counterpart of
``osr_tpu/utils/hardware.py``).

The reference detects CPU SIMD flags / core counts / RAM to pick batch
sizes and enable Numba (reference tests/hardware_detection.py,
evaluate_rag_pipeline.py:39-53). Here the report names the CUDA cards
(platform ``gpu``, device name, count, memory) plus host CPU/RAM, and
derives the same adaptive knobs (query batch size, cache enablement) from
it. Without a card the platform is ``cpu``, with the host as its one
device.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch


def detect_hardware_capabilities() -> Dict[str, Any]:
    caps: Dict[str, Any] = {
        "cores": os.cpu_count() or 1,
        "threads": os.cpu_count() or 1,
        "memory_gb": 8,
        "platform": "cpu",
        "num_devices": 1,
        "device_kind": "cpu",
        "hbm_gb": 0.0,
    }
    try:
        import psutil

        caps["cores"] = psutil.cpu_count(logical=False) or caps["cores"]
        caps["threads"] = psutil.cpu_count(logical=True) or caps["threads"]
        caps["memory_gb"] = psutil.virtual_memory().total // 2**30
    except ImportError:  # pragma: no cover - psutil is optional
        pass
    if torch.cuda.is_available():
        caps["platform"] = "gpu"
        caps["num_devices"] = torch.cuda.device_count()
        caps["device_kind"] = torch.cuda.get_device_name(0)
        total = torch.cuda.get_device_properties(0).total_memory
        caps["hbm_gb"] = round(total / 2**30, 1)
    return caps


def recommended_batch_size(caps: Dict[str, Any] | None = None) -> int:
    """Adaptive query batch size (the reference scales batches by host RAM,
    evaluate_rag_pipeline.py:322; on a card the device count matters
    more)."""
    caps = caps or detect_hardware_capabilities()
    if caps.get("platform") == "gpu":
        return 128 * max(1, caps.get("num_devices", 1))
    return int(min(64, max(8, caps.get("memory_gb", 8) * 2)))


def validate_backend(device=None) -> Dict[str, Any]:
    """Sanity-check the numeric backend (the analogue of the reference's
    validate_numpy_simd, reference tests/hardware_detection.py:32-79): run
    a small matmul/reduction on ``device`` (``cuda`` unless the caller
    names another) and compare against NumPy."""
    from osr_tpu_torch.retrieval.engine import _resolve_device

    dev = _resolve_device(device)
    rng = np.random.RandomState(0)
    a = rng.randn(64, 64).astype(np.float32)
    b = rng.randn(64, 64).astype(np.float32)
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got = (ta @ tb).cpu().numpy()
    want = a @ b
    max_err = float(np.abs(got - want).max())
    sum_err = float(abs(float(ta.sum()) - a.sum()))
    ok = max_err < 1e-3 and sum_err < 1e-2
    return {
        "ok": bool(ok),
        "matmul_max_abs_err": max_err,
        "reduction_abs_err": sum_err,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
    }


def get_optimization_recommendations(
    caps: Dict[str, Any] | None = None,
) -> Dict[str, str]:
    """Human-readable tuning hints (reference
    tests/hardware_detection.py:81-143 capability)."""
    caps = caps or detect_hardware_capabilities()
    recs: Dict[str, str] = {}
    if caps.get("platform") == "gpu":
        recs["scoring"] = (
            f"CUDA card detected ({caps.get('device_kind')}): the head and "
            "dense kernels run on it; prefer batch sizes >= "
            f"{recommended_batch_size(caps)} to amortize dispatch."
        )
    else:
        recs["scoring"] = (
            "No CUDA card detected: pass device='cpu' to run the plain "
            "PyTorch versions of the kernels; expect reduced throughput."
        )
    if caps.get("memory_gb", 0) <= 4:
        recs["memory"] = "Low host RAM: disable index caching (cache_matrices=False)."
    return recs
