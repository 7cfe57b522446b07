"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (inputs from the seed, the program built and warmed on the cell's
own shapes) is timed as ``setup_s``; then the window runs for
``--seconds``; then the program's state is freed and the plain reference
judges the answers the window produced. With ``--trace 0`` the line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a ``torch.profiler`` stretch inside the window (the
whole window, in both modes, where an end-to-end metric of the cell is
read from the device's trace). The
last line of standard output is one JSON object; the compared numbers and
their limits close standard error and the line (``checks``).

``--control`` runs the program's lower-precision path that the
configuration names (its ``control`` entry): the check must then fail.
The benchmark's own runs never pass it.

Exits 2 without a result when there is no CUDA card or fewer than the
cell asks for, and 3 when JAX, ``jaxlib``, ``flax`` or ``osr_tpu`` was
loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FOREIGN = ("jax", "jaxlib", "flax", "osr_tpu")


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def foreign_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def execute(cell, seed: int, seconds: float, trace: bool, device="cuda",
            control: bool = False, t_start: float = None):
    """Set up, run the window, judge it; returns the result line as a
    dict. The tests call this on the CPU at small sizes."""
    import torch

    from perfbench import compare, drivers
    from perfbench import trace as tr
    from perfbench.cell import read_metrics

    dev = torch.device(device)
    t_start = time.perf_counter() if t_start is None else t_start
    driver = drivers.load(cell.traffic["driver"])(
        cell.config, cell.traffic, seed, dev, control)
    # An end-to-end metric read from the device's trace needs the whole
    # window traced, in both modes; else a traced run traces a stretch.
    whole = any(m["source"] == "device_trace" for m in cell.end_to_end)
    if whole:
        tracer = tr.Tracer(True, 0.0, float(seconds), dev)
    else:
        stretch = cell.traffic.get("trace", {})
        tracer = tr.Tracer(
            trace, min(stretch.get("start_s", 2.0), 0.2 * seconds),
            min(stretch.get("length_s", 3.0), 0.5 * seconds), dev)
    tracer.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    window = driver.window(seconds, tracer)
    log(f"window {window}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    driver.release()
    t0 = time.perf_counter()
    numbers = driver.numbers()
    numbers["failed"] = float(window["failed"])
    log(f"reference check of {driver.checked} answers in "
        f"{time.perf_counter() - t0:.1f} s")
    limits = {**cell.config["limits"], **cell.traffic.get("limits", {})}
    correct, checks = compare.verdict(numbers, limits)
    record = {"setup_s": setup_s, "window": window,
              "shapes": driver.shapes(), "trace": tracer.summary(),
              "trace_is_window": whole}
    if record["trace"] is not None:
        t = record["trace"]
        log(f"trace: {t['window_s']:.6f} s, device busy {t['busy_s']:.6f} s,"
            f" of it copies and fills {tr.kernel(record, tr.COPY)[1]:.6f} s")
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           record)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    line = {"correct": correct, "attempted": window["attempted"],
            "failed": window["failed"], "metrics": metrics,
            "device": device_info}
    if trace and record["trace"] is not None:
        t = record["trace"]
        device_info["busy_s"] = t["busy_s"]
        device_info["window_s"] = t["window_s"]
        line["breakdown"] = tr.breakdown(t)
        log(f"trace reduced in {t['reduce_s']:.1f} s; spans {t['spans']}")
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the configuration's lower-precision control")
    args = ap.parse_args(argv)

    from perfbench.cell import Cell, load_bench

    cell = Cell(load_bench(), args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    line = execute(cell, args.seed, args.seconds, bool(args.trace),
                   control=args.control, t_start=T_START)
    line["card"] = card_line()
    found = foreign_modules()
    if found:
        print(f"loaded into the process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    checks = line.pop("checks")
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
