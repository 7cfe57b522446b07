"""The evidence queue: the card's pending measurements, each a mode of
``python -m osr_tpu_torch.bench`` in a process of its own (counterpart of
``tools/run_tpu_evidence.py``).

The script's 17 steps, under its names, in its order, with its timeouts:
``probe`` (the card answers: its name and power limit, or the queue
aborts), ``narrow`` (profile-narrow), ``headline``, ``hybrid``,
``hybrid_rrf``, ``sharded`` and ``sharded_x`` (sharded-overhead, standard
and extraction), ``encoder`` (dense-encoder), ``quality`` and
``quality_noisy`` (quality-at-scale), ``dense_scale`` (1M docs),
``warm1m``, ``narrow1m``, ``extract1m``, ``scale5m`` and ``scale10m``
(scaling, with the script's options) and ``quality_sampled``. ``scale5m``
and ``scale10m`` load their index from ``--dumps DIR`` (default
``.scaling_dumps`` under the checkout; read, never written) where a dump
of the script's name is there (``scaling --save-index``), resolved when
the step starts.

Each step runs from the checkout with its standard output and error in
one log: ``DIR/evidence_<step>.log`` under ``--out DIR``, else a temporary
directory removed after. A step that outlives its timeout is killed with
the processes it started and recorded as ``"timeout"``. The queue goes on
past a failed step, as the script does, but stops when ``probe`` fails.
``--only`` and ``--skip`` take comma-separated step names.

The last line is one JSON object: per step ``rc`` (an int, or
``"timeout"``), ``s`` (seconds), its log (under ``--out``) and
``last_row``, the last JSON line it printed or null; ``aborted``,
``failed``, ``kernel_launches`` summed over the steps' last rows, and
``device``. Exits 1 when any step that ran failed or timed out (the
script always exited 0: a queue that hides a failed step would hide a
fault). Without a card it prints the no-card line and exits 1.

Usage: python -m osr_tpu_torch.bench evidence [--only a,b] [--skip c]
       [--out DIR] [--dumps DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from osr_tpu_torch.bench.common import device_name, log, no_card

METRIC = "evidence_queue"
ROOT = Path(__file__).resolve().parents[2]
DUMPS = ROOT / ".scaling_dumps"
KEYS = ("metric", "steps", "aborted", "failed", "kernel_launches",
        "device")
PROBE = (  # fails without a card (torch raises) or with a wrong sum
    "import json, torch\n"
    "from osr_tpu_torch.bench.common import card_line\n"
    "x = torch.arange(1024, device='cuda', dtype=torch.float32)\n"
    "if float(x.sum()) != 1023 * 1024 / 2:\n"
    "    raise SystemExit('the card summed 0..1023 wrong')\n"
    "print(json.dumps({'device': card_line(), "
    "'count': torch.cuda.device_count()}))\n"
)
Argv = Union[Sequence[str], Callable[[Path], Sequence[str]]]


def mode(*args: str) -> List[str]:
    return [sys.executable, "-m", "osr_tpu_torch.bench", *args]


def load_if_dumped(dumps: Path, name: str) -> List[str]:
    d = Path(dumps) / name
    return ["--load-index", str(d)] if (d / "meta.json").exists() else []


QUEUE: Tuple[Tuple[str, int, Argv], ...] = (
    # (step, timeout in seconds, argv or a function of the dumps directory)
    ("probe", 300, [sys.executable, "-c", PROBE]),
    ("narrow", 2400, mode("profile-narrow")),
    ("headline", 3600, mode("headline")),
    ("hybrid", 2400, mode("hybrid")),
    ("hybrid_rrf", 2400, mode("hybrid", "--fusion", "rrf")),
    ("sharded", 3000, mode("sharded-overhead")),
    ("sharded_x", 3000, mode("sharded-overhead", "--narrow-m", "8",
                             "--narrow-backend", "extract")),
    ("encoder", 3000, mode("dense-encoder")),
    ("quality", 3600, mode("quality-at-scale", "--dense-hashing")),
    ("quality_noisy", 3600, mode("quality-at-scale", "--query-mode", "noisy",
                                 "--f32-control", "--dense-hashing")),
    ("dense_scale", 3600, mode("dense-scale", "--docs", "1000000")),
    ("warm1m", 3600, mode("scaling", "--docs", "1000000", "--head-dtype",
                          "int8", "--note", "warm-decomposed")),
    ("narrow1m", 3600, mode("scaling", "--docs", "1000000", "--head-dtype",
                            "int8", "--narrow-m", "8",
                            "--note", "narrowed-selection-1M")),
    ("extract1m", 3600, mode("scaling", "--docs", "1000000", "--head-dtype",
                             "int8", "--narrow-m", "8",
                             "--narrow-backend", "extract",
                             "--note", "chunked-extract-1M")),
    ("scale5m", 7200, lambda dumps: mode(
        "scaling", "--docs", "5000000", "--head-dtype", "int4",
        "--head-cap", "4096", "--head-budget-gib", "11",
        "--note", "head-width-cure-at-5M-autochunk",
    ) + load_if_dumped(dumps, "5m_int4_f4096")),
    ("scale10m", 10800, lambda dumps: mode(
        "scaling", "--docs", "10000000", "--head-dtype", "int4",
        "--head-cap", "1024", "--score-chunk-rows", "500000",
        "--note", "10M-one-chip",
    ) + load_if_dumped(dumps, "10m_int4_f1024")),
    ("quality_sampled", 3600, mode("quality-at-scale", "--query-mode",
                                   "sample")),
)


def last_row(log_path: Path) -> Optional[Dict]:
    """The last JSON object line of a step's log, or None."""
    for line in reversed(log_path.read_text(errors="replace").splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def run_step(argv: Sequence[str], timeout: float,
             log_path: Path) -> Union[int, str]:
    """``argv`` from the checkout, its output in ``log_path``; its exit
    code, or "timeout" after killing it and every process it started."""
    with open(log_path, "w") as fh:
        proc = subprocess.Popen(
            list(argv), cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL, start_new_session=True,
        )
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return "timeout"
        finally:
            try:  # the step and whatever it started (spawned ranks)
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def run(
    queue: Sequence[Tuple[str, int, Argv]] = QUEUE,
    *,
    only: Sequence[str] = (),
    skip: Sequence[str] = (),
    out: Optional[str] = None,
    dumps=DUMPS,
    device="cuda",
) -> Dict[str, object]:
    """Runs the queue's steps (``only`` of them where given, less
    ``skip``); the summary, printed as one JSON line and returned.
    ``device`` names the card in the summary."""
    steps: Dict[str, Dict] = {}
    aborted = False
    with tempfile.TemporaryDirectory() as td:
        logdir = Path(out) if out else Path(td)
        logdir.mkdir(parents=True, exist_ok=True)
        for name, timeout, argv in queue:
            if (only and name not in only) or name in skip:
                continue
            if callable(argv):  # resolved when the step starts
                argv = argv(Path(dumps))
            log_path = logdir / f"evidence_{name}.log"
            shown = " ".join(argv[1:]).splitlines()[0][:160]
            log(f"== {name} (timeout {timeout}s): {shown}")
            t0 = time.time()
            rc = run_step(argv, timeout, log_path)
            seconds = round(time.time() - t0, 1)
            steps[name] = {"rc": rc, "s": seconds,
                           "log": str(log_path) if out else None,
                           "last_row": last_row(log_path)}
            log(f"   {name}: rc={rc} in {seconds}s")
            if name == "probe" and rc != 0:
                log("the card did not answer; aborting the queue")
                aborted = True
                break
    total: Dict[str, int] = {}
    for step in steps.values():
        counts = (step["last_row"] or {}).get("kernel_launches")
        if isinstance(counts, dict):
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    summary = {
        "metric": METRIC,
        "steps": steps,
        "aborted": aborted,
        "failed": [n for n, s in steps.items() if s["rc"] != 0],
        "kernel_launches": total,
        "device": device_name(torch.device(device)),
    }
    print(json.dumps(summary), flush=True)
    return summary


def step_names(text: str) -> List[str]:
    names = [n for n in text.split(",") if n]
    unknown = sorted(set(names) - {n for n, _, _ in QUEUE})
    if unknown:
        raise argparse.ArgumentTypeError(f"no such step: {unknown}")
    return names


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench evidence",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--only", type=step_names, default=[],
                    help="comma-separated steps to run (default: all)")
    ap.add_argument("--skip", type=step_names, default=[],
                    help="comma-separated steps to leave out")
    ap.add_argument("--out", default=None,
                    help="write each step's log to DIR/evidence_<step>.log")
    ap.add_argument("--dumps", default=str(DUMPS),
                    help="where scale5m and scale10m look for a saved "
                    "index (default: .scaling_dumps under the checkout)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return no_card(METRIC)
    # Terminated, the queue ends its running step (and what that started)
    # on the way out.
    previous = signal.signal(signal.SIGTERM, _terminated)
    try:
        summary = run(QUEUE, only=args.only, skip=args.skip, out=args.out,
                      dumps=args.dumps)
    finally:
        signal.signal(signal.SIGTERM, previous)
    return 1 if summary["aborted"] or summary["failed"] else 0


def _terminated(signum, frame):
    raise SystemExit(128 + signum)
