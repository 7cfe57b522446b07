"""Traffic drivers. A traffic file names one (``"driver"``); the module of
that name here has a ``Driver(config, traffic, seed, device, control)``
whose construction is the set-up (inputs made from the seed, the program
built and warmed on the cell's own shapes), and whose methods are
``shapes()`` (the launch shapes the per-layer readers count with, from
the configuration and the traffic alone), ``window(seconds, tracer)``
(the measured loop; returns the window record), ``release()`` (drops the
program's state) and ``numbers()`` (the compared numbers, from the plain
reference, after the release)."""

from __future__ import annotations

import importlib
import sys
import time


def load(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}").Driver


class Laps:
    """Logs the seconds of each step of a set-up to standard error."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, step: str) -> None:
        now = time.perf_counter()
        print(f"# set-up: {step} {now - self.t:.3f} s", file=sys.stderr,
              flush=True)
        self.t = now
