"""device_idle_pct.dense: the share of the traced stretch in which no
device operation ran (100 x (1 - busy / stretch))."""

from perfbench.trace import idle_pct


def read(record):
    return idle_pct(record)
