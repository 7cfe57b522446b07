"""k5_roofline: K5's least time at the cell's (B, N, D) by the frozen
``similarity_work`` count against the H100's int8 and HBM peaks, over its
mean device time per launch in the traced stretch."""

from perfbench.frozen.work import PEAK_INT8_OPS, roofline_pct, similarity_work
from perfbench.trace import K5, kernel


def read(record):
    n, secs = kernel(record, K5)
    if not n:
        return None
    s = record["shapes"]
    ops, nbytes = similarity_work(s["batch"], s["docs"], s["dim"])
    return roofline_pct(ops, nbytes, PEAK_INT8_OPS, secs / n)
