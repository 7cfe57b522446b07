"""k2_roofline: K2's least time at the cell's (B, R, F) by the frozen
``head_work`` count (scores and block maxima) against the H100's bf16 and
HBM peaks, over its mean device time per launch in the traced stretch."""

from perfbench.frozen.work import PEAK_BF16_FLOPS, head_work, roofline_pct
from perfbench.kernel_names import K2
from perfbench.trace import kernel


def read(record):
    n, secs = kernel(record, K2)
    if not n:
        return None
    s = record["shapes"]
    ops, nbytes = head_work(s["batch"], s["rows"], s["head_width"],
                            s["head_bytes"], blockmax=True)
    return roofline_pct(ops, nbytes, PEAK_BF16_FLOPS, secs / n)
