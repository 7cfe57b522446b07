"""head_roofline.msmarco: the head kernel's share of its roofline over a
whole window of row-chunked batches. The least time of one batch's head
product by the frozen ``head_work`` count at the cell's (B, R, F), with
the block maxima where K2 ran and without where K1 ran (the chunks'
products sum to the whole head's, so no chunk size enters the count),
times the window's batches (``counters.batches``), over the seconds of
every K1 and K2 launch in the trace of the whole window. None without a
trace of the window, the counters or a head launch."""

from perfbench.frozen.work import PEAK_BF16_FLOPS, head_work, roofline_pct
from perfbench.kernel_names import K2
from perfbench.trace import K1, kernel


def read(record):
    if not record.get("trace_is_window"):
        return None
    batches = (record["window"].get("counters") or {}).get("batches")
    n1, s1 = kernel(record, K1)
    n2, s2 = kernel(record, K2)
    if not batches or not (n1 or n2):
        return None
    s = record["shapes"]
    ops, nbytes = head_work(s["batch"], s["rows"], s["head_width"],
                            s["head_bytes"], blockmax=n2 >= n1)
    return roofline_pct(ops, nbytes, PEAK_BF16_FLOPS, (s1 + s2) / batches)
