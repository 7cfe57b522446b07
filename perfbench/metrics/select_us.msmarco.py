"""select_us.msmarco: device microseconds a completed query of every
device operation but the head kernels (K1, K2) and copies and fills, over
a trace of the whole window: the chunks' selections and their merge, with
the query scatter beside them. None without a trace of the window."""

from perfbench.kernel_names import K2
from perfbench.trace import COPY, K1


def read(record):
    t = record.get("trace")
    done = record["window"]["completed"]
    if not t or not record.get("trace_is_window") or not done:
        return None
    secs = sum(v[1] for name, v in t["ops"].items()
               if not (K1.search(name) or K2.search(name)
                       or COPY.search(name)))
    return 1e6 * secs / done if secs > 0 else None
