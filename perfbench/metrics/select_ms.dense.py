"""select_ms.dense: device milliseconds per batch of the dense step's
kernels other than K7 (the query quantizer) and K5 (the similarity): the
exact selection over the (B, N) scores. Copies and fills are left out;
the batches are the ``dispatch`` spans of the traced stretch."""

from perfbench.trace import COPY, K5, K7


def read(record):
    t = record.get("trace")
    batches = t["spans"].get("dispatch", 0) if t else 0
    if not batches:
        return None
    secs = sum(v[1] for name, v in t["ops"].items()
               if not (K5.search(name) or K7.search(name)
                       or COPY.search(name)))
    return 1e3 * secs / batches if secs > 0 else None
