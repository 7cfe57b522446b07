"""sparse_qps.host: every query the window completed over the window's seconds
(the last call's completion included). The host paces it, and its runs
spread wider than a bound can hold, so it is a per-layer metric."""


def read(record):
    w = record["window"]
    return w["completed"] / w["elapsed_s"]
