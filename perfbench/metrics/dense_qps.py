"""dense_qps: every query the window completed over the window's seconds (the
last call's completion included)."""


def read(record):
    w = record["window"]
    return w["completed"] / w["elapsed_s"]
