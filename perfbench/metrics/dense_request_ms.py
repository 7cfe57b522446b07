"""dense_request_ms: the window's milliseconds over the requests it
completed. One client waits for each reply before it asks again, so this
is the mean latency of a request, read over the whole window."""


def read(record):
    w = record["window"]
    return 1e3 * w["elapsed_s"] / w["completed"] if w["completed"] else None
