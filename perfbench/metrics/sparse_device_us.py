"""sparse_device_us: the device's microseconds a query cost, over the whole
window: the union of every device operation's interval (kernels, copies,
fills) in a trace of the whole window, over the queries the window
completed. None where the trace did not cover the window or saw nothing."""


def read(record):
    t = record.get("trace")
    w = record["window"]
    if not t or not record.get("trace_is_window") or t["busy_s"] <= 0:
        return None
    if not w["completed"]:
        return None
    return 1e6 * t["busy_s"] / w["completed"]
