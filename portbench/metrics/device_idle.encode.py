"""The device's idle share of the traced slice of a encode cell, in %:
1 - (union of kernel, memcpy and memset intervals) / slice."""


def read(rec):
    tr = rec.get("trace") or {}
    if rec.get("kind") != "encode" or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
