"""The whole train step's share of the card's peak: the analytic forward +
backward FLOPs of every step of the window (``flops.py``) over the window,
over the peak of the configuration's precision, in %."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("window_s"):
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / rec["peak_flops"]
