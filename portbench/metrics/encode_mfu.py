"""The whole encode's share of the card's peak: the analytic forward FLOPs
of every clip the window encoded over the window, over the peak of the
cell's compute type, in %."""


def read(rec):
    if rec.get("kind") != "encode" or not rec.get("window_s"):
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / rec["peak_flops"]
