"""Input pipeline: the device's idle ms a training step while the host is
inside ``next()`` on the ``PrefetchLoader`` (the "pb.input_wait" range of
the traced slice), over the traced steps.  The host's own time there is
no measure of the input path: its copies wait for the step before on the
card, so it holds the whole step; only the idle device is its cost."""


def read(rec):
    tr = rec.get("trace") or {}
    calls = tr.get("ranges", {}).get("pb.input_wait", (0, 0.0))[0]
    if rec.get("kind") != "train" or not calls:
        return None
    return 1e3 * tr["idle_by_range"].get("pb.input_wait", 0.0) / calls
