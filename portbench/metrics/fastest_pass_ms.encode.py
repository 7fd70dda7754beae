"""Eval encode: the fastest whole pass of ``encode_dataset`` over the data
set in the window, in ms of the host clock.  Passes slow down by several
percent in episodes of seconds that the host's other load brings, and
the fastest pass is the one least touched by them: a steadier statistic
beside ``encode_clips_per_s``, which takes every pass."""


def read(rec):
    passes = rec.get("spans", {}).get("encode_pass")
    if rec.get("kind") != "encode" or not passes:
        return None
    return 1e3 * min(passes)
