"""Eval encode: the host's ms a pass in ``encode_dataset``'s end (the
concatenation of every batch's codes and their labels, ids and cameras)
over the traced passes: the program's ``encode.collect`` spans
(``ugaitnet_tpu_torch/obsv/spans.py``), one a pass."""


def read(rec):
    if rec.get("kind") != "encode":
        return None
    try:
        from ugaitnet_tpu_torch.obsv.spans import snapshot
    except ImportError:          # a program without the span registry
        return None
    spans = [s for s in snapshot()["spans"] if s["name"] == "encode.collect"]
    if not spans:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in spans) / len(spans)
