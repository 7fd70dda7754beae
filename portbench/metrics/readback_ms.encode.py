"""Eval encode: the host's ms a batch in ``.cpu()`` of the batch's codes
(its wait for the card, then the copy back) over the traced encode pass:
the program's ``encode.readback`` spans
(``ugaitnet_tpu_torch/obsv/spans.py``) over its batches (the distinct ids
of its ``encode.launch`` spans)."""


def read(rec):
    if rec.get("kind") != "encode":
        return None
    try:
        from ugaitnet_tpu_torch.obsv.spans import snapshot
    except ImportError:          # a program without the span registry
        return None
    spans = snapshot()["spans"]
    batches = {s["id"] for s in spans if s["name"] == "encode.launch"}
    if not batches:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in spans
                      if s["name"] == "encode.readback") / len(batches)
