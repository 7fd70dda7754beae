"""Input pipeline: the host's ms a batch in ``GaitPipeline.gather`` (the
native gather into page-locked buffers, their allocation included) over
the traced encode pass: the program's ``input.gather`` spans
(``ugaitnet_tpu_torch/obsv/spans.py``) over its batches (the distinct
ids of its ``encode.launch`` spans)."""


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
                      if s["name"] == "input.gather") / len(batches)
