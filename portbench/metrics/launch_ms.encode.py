"""Eval encode: the host's ms a batch from the end of its gather to its
``.cpu()`` (the copy to the card, preprocess and the forward enqueued)
over the traced encode pass: the program's ``encode.launch`` spans
(``ugaitnet_tpu_torch/obsv/spans.py``) over its batches (their distinct
ids)."""


def read(rec):
    if rec.get("kind") != "encode":
        return None
    try:
        from ugaitnet_tpu_torch.obsv.spans import snapshot
    except ImportError:          # a program without the span registry
        return None
    spans = [s for s in snapshot()["spans"] if s["name"] == "encode.launch"]
    if not spans:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in spans) / len(
        {s["id"] for s in spans})
