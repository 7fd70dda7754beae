"""Input pipeline: the host's ms a step waiting in ``PrefetchLoader`` for
its producer thread's next gathered batch, over the traced steps: the
program's ``input.queue_wait`` spans
(``ugaitnet_tpu_torch/obsv/spans.py``) over its ``train.step`` spans."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    try:
        from ugaitnet_tpu_torch.obsv.spans import snapshot
    except ImportError:          # a program without the span registry
        return None
    spans = snapshot()["spans"]
    steps = sum(s["name"] == "train.step" for s in spans)
    if not steps:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in spans
                      if s["name"] == "input.queue_wait") / steps
