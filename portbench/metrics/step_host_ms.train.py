"""Train step: the host's ms a step to enqueue the forward, losses,
backward and update (``make_train_step``'s step) over the traced steps:
the program's ``train.step`` spans (``ugaitnet_tpu_torch/obsv/spans.py``).
Near the step's own time, the launch queue is full and the card holds
the host back."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    try:
        from ugaitnet_tpu_torch.obsv.spans import snapshot
    except ImportError:          # a program without the span registry
        return None
    spans = [s for s in snapshot()["spans"] if s["name"] == "train.step"]
    if not spans:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in spans) / len(spans)
