"""Input pipeline: the moves a step from pageable host memory to the card
(each holds the host until the card has drained the stream) over the
traced steps: the program's counter ``input.pageable_copies``
(``ugaitnet_tpu_torch/obsv/spans.py``) over its ``train.step`` spans."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    try:
        from ugaitnet_tpu_torch.obsv.spans import snapshot
    except ImportError:          # a program without the span registry
        return None
    snap = snapshot()
    steps = sum(s["name"] == "train.step" for s in snap["spans"])
    if not steps:
        return None
    return snap["counters"].get("input.pageable_copies", 0) / steps
