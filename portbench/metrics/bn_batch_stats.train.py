"""Branches and hand kernels: BatchNorm layers a step that normalize with
the batch's statistics and move the running ones, over the traced steps:
the program's counter ``bn.batch_stats`` (``models/deepgaitv2.py``,
``ugaitnet_tpu_torch/obsv/spans.py``) over its ``train.step`` spans.
25.0 for DeepGaitV2-3D (1 + 2 + 9 + 9 + 3 + 1); no reading where the
program has no such counter."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    try:
        from ugaitnet_tpu_torch.obsv.spans import snapshot
    except ImportError:          # a program without the span registry
        return None
    snap = snapshot()
    steps = sum(s["name"] == "train.step" for s in snap["spans"])
    if not steps or "bn.batch_stats" not in snap["counters"]:
        return None
    return snap["counters"]["bn.batch_stats"] / steps
