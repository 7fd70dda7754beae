"""Branches and hand kernels: launches a step of the hand weight-gradient
kernel of the 3D CNN's first conv (``ops/cuda/conv3d_wgrad.py``) over the
traced steps: the program's counter ``conv3d.wgrad_hand``
(``ugaitnet_tpu_torch/obsv/spans.py``), counted from autograd's backward
thread, over its ``train.step`` spans.  2 a step in the 3D CNN's cell (one
a branch); no reading where the program has no such counter."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    try:
        from ugaitnet_tpu_torch.obsv.spans import snapshot
    except ImportError:          # a program without the span registry
        return None
    snap = snapshot()
    steps = sum(s["name"] == "train.step" for s in snap["spans"])
    if not steps or "conv3d.wgrad_hand" not in snap["counters"]:
        return None
    return snap["counters"]["conv3d.wgrad_hand"] / steps
