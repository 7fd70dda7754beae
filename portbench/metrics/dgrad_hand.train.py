"""Branches and hand kernels: launches a step of the hand input-gradient
kernel of the 3D CNN's strided convs (``ops/cuda/conv3d_dgrad.py``) over
the traced steps: the program's counter ``conv3d.dgrad_hand``
(``ugaitnet_tpu_torch/obsv/spans.py``), counted from autograd's backward
thread, over its ``train.step`` spans.  In the 3D CNN's cell, 2 a step for
each conv past conv0 that the kernel's shape rule takes (one a branch):
8.0 with conv1-conv4; no reading where the program has no such counter."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    try:
        from ugaitnet_tpu_torch.obsv.spans import snapshot
    except ImportError:          # a program without the span registry
        return None
    snap = snapshot()
    steps = sum(s["name"] == "train.step" for s in snap["spans"])
    if not steps or "conv3d.dgrad_hand" not in snap["counters"]:
        return None
    return snap["counters"]["conv3d.dgrad_hand"] / steps
