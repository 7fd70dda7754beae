"""Branches and hand kernels: DeepGaitV2's forward against its roofline,
in %: over the backbone's ranges of the traced steps (the program's spans
``model.dgv2.stem``, ``.stage1`` .. ``.stage4`` and ``.pool``, each a
"ugn." range), the least time of their calls (each op's operations over
989 TFLOP/s or its bf16 bytes over 3.35 TB/s, whichever is larger,
``flops_dgv2.py:span_bounds``) over the device time of the kernels
launched inside them (``drivers/train_dgv2.py:range_device_seconds``).
No reading where the record holds no such range."""


def read(rec):
    ranges = rec.get("dgv2_ranges") or {}
    bounds = rec.get("dgv2_bounds") or {}
    least = spent = 0.0
    for name, bound in bounds.items():
        calls, secs = ranges.get(name, (0, 0.0))
        least += calls * bound
        spent += secs
    if rec.get("kind") != "train" or spent <= 0.0:
        return None
    return 100.0 * least / spent
