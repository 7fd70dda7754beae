"""Every 3x3 GaitSet conv of the encode against its roofline, in %: the
least time of the calls in the traced slice (each layer's operations and
bytes, ``flops.py:conv3x3_layers``) over the device time of the kernels
launched inside their "pb.conv3x3.<layer>" ranges, whichever kernel
computes them."""


def read(rec):
    ranges = rec.get("trace", {}).get("ranges", {})
    bounds = rec.get("conv3x3", {})
    least = spent = 0.0
    for layer, bound in bounds.items():
        calls, secs = ranges.get(f"pb.conv3x3.{layer}", (0, 0.0))
        least += calls * bound
        spent += secs
    if rec.get("kind") != "encode" or spent <= 0.0:
        return None
    return 100.0 * least / spent
