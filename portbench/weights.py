"""Weights from the seed, made on the device in one draw.

Every kernel is Glorot-uniform with the program's fans (the receptive field
counts; a part projection (P, C, D) has fans P*C and P*D), every bias 0.
The values are drawn as one uniform vector on the card and cut into the
leaves; both the program and the reference get them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.traffic import mix


def fans(name: str, shape) -> tuple:
    if name.endswith("part_proj"):
        p, c, d = shape
        return p * c, p * d
    if len(shape) == 2:                      # Linear (out, in)
        return shape[1], shape[0]
    rf = math.prod(shape[2:])                # conv (O, I, *k)
    return shape[1] * rf, shape[0] * rf


def make_weights(shapes: Dict[str, tuple], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for the state_dict shapes given, in their
    order."""
    sizes = [math.prod(s) for s in shapes.values()]
    g = torch.Generator(device=device).manual_seed(mix(seed, 7))
    u = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    out, pos = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        if name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            fi, fo = fans(name, shape)
            out[name] = (u[pos:pos + n] * math.sqrt(6.0 / (fi + fo))
                         ).reshape(shape)
        pos += n
    return out
