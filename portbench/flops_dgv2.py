"""Analytic operation and byte counts of DeepGaitV2-3D, from a
configuration's shapes, as ``flops.py`` counts the other branches: a
multiply-add is two operations, each input byte is read once and each
output byte written once, whatever kernel computes it.

A clip of 25 frames of 60 x 60 enters the branch padded by 2 and cut 10
columns a side: 64 x 44 (``reference/deepgaitv2.py``).  Convs have padding
1 (3 x 3 (x 3)) or 0 (1 x 1 (x 1) shortcuts), so a stride s maps n to
(n - 1) // s + 1.  ``ops`` lists every conv, BatchNorm + ReLU, residual
sum and matmul of one clip's forward under the program's span that runs
it (``models/deepgaitv2.py``: ``model.dgv2.stem``, ``.stage1`` ..
``.stage4``, ``.pool``; ``head.bnneck``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.flops import FRAMES, HEIGHT, WIDTH, roofline_seconds

PAD, CUT = 2, 10
# the first block's (T, H, W) stride of each stage (DeepGaitV2's 3D mode)
STRIDES = ((1, 1, 1), (1, 2, 2), (1, 2, 2), (1, 1, 1))


def _out(n: int, s: int) -> int:
    return (n - 1) // s + 1


def ops(model: Dict, frames: int = FRAMES, height: int = HEIGHT,
        width: int = WIDTH) -> List[Tuple[str, str, int, int, int]]:
    """(span, op, FLOPs a clip, activation elements moved a clip, weight
    elements) of one clip's forward.  An op's activations are its input
    and output (a sum's two inputs); FLOPs count convs and matmuls only."""
    b = model["branches"][0]
    ci = 1
    t, h, w = frames, height + 2 * PAD, width + 2 * PAD - 2 * CUT
    chans, blocks = b["stage_channels"], b["stage_blocks"]
    out: List[Tuple[str, str, int, int, int]] = []

    def conv(span, name, ci, co, taps, pos_in, pos_out):
        out.append((span, name, 2 * pos_out * ci * co * taps,
                    pos_in * ci + pos_out * co, ci * co * taps))

    def bn(span, name, c, pos):
        out.append((span, name, 0, 2 * pos * c, 0))

    c0 = chans[0]
    conv("model.dgv2.stem", "stem.conv", ci, c0, 9, t * h * w, t * h * w)
    bn("model.dgv2.stem", "stem.bn", c0, t * h * w)
    ci = c0
    for i, (co, n, st) in enumerate(zip(chans, blocks, STRIDES)):
        span, taps = f"model.dgv2.stage{i + 1}", 9 if i == 0 else 27
        for j in range(n):
            s = st if j == 0 else (1, 1, 1)
            if i == 0:
                s = (1,) + tuple(s[1:])
            t2, h2, w2 = _out(t, s[0]), _out(h, s[1]), _out(w, s[2])
            pin, pout = t * h * w, t2 * h2 * w2
            name = f"stage{i + 1}.{j}"
            conv(span, f"{name}.conv1", ci, co, taps, pin, pout)
            bn(span, f"{name}.bn1", co, pout)
            conv(span, f"{name}.conv2", co, co, taps, pout, pout)
            bn(span, f"{name}.bn2", co, pout)
            if max(s) > 1 or ci != co:
                conv(span, f"{name}.shortcut", ci, co, 1, pin, pout)
                bn(span, f"{name}.shortcut_bn", co, pout)
            out.append((span, f"{name}.sum", 0, 3 * pout * co, 0))
            t, h, w, ci = t2, h2, w2, co
    parts, dim = sum(b["hpp_bins"]), b["part_dim"]
    # max over time, then mean + max a strip: the map read once, the parts
    # written; the FCs
    out.append(("model.dgv2.pool", "pool", 0, t * h * w * ci + parts * ci,
                0))
    out.append(("model.dgv2.pool", "fc_bin", 2 * parts * ci * dim,
                parts * (ci + dim), parts * ci * dim))
    k = model.get("nclasses", 0)
    if k > 0:
        out.append(("head.bnneck", "bnneck.bn", 0, 2 * parts * dim, 0))
        out.append(("head.bnneck", "bnneck.fc_bin", 2 * parts * dim * k,
                    parts * (dim + k), parts * dim * k))
    return out


def forward_flops_per_clip(model: Dict, **geometry) -> int:
    return sum(f for _, _, f, _, _ in ops(model, **geometry))


def train_flops_per_row(model: Dict, **geometry) -> int:
    """Forward + backward of one row: 3x the forward of every conv and
    matmul (forward, input gradient, weight gradient), 2x for the stem
    conv, whose input needs no gradient."""
    layers = ops(model, **geometry)
    return sum((2 if name == "stem.conv" else 3) * f
               for _, name, f, _, _ in layers)


def span_bounds(model: Dict, batch: int, itemsize: int, peak_flops: float,
                **geometry) -> Dict[str, float]:
    """{span: the least seconds one forward of ``batch`` clips can take
    under it}: the sum over its ops of each op's roofline time (the larger
    of operations over ``peak_flops`` and bytes over the HBM rate), with
    activations and weights of ``itemsize`` bytes."""
    out: Dict[str, float] = {}
    for span, _, f, act, wts in ops(model, **geometry):
        out[span] = out.get(span, 0.0) + roofline_seconds(
            batch * f, itemsize * (batch * act + wts), peak_flops)
    return out
