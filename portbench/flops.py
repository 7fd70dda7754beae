"""Analytic operation and byte counts, from a configuration's shapes.

Every count is what the algorithm needs, whatever kernel computes it: a
multiply-add is two operations, each input byte is read once and each
output byte written once.  The published peaks of one H100 SXM (NVIDIA's
data sheet, dense, at its 700 W limit) are the denominators of every
utilization and roofline share the benchmark reports.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAKS = {
    "float32": 67e12,        # FLOP/s outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}

# the clip geometry of every configuration: 25 frames of 60 x 60
FRAMES, HEIGHT, WIDTH = 25, 60, 60
MODALITY_CHANNELS = {"of": 2, "gray": 1, "depth": 1, "silhouette": 1,
                     "rgb": 3}
CONV3D_SPEC = (
    (64, (3, 5, 5), (1, 2, 2)),
    (128, (3, 3, 3), (1, 2, 2)),
    (256, (3, 3, 3), (2, 2, 2)),
    (512, (3, 3, 3), (2, 2, 2)),
    (512, (3, 2, 2), (1, 1, 1)),
    (512, (2, 1, 1), (1, 1, 1)),
)


def conv_flops(out_positions: int, ci: int, co: int, taps: int) -> int:
    return 2 * out_positions * ci * co * taps


def gaitset_convs(ci: int, channels, pad: int = 2
                  ) -> List[Tuple[str, int, int, int, int, int]]:
    """The GaitSet branch's convs per clip as (name, images, ci, co, k,
    side): the frame stream runs every frame, the set stream once a clip,
    all "SAME" on square maps."""
    c1, c2, c3 = channels
    s = HEIGHT + 2 * pad
    return [("a_conv1", FRAMES, ci, c1, 5, s),
            ("a_conv2", FRAMES, c1, c1, 3, s),
            ("a_conv3", FRAMES, c1, c2, 3, s // 2),
            ("a_conv4", FRAMES, c2, c2, 3, s // 2),
            ("a_conv5", FRAMES, c2, c3, 3, s // 4),
            ("a_conv6", FRAMES, c3, c3, 3, s // 4),
            ("b_conv1", 1, c1, c2, 3, s // 2),
            ("b_conv2", 1, c2, c2, 3, s // 2),
            ("b_conv3", 1, c2, c3, 3, s // 4),
            ("b_conv4", 1, c3, c3, 3, s // 4)]


def conv3d_layers(ci: int, ndense: int) -> List[Tuple[str, int]]:
    """(name, FLOPs per clip) of the 3D CNN branch: VALID strided convs,
    then the 1x1x1 code conv."""
    t, h, w = FRAMES, HEIGHT, WIDTH
    out = []
    for i, (co, (kt, kh, kw), (st, sh, sw)) in enumerate(CONV3D_SPEC):
        t, h, w = (t - kt) // st + 1, (h - kh) // sh + 1, (w - kw) // sw + 1
        out.append((f"conv{i}", conv_flops(t * h * w, ci, co, kt * kh * kw)))
        ci = co
    out.append(("code", conv_flops(t * h * w, ci, ndense, 1)))
    return out


def branch_layers(branch: Dict) -> List[Tuple[str, int]]:
    """(layer, forward FLOPs per clip) of one branch; the first is the
    layer that reads the clip, whose input needs no gradient."""
    ci = MODALITY_CHANNELS[branch["modality"]]
    if branch["kind"] == "gaitset":
        layers = [(n, conv_flops(img * side * side, a, b, k * k))
                  for n, img, a, b, k, side in gaitset_convs(
                      ci, branch.get("gaitset_channels", (32, 64, 128)))]
        parts = 2 * sum(branch.get("hpp_bins", (1, 2, 4, 8, 16)))
        c3 = branch.get("gaitset_channels", (32, 64, 128))[2]
        layers.append(("part_proj",
                       2 * parts * c3 * branch.get("part_dim", 256)))
        return layers
    if branch["kind"] == "conv3d":
        return conv3d_layers(ci, branch.get("ndense_units", 512))
    raise ValueError(f"no count for branch kind {branch['kind']!r}")


def embedding_width(model: Dict) -> int:
    b = model["branches"][0]
    if b["kind"] == "gaitset":
        return 2 * sum(b.get("hpp_bins", (1, 2, 4, 8, 16))) \
            * b.get("part_dim", 256)
    return b.get("ndense_units", 512)


def forward_flops_per_clip(model: Dict) -> int:
    """Branches plus the id head's matmul; elementwise work is left out."""
    total = sum(f for b in model["branches"] for _, f in branch_layers(b))
    return total + 2 * embedding_width(model) * model.get("nclasses", 0)


def train_flops_per_row(model: Dict) -> int:
    """Forward + backward of one batch row: 3x the forward of every layer
    (forward, input gradient, weight gradient), 2x for a branch's first
    layer, whose input gradient autograd does not compute."""
    total = 0
    for b in model["branches"]:
        layers = branch_layers(b)
        total += 2 * layers[0][1] + sum(3 * f for _, f in layers[1:])
    return total + 3 * 2 * embedding_width(model) * model.get("nclasses", 0)


def conv3x3_layers(model: Dict, batch: int, itemsize: int
                   ) -> Dict[str, Tuple[float, float]]:
    """{layer: (operations, bytes)} of one batch through every 3x3 GaitSet
    conv of every branch, keyed "<modality>.<conv>": input, weight and
    output each moved once."""
    out = {}
    for b in model["branches"]:
        if b["kind"] != "gaitset":
            continue
        ci = MODALITY_CHANNELS[b["modality"]]
        for n, img, a, c, k, side in gaitset_convs(
                ci, b.get("gaitset_channels", (32, 64, 128))):
            if k != 3:
                continue
            n_img = batch * img
            ops = conv_flops(n_img * side * side, a, c, 9)
            byts = itemsize * (n_img * side * side * (a + c) + c * a * 9)
            out[f"{b['modality']}.{n}"] = (float(ops), float(byts))
    return out


def roofline_seconds(ops: float, byts: float, peak_flops: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / peak_flops, byts / PEAKS["hbm_bytes_per_s"])

