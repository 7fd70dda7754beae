"""The plain forward pass of both configurations, in float32.

Written from the architecture's description (GaitSet, Chao et al. AAAI
2019, as the UGaitNet reference ``nets/mj_uwyhNets_ba.py`` builds it; the
reference paper's strided 3D CNN) with plain ``torch`` operations: no
kernel, cache or batching of the program.  Weights come as a dict under
the program's state_dict names, which the benchmark makes from the seed
and hands to both sides.

``quant`` rounds the operands of every conv and matmul before it runs: the
identity for the reference, a coarser type for a precision control
(``fp8_round``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

Quant = Callable[[torch.Tensor], torch.Tensor]
LEAKY = 0.3
CONV3D_STRIDES = ((1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2), (1, 1, 1),
                  (1, 1, 1))


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the type's largest (448), back in float32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, LEAKY * x)


def pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2; the gradient splits among tied maxima (the
    program's rule, which F.max_pool2d does not follow)."""
    n, c, h, w = x.shape
    return x.reshape(n, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


def conv(x, w, q: Quant, pad: int = 0, bias=None, stride=1):
    fn = F.conv3d if w.ndim == 5 else F.conv2d
    return fn(q(x), q(w), bias, stride=stride, padding=pad)


def gaitset(x: torch.Tensor, W: Dict[str, torch.Tensor], pre: str,
            bins: Sequence[int], q: Quant) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, 2 * sum(bins), part_dim)."""
    b, t, h, w, c = x.shape
    f = x.permute(0, 1, 4, 2, 3).reshape(b * t, c, h, w)
    f = F.pad(f, (2, 2, 2, 2))

    def cv(name, v):
        k = W[f"{pre}.{name}.weight"]
        return conv(v, k, q, pad=k.shape[-1] // 2)

    def set_max(v):
        return v.reshape(b, t, *v.shape[1:]).amax(dim=1)

    a = cv("a_conv2", lrelu(cv("a_conv1", f)))
    a = lrelu(pool2(a))
    s = lrelu(cv("b_conv1", set_max(a)))
    s = lrelu(pool2(cv("b_conv2", s)))
    a = lrelu(pool2(cv("a_conv4", lrelu(cv("a_conv3", a)))))
    s = s + set_max(a)
    s = lrelu(cv("b_conv4", lrelu(cv("b_conv3", s))))
    sa = lrelu(set_max(cv("a_conv6", lrelu(cv("a_conv5", a)))))
    s = s + sa
    feats = []
    for nb in bins:
        for m in (sa, s):
            st = m.reshape(b, m.shape[1], nb, -1)
            feats.append((st.mean(-1) + st.amax(-1)).transpose(1, 2))
    parts = torch.cat(feats, dim=1)                       # (B, P, C3)
    proj = W[f"{pre}.part_proj"]                          # (P, C3, D)
    return torch.einsum("bpc,pcd->bpd", q(parts), q(proj))


def cnn3d(x: torch.Tensor, W: Dict[str, torch.Tensor], pre: str,
          q: Quant) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, 512): six strided VALID convs with bias and
    leaky ReLU, then the 1x1x1 code conv, flattened channels-last."""
    v = x.permute(0, 4, 1, 2, 3)
    for i, st in enumerate(CONV3D_STRIDES):
        v = lrelu(conv(v, W[f"{pre}.conv{i}.weight"], q,
                       bias=W[f"{pre}.conv{i}.bias"], stride=st))
    v = conv(v, W[f"{pre}.code.weight"], q, bias=W[f"{pre}.code.bias"])
    return v.permute(0, 2, 3, 4, 1).reshape(v.shape[0], -1)


def branches(model_cfg: Dict, W: Dict[str, torch.Tensor],
             volumes: Sequence[torch.Tensor], flags: Sequence[torch.Tensor],
             q: Quant = identity) -> List[torch.Tensor]:
    """Each branch's embedding, gated by its presence flag."""
    out = []
    for bc, x, u in zip(model_cfg["branches"], volumes, flags):
        pre = f"branches.branch_{bc['modality']}"
        if bc["kind"] == "gaitset":
            e = gaitset(x, W, pre, bc.get("hpp_bins", (1, 2, 4, 8, 16)), q)
        elif bc["kind"] == "conv3d":
            e = cnn3d(x, W, pre, q)
        else:
            raise ValueError(f"no reference for branch {bc['kind']!r}")
        out.append(e * u.reshape(-1, *([1] * (e.ndim - 1))))
    return out


def merge(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if kind == "sign_max":
        # the larger magnitude; the first branch on a tie
        return torch.where(a.abs() >= b.abs(), a, b)
    if kind == "max":
        return torch.maximum(a, b)
    raise ValueError(f"no reference for merge {kind!r}")


def l2_scale(fused: torch.Tensor, l2_mode: str) -> torch.Tensor:
    """The factor that L2-normalizes the fused embedding: per row for a
    (B, D) one; for (B, P, D) parts over the BATCH axis ("reference", the
    UGaitNet reference's l2_normalize(axis=1) on parts-major data) or per
    part ("feature")."""
    if fused.ndim == 2 or l2_mode == "feature":
        sq = (fused * fused).sum(-1, keepdim=True)
    else:
        sq = (fused * fused).sum(0, keepdim=True)
    return torch.rsqrt(sq.clamp_min(1e-12))


def forward(model_cfg: Dict, W: Dict[str, torch.Tensor],
            volumes: Sequence[torch.Tensor], flags: Sequence[torch.Tensor],
            q: Quant = identity, l2_mode: str = None) -> Dict:
    """signature (B, P, D) or (B, D), flatten (B, P*D) and the id logits."""
    a, b = branches(model_cfg, W, volumes, flags, q)
    fused = merge(model_cfg["merge"], a, b)
    sig = fused * l2_scale(fused, l2_mode or model_cfg["l2_mode"])
    flat = sig.reshape(sig.shape[0], -1)
    out = {"branches": (a, b), "signature": sig, "flatten": flat}
    if model_cfg.get("nclasses", 0) > 0:
        out["logits"] = F.linear(q(flat), q(W["classprob.weight"]),
                                 W["classprob.bias"])
    return out
