"""The plain DeepGaitV2-3D: forward, losses, gradients and the SGD step.

Written from Fan, Hou, Yu et al., *Exploring Deep Models for Practical
Gait Recognition* (arXiv:2303.03301) and OpenGait's code for it
(``opengait/modeling/models/deepgaitv2.py``: ``DeepGaitV2`` in mode "3d";
``opengait/modeling/modules.py``: ``BasicBlock2D``, ``BasicBlock3D``,
``SetBlockWrapper``, ``PackSequenceWrapper``, ``HorizontalPoolingPyramid``,
``SeparateFCs``, ``SeparateBNNecks``; ``opengait/modeling/losses``:
``TripletLoss``, ``CrossEntropyLoss``), in plain ``torch``, float32, with
OpenGait's layouts: features [n, c, p] and logits [n, classes, p].  No
kernel, cache or batching of the program.  Weights and BatchNorm buffers
come as a dict under the program's state_dict names, which the benchmark
makes from the seed and hands to both sides.

Departures from OpenGait, each where the program departs the same way:

* the clip geometry: 25 frames of 60 x 60 silhouettes, padded by 2 on every
  side to 64 x 64, then cut to 64 x 44 as ``BaseSilCuttingTransform`` cuts
  its 64 x 64 frames (OpenGait trains on 30 frames of 64 x 64);
* the input path (``input_batch``) is the benchmark's, not OpenGait's
  transforms: the port's joint affine / mirror / photometric augmentation
  (``reference/data.py``), silhouettes decoded to x / 255;
* the triplet distances: sqrt of the summed squared differences, exactly 0
  on the diagonal and with a zero gradient where 0 (OpenGait takes
  sqrt(relu(|x|^2 + |y|^2 - 2 x.y)), whose diagonal holds a rounding
  residue and whose gradient is infinite at 0);
* float32 everywhere (OpenGait trains under fp16 AMP; the program in bf16).

``q`` rounds the operands of every conv and matmul before it runs, and
``q_out`` every conv's output: the identity for the reference,
``fp8_operand`` (operands) for the precision control, ``bf16_value`` (both)
for the witness of the program's bf16.  The other controls: ``bn_running``
normalizes with the running statistics while training (and so never moves
them); ``no_shortcut`` names one block ("stage3.1", say) whose shortcut is
left out of its sum; ``triplet_rows`` takes the triplet over the batch's
first rows only (``loss``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import data as RD
from portbench.reference import model as M

BN_MOMENTUM, BN_EPS = 0.1, 1e-5
PAD, CUT = 2, 10
# OpenGait's strides of mode "3d" (build_network), the 2D layer1 first
STRIDES = ((1, 1), (1, 2, 2), (1, 2, 2), (1, 1, 1))
BUFFERS = ("running_mean", "running_var")


def fp8_operand(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 as ``model.fp8_round`` rounds it, with the
    gradient passed through unrounded (a cast's own gradient would be
    rounded to e4m3 unscaled, and vanish)."""
    return x + (M.fp8_round(x.detach()) - x).detach()


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_value(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, and its gradient rounded to bfloat16 in the
    backward: where the program holds a tensor in bf16, forward and
    backward."""
    return _Bf16.apply(x)


def input_batch(raw: torch.Tensor, g: torch.Generator, augmenting: bool
                ) -> torch.Tensor:
    """(B, T, H, W) uint8 silhouettes -> (B, T, H, W, 1) float32, with this
    batch's draws from ``g`` (the stream's order: one draw set a modality;
    no modality-dropout copies)."""
    x = (raw.double() * RD.GRAY_SCALE).float()[:, :, None]   # (B,T,1,H,W)
    if augmenting:
        x = RD.augment(x, RD.draw_params(g, x.shape[0], True), False)
    return x.permute(0, 1, 3, 4, 2)


class Net:
    """One forward's context: weights, the controls, the taps."""

    def __init__(self, model_cfg: Dict, W: Dict[str, torch.Tensor],
                 train: bool, q=M.identity, q_out=M.identity,
                 bn_running: bool = False, no_shortcut: Optional[str] = None):
        self.cfg, self.W, self.train = model_cfg, W, train
        self.q, self.q_out = q, q_out
        self.bn_running, self.no_shortcut = bn_running, no_shortcut
        self.taps: Dict[str, torch.Tensor] = {}

    def bn(self, x, name):
        W = self.W
        batch_stats = self.train and not self.bn_running
        return F.batch_norm(x, W[f"{name}.running_mean"],
                            W[f"{name}.running_var"], W[f"{name}.weight"],
                            W[f"{name}.bias"], batch_stats, BN_MOMENTUM,
                            BN_EPS)

    def conv(self, x, name, stride=1, pad=1):
        w = self.W[f"{name}.weight"]
        fn = F.conv3d if w.ndim == 5 else F.conv2d
        return self.q_out(fn(self.q(x), self.q(w), None, stride=stride,
                             padding=pad))

    def block(self, x, name, stride):
        """BasicBlock2D (torchvision's) / BasicBlock3D (OpenGait's)."""
        y = F.relu(self.bn(self.conv(x, f"{name}.conv1", stride),
                           f"{name}.bn1"))
        y = self.bn(self.conv(y, f"{name}.conv2"), f"{name}.bn2")
        if f"{name}.shortcut.weight" in self.W:
            x = self.bn(self.conv(x, f"{name}.shortcut", stride, 0),
                        f"{name}.shortcut_bn")
        if name.endswith(f".{self.no_shortcut}"):
            return F.relu(y)
        return F.relu(y + x)

    def branch(self, x: torch.Tensor, pre: str) -> torch.Tensor:
        """(B, T, H, W, 1) -> embed_1 [n, part_dim, p]."""
        bc = self.cfg["branches"][0]
        b, t, h, w, c = x.shape
        f = x.permute(0, 1, 4, 2, 3).reshape(b * t, c, h, w)
        f = F.pad(f, (PAD, PAD, PAD, PAD))[..., CUT:w + 2 * PAD - CUT]
        # layer0 and layer1 under SetBlockWrapper: frames folded in n
        f = F.relu(self.bn(self.conv(f, f"{pre}.stem.conv"), f"{pre}.stem.bn"))
        self.taps["stem"] = f
        for j in range(bc["stage_blocks"][0]):
            f = self.block(f, f"{pre}.stage1.{j}",
                           STRIDES[0] if j == 0 else 1)
        self.taps["stage1"] = f
        v = f.reshape(b, t, *f.shape[1:]).transpose(1, 2)  # [n, c, s, h, w]
        for i in (2, 3, 4):
            for j in range(bc["stage_blocks"][i - 1]):
                v = self.block(v, f"{pre}.stage{i}.{j}",
                               STRIDES[i - 1] if j == 0 else 1)
            self.taps[f"stage{i}"] = v
        v = v.amax(dim=2)                                   # TP: max over s
        n, c = v.shape[:2]
        feat = torch.cat([(z.mean(-1) + z.amax(-1)) for z in
                          (v.reshape(n, c, nb, -1) for nb in bc["hpp_bins"])],
                         dim=-1)                             # HPP [n, c, p]
        self.taps["pool"] = feat
        # SeparateFCs: [p, n, c] @ fc_bin [p, c, d] -> [n, d, p]
        out = self.q(feat.permute(2, 0, 1)).matmul(
            self.q(self.W[f"{pre}.fc_bin"]))
        return out.permute(1, 2, 0)

    def bnneck(self, embed: torch.Tensor):
        """SeparateBNNecks (parallel_BN1d, norm): embed [n, c, p] ->
        (feature [n, c, p], cosine logits [n, classes, p])."""
        n, c, p = embed.shape
        x = self.bn(embed.reshape(n, -1), "bnneck.bn").reshape(n, c, p)
        feature = F.normalize(x.permute(2, 0, 1), dim=-1)    # [p, n, c]
        w = F.normalize(self.W["bnneck.fc_bin"], dim=1)
        logits = self.q(feature).matmul(self.q(w))           # [p, n, k]
        return feature.permute(1, 2, 0), logits.permute(1, 2, 0)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        pre = f"branches.branch_{self.cfg['branches'][0]['modality']}"
        embed = self.branch(x, pre)
        feature, logits = self.bnneck(embed)
        return dict(self.taps, embed=embed, feature=feature, logits=logits)


def forward(model_cfg: Dict, W: Dict[str, torch.Tensor], x: torch.Tensor,
            train: bool, **controls) -> Dict[str, torch.Tensor]:
    """Every tap: ``stem``, ``stage1`` (frames folded in n), ``stage2`` ..
    ``stage4`` [n, c, s, h, w], ``pool`` [n, c, p], ``embed`` [n, d, p],
    ``feature`` [n, d, p] and ``logits`` [n, classes, p] (unscaled).  In
    train mode the BatchNorm buffers in ``W`` move, as ``F.batch_norm``
    moves them."""
    return Net(model_cfg, W, train, **controls).forward(x)


def triplet(embed: torch.Tensor, labels: torch.Tensor,
            margin: float) -> torch.Tensor:
    """OpenGait's TripletLoss: per part, every (a, p, n) with lab[p] ==
    lab[a] (a == p included) != lab[n], relu(d(a, p) - d(a, n) + margin),
    averaged over the non-zero ones (AvgNonZeroReducer), then the mean over
    parts.  OpenGait gathers the pairs into (p, n, K, 1) and (p, n, 1, n -
    K), which needs K rows of every label; the mask below gives the same
    terms for any labels."""
    e = embed.permute(2, 0, 1)                               # [p, n, c]
    diff = e[:, :, None, :] - e[:, None, :, :]
    d2 = (diff * diff).sum(-1)
    eye = torch.eye(e.shape[1], dtype=torch.bool, device=e.device)
    d2 = d2.masked_fill(eye, 0.0)
    pos = d2 > 0
    dist = torch.where(pos, torch.sqrt(torch.where(pos, d2,
                                                   torch.ones_like(d2))),
                       torch.zeros_like(d2))
    matches = labels[:, None] == labels[None, :]
    valid = matches[:, :, None] & ~matches[:, None, :]        # (a, p, n)
    loss = F.relu(dist[:, :, :, None] - dist[:, :, None, :] + margin)
    loss = torch.where(valid, loss, torch.zeros_like(loss)).flatten(1)
    num = (loss != 0).sum(-1).float()
    avg = loss.sum(-1) / (num + 1.0e-9)
    return torch.where(num == 0, torch.zeros_like(avg), avg).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, scale: float,
                  smoothing: float) -> torch.Tensor:
    """OpenGait's CrossEntropyLoss: logits [n, classes, p] times ``scale``,
    label smoothing ``smoothing``, the mean over rows and parts."""
    p = logits.shape[-1]
    return F.cross_entropy(logits * scale, labels[:, None].repeat(1, p),
                           label_smoothing=smoothing)


def loss(model_cfg: Dict, train_cfg: Dict, W: Dict[str, torch.Tensor],
         x: torch.Tensor, labels: torch.Tensor,
         triplet_rows: Optional[int] = None, **controls):
    """(total, triplet, cross-entropy, outputs) of one training forward;
    ``triplet_rows`` (a control) takes the triplet over the first rows
    alone."""
    out = forward(model_cfg, W, x, True, **controls)
    wt, wid = train_cfg["loss_weights"]
    n = triplet_rows or labels.shape[0]
    tri = triplet(out["embed"][:n], labels[:n], train_cfg["margin"])
    ce = cross_entropy(out["logits"], labels,
                       model_cfg["branches"][0]["logit_scale"],
                       train_cfg["label_smoothing"])
    return wt * tri + wid * ce, tri, ce, out


class SGD:
    """torch.optim.SGD (dampening 0, not Nesterov), as OpenGait's solver:
    d = g + weight_decay p; buf = d at the first step, else momentum buf +
    d; p -= lr buf."""

    def __init__(self, lr: float, momentum: float, weight_decay: float):
        self.lr, self.momentum, self.wd = lr, momentum, weight_decay
        self.buf: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, W: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        for k, g in grads.items():
            d = g + self.wd * W[k]
            if k in self.buf:
                self.buf[k].mul_(self.momentum).add_(d)
            else:
                self.buf[k] = d.clone()
            W[k] -= self.lr * self.buf[k]


def is_buffer(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in BUFFERS


def follow(model_cfg: Dict, train_cfg: Dict, W0: Dict[str, torch.Tensor],
           batches: Sequence, **controls) -> Dict:
    """Train from W0 over ``batches`` (x, labels) on their device: each
    step's loss; the first step's gradient of each parameter, its norm
    ("grad_norms") and the tensor on the host ("grads1"), and the move of
    each BatchNorm buffer in that step ("moves1", on the host); after the
    last step the change of each parameter by norm ("change")."""
    W = {k: v.detach().clone() for k, v in W0.items()}
    opt = SGD(train_cfg["lr"], train_cfg["momentum"],
              train_cfg["weight_decay"])
    params = [k for k in W if not is_buffer(k)]
    losses: List[float] = []
    out: Dict[str, Dict[str, float]] = {}
    for i, (x, labels) in enumerate(batches):
        for k in params:
            W[k].requires_grad_(True)
        total = loss(model_cfg, train_cfg, W, x, labels, **controls)[0]
        grads = torch.autograd.grad(total, [W[k] for k in params])
        grads = dict(zip(params, grads))
        for k in params:
            W[k] = W[k].detach()
        losses.append(float(total.detach()))
        if i == 0:
            out["grad_norms"] = {k: float(g.norm()) for k, g in grads.items()}
            out["grads1"] = {k: g.cpu() for k, g in grads.items()}
            out["moves1"] = moves(W, W0)
        opt.step(W, grads)
        del total, grads
    out["change"] = changes(W, W0)
    return dict(out, losses=losses)


def moves(W: Dict[str, torch.Tensor], W0: Dict[str, torch.Tensor]
          ) -> Dict[str, torch.Tensor]:
    """r − r₀ of each BatchNorm buffer, on the host."""
    return {k: (W[k] - W0[k]).cpu() for k in W if is_buffer(k)}


def changes(W: Dict[str, torch.Tensor], W0: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    """‖p − p₀‖ of each parameter."""
    return {k: float((W[k] - W0[k]).norm()) for k in W if not is_buffer(k)}
