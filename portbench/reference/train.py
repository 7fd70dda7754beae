"""The plain training step: batch-all triplet + id cross-entropy, Adam.

Batch-all triplet (Hermans et al. 2017, as the UGaitNet reference's
``batch_all_triplet_loss`` and GaitSet compute it): per part, the mean
over the active triplets (margin + d(a, p) - d(a, n) > 0) of that hinge,
with (a, p) every same-label pair, a == p included, and (a, n) every
different-label pair; a part without an active triplet gives 0, and the
loss is the mean over parts.  Distances are Euclidean, exactly 0 on the
diagonal and with a zero gradient where they are 0.  The id term is the
softmax cross-entropy of the logits, the mean over rows; the 3D CNN adds
1e-3 times the sum of squares of each branch's ``code`` kernel (Keras's
l2 regularizer).  Adam is Kingma and Ba's, with eps added to the
bias-corrected root.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import model as M


def distances(e: torch.Tensor) -> torch.Tensor:
    """(P, B, D) -> (P, B, B)."""
    d2 = (e.unsqueeze(2) - e.unsqueeze(1)).pow(2).sum(-1)
    eye = torch.eye(e.shape[1], dtype=torch.bool, device=e.device)
    d2 = d2.masked_fill(eye, 0.0)
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2,
                                                   torch.ones_like(d2))),
                       torch.zeros_like(d2))


def batch_all(sig: torch.Tensor, labels: torch.Tensor,
              margin: float) -> torch.Tensor:
    e = sig[None] if sig.ndim == 2 else sig.transpose(0, 1)
    same = labels[:, None] == labels[None, :]
    valid = same[:, :, None] & ~same[:, None, :]
    losses = []
    for part in e.split(4):                      # bounded (4, B, B, B)
        d = distances(part)
        t = (margin + d[:, :, :, None] - d[:, :, None, :]) * valid
        act = (t > 0) & valid
        s = torch.where(act, t, torch.zeros_like(t)).sum((1, 2, 3))
        n = act.sum((1, 2, 3)).float()
        losses.append(torch.where(n > 0, s / n.clamp_min(1), torch.zeros_like(s)))
    return torch.cat(losses).mean()


def loss(model_cfg: Dict, train_cfg: Dict, W: Dict[str, torch.Tensor],
         volumes, flags, labels, q=M.identity) -> torch.Tensor:
    out = M.forward(model_cfg, W, volumes, flags, q)
    wt, wid = train_cfg["loss_weights"]
    total = wt * batch_all(out["signature"], labels, train_cfg["margin"])
    total = total + wid * F.cross_entropy(out["logits"], labels.long())
    for bc in model_cfg["branches"]:
        if bc["kind"] == "conv3d":
            w = W[f"branches.branch_{bc['modality']}.code.weight"]
            total = total + 1e-3 * (w * w).sum()
    return total


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, W: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g))
            v = self.v.setdefault(k, torch.zeros_like(g))
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            mh = m / (1 - self.b1 ** self.t)
            vh = v / (1 - self.b2 ** self.t)
            W[k] -= self.lr * mh / (vh.sqrt() + self.eps)


def follow(model_cfg: Dict, train_cfg: Dict, W0: Dict[str, torch.Tensor],
           batches: Sequence, q=M.identity) -> Dict:
    """Train from W0 over ``batches`` (volumes, flags, labels) on their
    device: each step's loss, the first step's gradient norm per leaf and
    each leaf's change after the last step."""
    W = {k: v.detach().clone() for k, v in W0.items()}
    opt = Adam(train_cfg["lr"])
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for i, (vols, flags, labels) in enumerate(batches):
        leaves = {k: v.requires_grad_(True) for k, v in W.items()}
        total = loss(model_cfg, train_cfg, leaves, vols, flags, labels, q)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(W[k]))
                 for k, g in zip(leaves, grads)}
        W = {k: v.detach() for k, v in W.items()}
        losses.append(float(total.detach()))
        if i == 0:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        opt.step(W, grads)
        del total, grads, leaves
    change = {k: float((W[k] - W0[k]).norm()) for k in W}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}
