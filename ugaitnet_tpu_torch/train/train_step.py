"""Training step: multi-loss objective and the Adam update.

Port of ``ugaitnet_tpu/train/train_step.py`` for the flagship objective:

  loss = w_ver * triplet(signature) + w_id * CE(classprob_logits) + reg

Unlike the JAX step, which maps a state to a new one, the port updates the
model's parameters and the optimizer's moments in place; ``TrainState``
holds both plus the step count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch

from ugaitnet_tpu_torch.core.config import ModelConfig, TrainConfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops import losses as L
from ugaitnet_tpu_torch.ops.triplet import make_triplet_loss


class Batch(NamedTuple):
    volumes: Tuple[torch.Tensor, ...]
    use_flags: Tuple[torch.Tensor, ...]
    labels: torch.Tensor  # dense int ids


@dataclass
class TrainState:
    model: UGaitNet
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """``adam``: the same update as ``optax.adam`` (eps on the bias-corrected
    sqrt(v)).  The other optimizers are not ported yet."""
    if cfg.optimizer.lower() != "adam":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (ROADMAP.md, "
            "'The remaining model and loss surface')")
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def init_state(model: UGaitNet, tcfg: TrainConfig) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(tcfg, model.parameters()))


def l2_regularization(model: UGaitNet, mcfg: ModelConfig) -> torch.Tensor:
    """Keras kernel_regularizer parity: the gaitset branch has none, and
    the port builds gaitset branches only."""
    return torch.zeros((), dtype=torch.float32, device=model.device)


def losses_from_outputs(out: Dict[str, object], model: UGaitNet,
                        batch: Batch, mcfg: ModelConfig, tcfg: TrainConfig
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss assembly from forward outputs; metrics keys ``triplet``,
    ``id_ce``, ``acc``, ``reg`` and ``loss``."""
    if tcfg.use_focal or mcfg.aux_losses:
        raise NotImplementedError(
            "focal and aux losses are not ported yet (ROADMAP.md, 'The "
            "remaining model and loss surface')")
    triplet_fn = make_triplet_loss(tcfg.triplet_kind, tcfg.margin)
    lw = list(tcfg.loss_weights)
    metrics: Dict[str, torch.Tensor] = {}

    l_tri = triplet_fn(out["signature"], batch.labels)
    metrics["triplet"] = l_tri
    total = lw[0] * l_tri

    if mcfg.nclasses > 0 and not tcfg.only_triplet:
        onehot = torch.nn.functional.one_hot(
            batch.labels.long(), mcfg.nclasses).to(torch.float32)
        l_id = L.softmax_crossentropy_logits(
            out["classprob_logits"], onehot, tcfg.label_smoothing)
        metrics["id_ce"] = l_id
        metrics["acc"] = L.accuracy(out["classprob"], onehot)
        total = total + (lw[1] if len(lw) > 1 else 1.0) * l_id

    reg = l2_regularization(model, mcfg)
    metrics["reg"] = reg
    total = total + reg
    metrics["loss"] = total
    return total, metrics


def compute_losses(model: UGaitNet, batch: Batch, mcfg: ModelConfig,
                   tcfg: TrainConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out = model(list(batch.volumes), list(batch.use_flags))
    return losses_from_outputs(out, model, batch, mcfg, tcfg)


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig):
    """step(state, batch) -> (state, metrics): one forward, backward and
    Adam update, in place.  The gradients of the step stay in ``.grad``."""
    def step(state: TrainState, batch: Batch):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = compute_losses(state.model, batch, mcfg, tcfg)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}
    return step


def make_eval_step(mcfg: ModelConfig, tcfg: TrainConfig):
    """step(model, batch) -> metrics, without gradients."""
    def step(model: UGaitNet, batch: Batch):
        model.eval()
        with torch.no_grad():
            _, metrics = compute_losses(model, batch, mcfg, tcfg)
        return metrics
    return step
