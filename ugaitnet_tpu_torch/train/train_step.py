"""Training step: multi-loss objective and the optimizer menu.

Port of ``ugaitnet_tpu/train/train_step.py`` for the flagship objective:

  loss = w_ver * triplet(signature) + w_id * CE(classprob_logits) + reg

Unlike the JAX step, which maps a state to a new one, the port updates the
model's parameters and the optimizer's moments in place; ``TrainState``
holds both plus the step count.

The optimizers reproduce the JAX package's optax updates, which
``inject_hyperparams`` runs with float32 hyperparameters: the learning rate
is stored rounded to float32 (``set_lr``), and the hand-written updates
below compute in float32 with float32 betas, eps and decay.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
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


def _f32(x: float) -> float:
    """x rounded to float32, as a Python float."""
    return float(np.float32(x))


class _Float32Optimizer(torch.optim.Optimizer):
    """Shared state of the hand-written updates: the step count per
    parameter as a CPU float32 tensor (as torch.optim.Adam keeps it) and
    the named buffers, zero-initialised beside the parameter."""

    BUFFERS: Tuple[str, ...] = ()

    def __init__(self, params, lr: float, **hyper):
        super().__init__(params, dict(lr=_f32(lr), **hyper))

    def _params(self):
        """(group, parameter, gradient, state) of every parameter with a
        gradient."""
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    for name in self.BUFFERS:
                        st[name] = torch.zeros_like(
                            p, memory_format=torch.preserve_format)
                yield group, p, p.grad, st


# optax's Adam-family defaults, as inject_hyperparams holds them (float32)
B1, B2 = np.float32(0.9), np.float32(0.999)


def _adam_moments(st: dict, g: torch.Tensor) -> None:
    """m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, step + 1."""
    st["exp_avg"].mul_(float(B1)).add_(g, alpha=float(np.float32(1) - B1))
    st["exp_avg_sq"].mul_(float(B2)).addcmul_(
        g, g, value=float(np.float32(1) - B2))
    st["step"] += 1


def _bias_correction(beta: np.float32, count: torch.Tensor) -> float:
    """float32 1 - beta**count (optax's bias_correction)."""
    return float(np.float32(1) - beta ** np.float32(count.item()))


class KerasAdam(_Float32Optimizer):
    """Keras's Adam (``keras_adam`` of the JAX package):
    alpha_t = lr * sqrt(1 - b2^t) / (1 - b1^t), p -= alpha_t * m / (sqrt(v)
    + eps), with eps 1e-7 outside the sqrt."""

    BUFFERS = ("exp_avg", "exp_avg_sq")
    EPS = 1e-7

    @torch.no_grad()
    def step(self, closure=None):
        for group, p, g, st in self._params():
            _adam_moments(st, g)
            t = np.float32(st["step"].item())
            alpha = (np.float32(group["lr"]) * np.sqrt(np.float32(1) - B2 ** t)
                     / (np.float32(1) - B1 ** t))
            denom = st["exp_avg_sq"].sqrt().add_(_f32(self.EPS))
            p.addcdiv_(st["exp_avg"], denom, value=-float(alpha))


class OptaxAmsgrad(_Float32Optimizer):
    """``optax.amsgrad``: the running max is taken over the bias-corrected
    second moment, nu_max = max(nu_max, nu / (1 - b2^t)), and the update is
    (m / (1 - b1^t)) / (sqrt(nu_max) + eps).  ``torch.optim.Adam(amsgrad=True)``
    takes the max of the raw moment and corrects it afterwards, a different
    update."""

    BUFFERS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")
    EPS = 1e-8

    @torch.no_grad()
    def step(self, closure=None):
        for group, p, g, st in self._params():
            _adam_moments(st, g)
            nu_hat = st["exp_avg_sq"] / _bias_correction(B2, st["step"])
            torch.maximum(st["max_exp_avg_sq"], nu_hat,
                          out=st["max_exp_avg_sq"])
            mu_hat = st["exp_avg"] / _bias_correction(B1, st["step"])
            denom = st["max_exp_avg_sq"].sqrt().add_(_f32(self.EPS))
            p.add_(mu_hat / denom, alpha=-group["lr"])


class OptaxAdamW(_Float32Optimizer):
    """``optax.adamw`` at weight_decay 1e-4: the Adam direction plus
    weight_decay * p, for every parameter, times -lr."""

    BUFFERS = ("exp_avg", "exp_avg_sq")
    EPS = 1e-8
    WEIGHT_DECAY = 1e-4

    @torch.no_grad()
    def step(self, closure=None):
        for group, p, g, st in self._params():
            _adam_moments(st, g)
            mu_hat = st["exp_avg"] / _bias_correction(B1, st["step"])
            nu_hat = st["exp_avg_sq"] / _bias_correction(B2, st["step"])
            u = mu_hat / nu_hat.sqrt().add_(_f32(self.EPS))
            u.add_(p, alpha=_f32(self.WEIGHT_DECAY))
            p.add_(u, alpha=-group["lr"])


class KerasSGD(_Float32Optimizer):
    """The JAX package's ``sgd``: ``optax.trace(momentum)``, then Keras's
    decay 1 / (1 + 1e-5 * count) with count from 0, then -lr.  The lr is
    the group's, so ``set_lr`` sticks and the decay still applies on top."""

    BUFFERS = ("trace",)
    DECAY = 1e-5

    def __init__(self, params, lr: float, momentum: float):
        super().__init__(params, lr, momentum=momentum)

    @torch.no_grad()
    def step(self, closure=None):
        for group, p, g, st in self._params():
            st["trace"].mul_(_f32(group["momentum"])).add_(g)
            factor = (np.float32(1) / (np.float32(1) + np.float32(self.DECAY)
                                       * np.float32(st["step"].item())))
            st["step"] += 1
            p.add_(st["trace"] * float(factor), alpha=-group["lr"])


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """The JAX package's optimizer menu, each with its optax update:

    * ``adam``: ``torch.optim.Adam``, the same update as ``optax.adam`` (eps
      on the bias-corrected sqrt(v));
    * ``adam_keras``: Keras's form (``KerasAdam``);
    * ``amsgrad``: ``optax.amsgrad`` (``OptaxAmsgrad``);
    * ``adamw``: ``optax.adamw`` at weight_decay 1e-4 (``OptaxAdamW``);
    * ``sgd``: momentum ``cfg.momentum`` with Keras's decay (``KerasSGD``).
    """
    name = cfg.optimizer.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=_f32(cfg.lr), betas=(0.9, 0.999),
                                eps=1e-8)
    if name == "adam_keras":
        return KerasAdam(params, cfg.lr)
    if name == "amsgrad":
        return OptaxAmsgrad(params, cfg.lr)
    if name == "adamw":
        return OptaxAdamW(params, cfg.lr)
    if name == "sgd":
        return KerasSGD(params, cfg.lr, momentum=cfg.momentum)
    raise ValueError(f"unknown optimizer {cfg.optimizer}")


def init_state(model: UGaitNet, tcfg: TrainConfig) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(tcfg, model.parameters()))


def get_lr(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_lr(state: TrainState, lr: float) -> TrainState:
    """Set every param group's lr, rounded to float32 as the JAX package's
    ``inject_hyperparams`` stores it."""
    for group in state.optimizer.param_groups:
        group["lr"] = _f32(lr)
    return state


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
