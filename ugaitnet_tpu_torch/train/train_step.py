"""Training step: multi-loss objective and the optimizer menu.

Port of ``ugaitnet_tpu/train/train_step.py``:

  loss = w_ver * triplet(signature)
       + w_id  * CE(classprob_logits)   [label smoothing; or focal on
                                         classprob; the BNNeck head's
                                         per-part logits: the mean over
                                         rows and parts]
       + w_aux * CE(per-branch aux heads)
       + moe_aux_weight * MoE load-balance loss  [MoE part projections]
       + reg (Keras kernel_regularizer terms)

and the Siamese pair step on the verification loss
(``make_pair_train_step``).

Unlike the JAX step, which maps a state to a new one, the port updates the
model's parameters and the optimizer's moments in place; ``TrainState``
holds both plus the step count.

On several ranks (``parallel/``) the loss takes the data ranks' ``group``:
triplets are mined over the gathered signatures and labels and the id
terms are averaged over the ranks, so every rank holds the same global
loss.  ``global_batch`` picks the global form (the signature's L2 and MoE
routing span the group in the forward) or the per-shard form (they are
local, and the MoE term is averaged over the ranks).  Under tensor
parallelism (``parallel/tensor.py``) the signature may be this model
rank's strip of parts: the triplet kernel runs on the strip, and the
rank's term, its parts' share of the mean over parts, is summed over the
model group (``triplet_term``).

The optimizers reproduce the JAX package's optax updates, which
``inject_hyperparams`` runs with float32 hyperparameters: the learning rate
is stored rounded to float32 (``set_lr``), and the hand-written updates
below compute in float32 with float32 betas, eps and decay.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ugaitnet_tpu_torch.core.config import ModelConfig, TrainConfig
from ugaitnet_tpu_torch.models import deepgaitv2 as DG
from ugaitnet_tpu_torch.models.branches import ShardKey, fold_key
from ugaitnet_tpu_torch.models.network import UGaitNet, tp_strips
from ugaitnet_tpu_torch.obsv import spans
from ugaitnet_tpu_torch.ops import losses as L
from ugaitnet_tpu_torch.ops.collectives import (DATA_AXIS, all_gather_rows,
                                                all_reduce_mean,
                                                average_gradients,
                                                gather_rows_nograd,
                                                reduce_out)
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


# OpenGait's SGD weight decay (configs/deepgaitv2/*.yaml: 0.0005)
SGD_WEIGHT_DECAY = 5e-4

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
    * ``sgd``: momentum ``cfg.momentum`` with Keras's decay (``KerasSGD``);
    * ``sgd_opengait`` (port only): ``torch.optim.SGD`` with momentum
      ``cfg.momentum`` and coupled weight decay ``SGD_WEIGHT_DECAY`` on every
      parameter, OpenGait's solver in the published DeepGaitV2 runs (the
      decay is fixed, as adamw's is, since ``TrainConfig`` keeps the JAX
      package's fields).
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
    if name == "sgd_opengait":
        return torch.optim.SGD(params, lr=_f32(cfg.lr), momentum=cfg.momentum,
                               weight_decay=SGD_WEIGHT_DECAY)
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
    """Keras kernel_regularizer parity (``train_step.py:l2_regularization``
    of the JAX package): on 2D CNN branches l2(weight_decay) on every conv
    kernel and l2(1e-3) on the ``code`` kernel; on 3D CNN branches l2(1e-3)
    on the 1x1x1 ``code`` kernel; the GaitSet branch has none.  Keras l2(c)
    adds c * sum(w^2)."""
    total = torch.zeros((), dtype=torch.float32, device=model.device)
    for bcfg in mcfg.branches:
        branch = model.branches[f"branch_{bcfg.modality}"]
        if bcfg.kind == "conv2d":
            for i in range(branch.convs):
                w = getattr(branch, f"conv{i}").weight
                total = total + bcfg.weight_decay * torch.sum(w * w)
        if bcfg.kind in ("conv2d", "conv3d"):
            w = branch.code.weight
            total = total + 1e-3 * torch.sum(w * w)
    return total


def strip_share(strip_parts: int, parts: int) -> float:
    """A strip's weight in the mean over parts: the loss is the mean of
    per-part means, so ``strip_parts`` of ``parts`` carry that share."""
    return strip_parts / parts


def triplet_term(loss: torch.Tensor, signature: torch.Tensor, model,
                 mcfg: ModelConfig) -> torch.Tensor:
    """The triplet loss of the whole signature from this rank's value:
    ``loss`` itself unless the signature is a tensor-parallel strip, whose
    share of the mean over parts the model group sums.  A signature that
    every model rank holds whole gives the whole loss on each, once."""
    tp = getattr(model, "tp", None)
    if "signature" not in tp_strips(mcfg, tp):
        return loss
    share = strip_share(signature.shape[1], mcfg.signature_parts)
    return reduce_out(loss * share, tp.group)


def losses_from_outputs(out: Dict[str, object], model: UGaitNet,
                        batch: Batch, mcfg: ModelConfig, tcfg: TrainConfig,
                        group=None, global_batch: bool = True
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss assembly from forward outputs; metrics keys ``triplet``,
    ``id_ce``, ``acc``, ``aux_ce_<i>`` (aux heads), ``moe_aux`` (MoE),
    ``reg`` and ``loss``.  ``group``: the data ranks (module docstring)."""
    triplet_fn = make_triplet_loss(tcfg.triplet_kind, tcfg.margin)
    lw = list(tcfg.loss_weights)
    metrics: Dict[str, torch.Tensor] = {}

    l_tri = triplet_term(
        triplet_fn(all_gather_rows(out["signature"], group),
                   gather_rows_nograd(batch.labels, group)),
        out["signature"], model, mcfg)
    metrics["triplet"] = l_tri
    total = lw[0] * l_tri

    if mcfg.nclasses > 0 and not tcfg.only_triplet:
        onehot = torch.nn.functional.one_hot(
            batch.labels.long(), mcfg.nclasses).to(torch.float32)
        if "bnneck" in out:
            # per-part logits (B, P, classes): the mean over rows and parts
            onehot = onehot[:, None, :]
        if tcfg.use_focal:
            # on the softmax probabilities, as the JAX step has it
            l_id = L.sigmoid_focal_crossentropy(out["classprob"], onehot)
        else:
            l_id = L.softmax_crossentropy_logits(
                out["classprob_logits"], onehot, tcfg.label_smoothing)
        l_id = all_reduce_mean(l_id, group)
        metrics["id_ce"] = l_id
        metrics["acc"] = all_reduce_mean(
            L.accuracy(out["classprob"], onehot), group)
        total = total + (lw[1] if len(lw) > 1 else 1.0) * l_id

        if mcfg.aux_losses and "aux_logits" in out:
            # pad the weights with the last value (mj_uwyhNets_ba.py:880-884)
            while len(lw) < 2 + len(out["aux_logits"]):
                lw.append(lw[-1])
            for i, al in enumerate(out["aux_logits"]):
                l_aux = all_reduce_mean(L.softmax_crossentropy_logits(
                    al, onehot, tcfg.label_smoothing), group)
                metrics[f"aux_ce_{i}"] = l_aux
                total = total + lw[2 + i] * l_aux

    if "moe_aux" in out:
        # global routing gives every rank the global term; per shard it is
        # the shard's, averaged like the id terms
        moe_aux = out["moe_aux"]
        if not global_batch:
            moe_aux = all_reduce_mean(moe_aux, group)
        metrics["moe_aux"] = moe_aux
        total = total + tcfg.moe_aux_weight * moe_aux

    reg = l2_regularization(model, mcfg)
    metrics["reg"] = reg
    total = total + reg
    metrics["loss"] = total
    return total, metrics


def compute_losses(model: UGaitNet, batch: Batch, mcfg: ModelConfig,
                   tcfg: TrainConfig, key=None, group=None,
                   global_batch: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out = model(list(batch.volumes), list(batch.use_flags), key=key,
                group=group if global_batch else None)
    return losses_from_outputs(out, model, batch, mcfg, tcfg, group,
                               global_batch)


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    global_batch: bool = True):
    """step(state, batch) -> (state, metrics): one forward, backward and
    Adam update, in place.  The gradients of the step stay in ``.grad``.
    Dropout masks are keyed by ``state.step`` (the JAX step folds it into
    its dropout key), so a resumed run draws an uninterrupted run's.

    With a ``parallel.sharding.Mesh`` the batch is this rank's rows and
    the step is data parallel over the mesh's "data" axis: the global form
    (``global_batch``: the global batch's dropout masks, of which this rank
    keeps its rows) or the per-shard form (a dropout stream of the data
    index, never of another axis's, whose ranks hold the same rows and must
    draw the same masks); the gradients are then averaged over every
    rank.

    Traced (``obsv/spans.py``) as the span ``train.step`` with the step
    count as its id, holding ``train.forward`` (forward and losses),
    ``train.backward`` (with the gradient average) and ``train.update``:
    the host's time to enqueue each."""
    group = None if mesh is None else mesh.group(DATA_AXIS)
    if mesh is not None and global_batch:
        DG.refuse(mcfg, "global data parallelism")

    def step(state: TrainState, batch: Batch):
        sid = key = state.step
        if mesh is not None:
            b, i = batch.labels.shape[0], mesh.index(DATA_AXIS)
            key = (ShardKey(state.step, b * mesh.size(DATA_AXIS), i * b)
                   if global_batch else fold_key(state.step, i))
        with spans.span("train.step", sid):
            state.model.train()
            state.optimizer.zero_grad(set_to_none=True)
            with spans.span("train.forward", sid):
                total, metrics = compute_losses(state.model, batch, mcfg,
                                                tcfg, key=key, group=group,
                                                global_batch=global_batch)
            with spans.span("train.backward", sid):
                total.backward()
                if mesh is not None:
                    average_gradients(state.model, mesh)
            with spans.span("train.update", sid):
                state.optimizer.step()
            state.step += 1
            return state, {k: v.detach() for k, v in metrics.items()}
    return step


class PairBatch(NamedTuple):
    """Two aligned sample batches and same / different labels (1 = the
    same subject)."""
    batch1: Batch
    batch2: Batch
    pair_labels: torch.Tensor


def pair_keys(step: int) -> Tuple[int, int]:
    """The two sides' dropout keys at a step count: distinct from each
    other and from every other step's, as the JAX step splits
    ``fold_in(key, step)`` in two."""
    return 2 * step, 2 * step + 1


def embed_pair_side(model: UGaitNet, batch: Batch, key: Optional[int]
                    ) -> torch.Tensor:
    """One side of the pair step: the per-sample flattened signature."""
    sig = model(list(batch.volumes), list(batch.use_flags),
                key=key)["signature"]
    return sig.reshape(sig.shape[0], -1)


def make_pair_train_step(tcfg: TrainConfig):
    """step(state, pair) -> (state, metrics): Siamese verification training
    (the reference's UWYHNet): both sides run through the SAME weights, and
    ``verif_pair_loss`` at ``tcfg.margin`` pulls the signatures of same
    pairs together and pushes different ones apart.  Metric
    ``pair_loss``."""
    def step(state: TrainState, pair: PairBatch):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        k1, k2 = pair_keys(state.step)
        e1 = embed_pair_side(state.model, pair.batch1, k1)
        e2 = embed_pair_side(state.model, pair.batch2, k2)
        loss = L.verif_pair_loss(e1, e2, pair.pair_labels,
                                 margin=tcfg.margin)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"pair_loss": loss.detach()}
    return step


def make_eval_step(mcfg: ModelConfig, tcfg: TrainConfig):
    """step(model, batch) -> metrics, without gradients."""
    def step(model: UGaitNet, batch: Batch):
        model.eval()
        with torch.no_grad():
            _, metrics = compute_losses(model, batch, mcfg, tcfg)
        return metrics
    return step
