"""Experiment runner: chunked training loop with checkpointing, resume,
validation EER, LR plateau control, early stop and fine-tuning.

Port of ``ugaitnet_tpu/train/trainer.py`` (the reference training mains'
skeleton):

  * experiment dir named from the hyperparameters
  * config dump (config.json, the JAX package's format)
  * resume from the newest checkpoint, replaying the same batches
  * epochs run in ``save_every_epochs`` chunks; checkpoint per chunk, and
    the 'best' slot on the monitored val loss
  * per-chunk validation: eval-step metrics + verification EER on held-out
    videos
  * plateau lr control and the early stop on train accuracy, both
    persisted in controller.json and honoured on restart
  * optional extra_epochs fine-tune on train+val with the reference's
    new_lr heuristic

Validation's triplet is the training one (``batch_all``): on a card that is
the CUDA kernel.  The JAX trainer switches validation to its XLA version
only because of its mesh partitioner (ROADMAP.md section 3).

On a mesh (``parallel/``) every rank runs this Trainer: a plain ("data",)
mesh trains with the global form of ``parallel/sharding.py``, a ("data",
"seq") mesh with ``parallel/sequence.py``, a ("data", "expert") mesh with
``parallel/expert.py``, a ("data", "model") mesh with
``parallel/tensor.py``.  ``tcfg.pp_devices`` trains with branch placement
(``parallel/pipeline.py``) in this one process, over that many cards, or
CPU devices for a CPU ``device``.  Every rank builds the same sampler from
the same seed and loads the same global batch, of which it trains on its
part; it resumes from the step rank 0 found, validates the whole
validation view (the same numbers on every rank) and takes the plateau and
early-stop inputs from rank 0, so the ranks' learning rates never drift
apart.  Rank 0 alone writes config.json, norm stats, checkpoints (whole,
so a run resumes at any world size), metrics, controller.json and the
visual exports.
Sharded parameters (expert and tensor parallelism) are joined whole for
the save and sliced on load (``core/checkpoint.py:full_snapshot``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ugaitnet_tpu_torch.core import checkpoint as ckpt
from ugaitnet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                            TrainConfig, dump_json)
from ugaitnet_tpu_torch.core.device import DeviceLike, resolve_device
from ugaitnet_tpu_torch.data.pipeline import (GaitPipeline, PrefetchLoader,
                                              save_norm_stats)
from ugaitnet_tpu_torch.data.sampler import (BalancedGaitSampler,
                                             split_train_val_by_video)
from ugaitnet_tpu_torch.data.schema import GaitDataset
from ugaitnet_tpu_torch.eval.encode import encode_dataset
from ugaitnet_tpu_torch.eval.verification import verification_eer
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.obsv.logger import MetricsLogger
from ugaitnet_tpu_torch.parallel.expert import (make_ep_train_step,
                                                place_ep_model)
from ugaitnet_tpu_torch.parallel.pipeline import make_pipeline_train_step
from ugaitnet_tpu_torch.parallel.sequence import (make_sp_train_step,
                                                  shard_batch_sp,
                                                  sp_model_config)
from ugaitnet_tpu_torch.parallel.sharding import (broadcast_values,
                                                  device_list, replicate,
                                                  shard_batch)
from ugaitnet_tpu_torch.parallel.tensor import (make_tp_train_step,
                                                place_tp_model)
from ugaitnet_tpu_torch.train.schedule import (EarlyStopOnAccuracy,
                                               ReduceLROnPlateau)
from ugaitnet_tpu_torch.train.train_step import (Batch, TrainState, get_lr,
                                                 init_state, make_eval_step,
                                                 make_train_step, set_lr)


class _NullLogger:
    """The metrics logger of ranks other than 0."""

    def log(self, *args, **kwargs) -> None:
        pass

    def export_embeddings(self, *args, **kwargs) -> None:
        pass


def experiment_name(mcfg: ModelConfig, dcfg: DataConfig, tcfg: TrainConfig,
                    prefix: str = "exp") -> str:
    """Config-encoding directory name (the reference's subdir scheme)."""
    mods = "+".join(b.modality for b in mcfg.branches)
    parts = [prefix, mods, mcfg.branches[0].kind, f"mg{mcfg.merge}",
             f"bs{dcfg.batch_size:03d}", f"lr{tcfg.lr:.6f}",
             f"m{tcfg.margin:g}", f"op{tcfg.optimizer}"]
    if mcfg.nclasses > 0:
        parts.append(f"c{mcfg.nclasses}")
    if tcfg.triplet_kind != "batch_all":
        parts.append(tcfg.triplet_kind)
    return "_".join(parts)


def _write_json(path: str, rec: Dict) -> None:
    """Publish rec at path by rename, so a reader sees the old file or the
    new one."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, path)


def _sprite_thumbnails(ds: GaitDataset, modality: str, idx: np.ndarray,
                       cap: int = 256):
    """Middle-frame thumbnails of the first modality for the projector
    sprite sheet, capped: the sprite is a debugging visual, not worth
    unbounded IO on big val sets."""
    store = ds.modalities.get(modality)
    if store is None or len(idx) > cap:
        return None
    c = store.channels
    vols = np.asarray(store.volumes[np.asarray(idx)], np.float32)
    t_mid = (vols.shape[1] // c) // 2
    return [vols[i, t_mid * c] for i in range(len(idx))]


class Trainer:
    """warm_start: optional callable on the model's ``state_dict``, returning
    the state_dict to start from; applied once at a fresh start, never on
    resume.  device: None means the CUDA card.  mesh: this rank's
    ``parallel.sharding.Mesh`` (its device is the one trained on)."""

    def __init__(self, mcfg: ModelConfig, dcfg: DataConfig, tcfg: TrainConfig,
                 experdir: str, use_tensorboard: bool = False,
                 mesh=None, norm_stats=None,
                 warm_start: Optional[Callable[[Dict], Dict]] = None,
                 device: DeviceLike = None):
        axes = mesh.axis_names if mesh is not None else ()
        self.mesh = mesh
        self._sp, self._ep = "seq" in axes, "expert" in axes
        self._tp = "model" in axes
        self.pp_devices = None
        if tcfg.pp_devices:
            if mesh is not None:
                raise ValueError("pp_devices is exclusive with mesh modes")
            self.pp_devices = device_list(tcfg.pp_devices, device)
        self.main = mesh is None or mesh.is_main
        if mesh is not None:
            self.device = mesh.device
        elif self.pp_devices is not None:
            self.device = self.pp_devices[0]
        else:
            self.device = resolve_device(device)
        self.warm_start = warm_start
        self.norm_stats = norm_stats
        self.mcfg, self.dcfg, self.tcfg = mcfg, dcfg, tcfg
        self.experdir = experdir
        os.makedirs(experdir, exist_ok=True)
        if self.main:
            dump_json(os.path.join(experdir, "config.json"),
                      model=mcfg, data=dcfg, train=tcfg)
            if norm_stats is not None:
                # persisted so evaluation reproduces the standardization
                save_norm_stats(experdir, norm_stats)
        self.model_cfg = mcfg
        if self._sp:
            self.model_cfg = sp_model_config(mcfg)
            self.step_fn = make_sp_train_step(mcfg, tcfg, mesh)
        elif self._ep:
            self.step_fn = make_ep_train_step(mcfg, tcfg, mesh)
        elif self._tp:
            self.step_fn = make_tp_train_step(mcfg, tcfg, mesh)
        elif self.pp_devices is not None:
            self.step_fn = None     # made with the model (init_or_resume)
        else:
            # one process, or the global data-parallel form on a mesh
            self.step_fn = make_train_step(mcfg, tcfg, mesh)
        self.eval_step = make_eval_step(mcfg, tcfg)
        self.logger = (MetricsLogger(experdir, use_tensorboard) if self.main
                       else _NullLogger())
        self.modalities = tuple(b.modality for b in mcfg.branches)
        self._ckpt_writer = (ckpt.AsyncCheckpointWriter()
                             if tcfg.async_checkpoint and self.main else None)
        self._export_warned = False

    def _save_ckpt(self, step, state: TrainState) -> None:
        """Rank 0 writes; under expert and tensor parallelism every rank
        first helps join the shards whole."""
        if self._ep or self._tp:
            state = ckpt.full_snapshot(state)
        if not self.main:
            return
        if self._ckpt_writer is not None:
            self._ckpt_writer.save(self.experdir, step, state)
        else:
            ckpt.save_checkpoint(self.experdir, step, state)

    # ------------------------------------------------------------------
    def _controller_path(self) -> str:
        return os.path.join(self.experdir, "controller.json")

    def _load_controller_state(self):
        try:
            with open(self._controller_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _save_controller_state(self, plateau: ReduceLROnPlateau,
                               best_monitor: float,
                               early_stopped: bool = False) -> None:
        """Publish controller.json after the checkpoints saved before it
        (with async saves, on the writer's thread behind them): a restart
        may read a record older than its checkpoint, never a newer one."""
        if not self.main:
            return
        rec = {"plateau_best": float(plateau.best),
               "plateau_wait": int(plateau.wait),
               "best_monitor": float(best_monitor),
               "early_stopped": bool(early_stopped)}
        if self._ckpt_writer is not None:
            self._ckpt_writer.submit(_write_json, self._controller_path(), rec)
        else:
            _write_json(self._controller_path(), rec)

    # ------------------------------------------------------------------
    def _broadcast(self, values):
        return broadcast_values(values, self.mesh)

    def init_or_resume(self, seed: int = 0) -> Tuple[TrainState, int]:
        model = UGaitNet(self.model_cfg, device=self.device, seed=seed,
                         mesh=self.mesh)
        last = ckpt.latest_checkpoint_step(self.experdir)
        # every rank resumes from the step rank 0 found
        last = self._broadcast([-1 if last is None else last])[0]
        last = None if last < 0 else int(last)
        if last is None and self.warm_start is not None:
            model.load_state_dict(self.warm_start(model.state_dict()))
            print("* warm-started params", flush=True)
        if self.mesh is not None:
            # every rank starts from rank 0's weights
            replicate(model, self.mesh)
        if self._ep:
            place_ep_model(model, self.mesh)
        if self._tp:
            place_tp_model(model, self.mesh)
        state = init_state(model, self.tcfg)
        if self.pp_devices is not None:
            self.step_fn = make_pipeline_train_step(
                model, state.optimizer, self.mcfg, self.tcfg,
                self.pp_devices)
        if last is None:
            return state, 0
        if self._ep or self._tp:
            # a whole checkpoint, of which this rank keeps its shards
            ckpt.load_full(state, ckpt.restore_raw(self.experdir, last))
        else:
            state = ckpt.restore_checkpoint(self.experdir, last, state)
        print(f"* resumed from epoch {last}", flush=True)
        return state, last

    # A non-finite loss at step k is surfaced at the next check (at most
    # DIVERGENCE_CHECK_EVERY steps later): recovery is "resume from the last
    # per-chunk checkpoint" either way, so the delay costs nothing.
    DIVERGENCE_CHECK_EVERY = 25

    def _epoch(self, state: TrainState, pipe: GaitPipeline,
               sampler: BalancedGaitSampler, epoch: int, seed: int
               ) -> Tuple[TrainState, Dict[str, float]]:
        """One pass over the sampler.

        The loop never waits for the device per step: metrics stay on the
        device and are stacked and copied once at epoch end, and the
        divergence check reads one scalar every DIVERGENCE_CHECK_EVERY
        steps."""
        nsteps = max(len(sampler), 1)
        hist = []
        for bix, (vols, flags, labels) in enumerate(
                PrefetchLoader(pipe, sampler, seed, epoch)):
            state, metrics = self.step_fn(
                state, self._shard(Batch(tuple(vols), tuple(flags), labels)))
            hist.append(metrics)
            if (bix + 1) % self.DIVERGENCE_CHECK_EVERY == 0:
                self._raise_if_diverged([float(metrics["loss"])], epoch, bix)
        if not hist:
            return state, {}
        keys = sorted(hist[0])
        host = torch.stack([torch.stack([m[k] for k in keys])
                            for m in hist]).cpu().tolist()
        self._raise_if_diverged([row[keys.index("loss")] for row in host],
                                epoch, len(host) - 1)
        agg: Dict[str, float] = {}
        for row in host:
            for k, v in zip(keys, row):
                agg[k] = agg.get(k, 0.0) + v
        return state, {k: v / nsteps for k, v in agg.items()}

    def _shard(self, batch: Batch) -> Batch:
        """This rank's part of the global batch."""
        if self._sp:
            return shard_batch_sp(batch, self.mesh)
        if self.mesh is not None:
            return shard_batch(batch, self.mesh)
        return batch

    def _raise_if_diverged(self, losses, epoch: int, last_bix: int) -> None:
        """Surface divergence with a recoverable message instead of
        training on garbage (resume from the last per-chunk checkpoint)."""
        for off, loss in enumerate(losses):
            if not np.isfinite(loss):
                bix = last_bix - (len(losses) - 1 - off)
                raise FloatingPointError(
                    f"non-finite loss {loss} at epoch {epoch} step "
                    f"~{bix}; restart resumes from the last checkpoint "
                    f"in {self.experdir}")

    def _val_metrics(self, state: TrainState, val_pipe: GaitPipeline
                     ) -> Dict[str, float]:
        """Averaged eval-step metrics (incl. the full training objective as
        val loss) over the validation view, whose loss drives the plateau.

        The val view is shuffled once with a fixed seed, then walked in
        fixed-size batches, so the metric is comparable across chunks.  The
        trailing partial batch is padded to the batch size by wrapping
        samples from the start of the shuffled order (batch losses like the
        triplet need a full batch), and every batch's metrics are weighted
        by its count of first-occurrence samples.  The values are read once,
        after the last batch."""
        n = len(val_pipe.indices)
        bs = min(n, self.dcfg.batch_size)
        order = np.random.RandomState(1234).permutation(n)
        nb = max(1, -(-n // bs))
        rows, weights = [], []
        for i in range(nb):
            bidx = order[i * bs:(i + 1) * bs]
            fresh = len(bidx)
            if fresh < bs:
                bidx = np.concatenate([bidx, order[:bs - fresh]])
            vols, flags, labels = val_pipe.load(bidx, expand=1)
            metrics = self.eval_step(
                state.model, Batch(tuple(vols), tuple(flags), labels))
            keys = sorted(metrics)
            rows.append(torch.stack([metrics[k] for k in keys]))
            weights.append(fresh)
        agg: Dict[str, float] = {}
        for fresh, row in zip(weights, torch.stack(rows).cpu().tolist()):
            for k, v in zip(keys, row):
                agg[k] = agg.get(k, 0.0) + fresh * v
        total_w = float(sum(weights))
        return {k: v / total_w for k, v in agg.items()}

    def _validate(self, state: TrainState, ds: GaitDataset,
                  val_idx: np.ndarray, epoch: int = 0) -> Dict[str, float]:
        codes, labels, _, _ = encode_dataset(
            state.model, ds, self.modalities, typecode=3,
            batch_size=max(self.dcfg.batch_size, 32), indices=val_idx,
            norm_stats=self.norm_stats)
        # projector export + first-conv filter images, like the TUM mains'
        # per-chunk visual logging
        if not self.main:
            return verification_eer(codes, labels)
        try:
            self.logger.export_embeddings(
                epoch, codes, labels,
                images=_sprite_thumbnails(ds, self.modalities[0], val_idx))
            from ugaitnet_tpu_torch.utils.net_utils import save_filter_grid
            sd = state.model.state_dict()
            prefix = f"branches.branch_{self.modalities[0]}"
            first = sd.get(f"{prefix}.a_conv1.weight",
                           sd.get(f"{prefix}.conv0.weight"))
            if first is not None:
                save_filter_grid(first.cpu().numpy(),
                                 os.path.join(self.experdir, "filters",
                                              f"conv1_{epoch:04d}.png"))
        except Exception:
            # visual exports are best-effort (training must not die on a
            # TB/PNG path, e.g. without PIL), but a broken export is shown
            # once per run
            if not self._export_warned:
                self._export_warned = True
                logging.getLogger(__name__).warning(
                    "projector/filter export failed (epoch %d); "
                    "suppressing further warnings for this run",
                    epoch, exc_info=True)
        return verification_eer(codes, labels)

    # ------------------------------------------------------------------
    def fit(self, ds: GaitDataset, val_perc: float = 0.08,
            seed: int = 0) -> TrainState:
        try:
            state = self._fit(ds, val_perc=val_perc, seed=seed)
        finally:
            # async saves are durable before fit returns (callers evaluate
            # the checkpoint next) and before an exception propagates (a
            # divergence abort still keeps its last chunk)
            if self._ckpt_writer is not None:
                self._ckpt_writer.wait()
        if self.mesh is not None:
            # no rank reads a checkpoint before rank 0 has published it
            import torch.distributed as dist
            dist.barrier()
        return state

    @staticmethod
    def _fast_forward(sampler: BalancedGaitSampler, epochs: int) -> None:
        """Advance the sampler past ``epochs`` epochs: it carries
        cross-epoch pointer and shuffle state, so a fresh sampler at epoch k
        would feed different batches than an uninterrupted run's epoch k.
        Index arithmetic only."""
        for _ in range(epochs):
            for _ in sampler.epoch():
                pass

    def _fit(self, ds: GaitDataset, val_perc: float,
             seed: int) -> TrainState:
        tcfg, dcfg = self.tcfg, self.dcfg
        tr_idx, val_idx = split_train_val_by_video(ds.video_ids,
                                                   perc=val_perc, seed=seed)
        labmap = ds.label_map()
        pipe = GaitPipeline(ds, dcfg, self.modalities, labmap=labmap,
                            indices=tr_idx, norm_stats=self.norm_stats,
                            device=self.device)
        sampler = BalancedGaitSampler(ds.labels[tr_idx], ds.gaits[tr_idx],
                                      dcfg.batch_size, dcfg.repetitions,
                                      seed=seed,
                                      gait_groups=dcfg.gait_groups)
        state, epoch = self.init_or_resume(seed)
        self._fast_forward(sampler, epoch)
        val_pipe = None
        if len(val_idx) > 0:
            val_pipe = GaitPipeline(
                ds, dataclasses.replace(dcfg, augment=False),
                self.modalities, labmap=labmap, indices=val_idx,
                norm_stats=self.norm_stats, device=self.device)
        # plateau starts from the *resumed* lr (not tcfg.lr) and reloads its
        # best/wait counters, so a restart never undoes prior reductions
        plateau = ReduceLROnPlateau(lr=get_lr(state), factor=0.1, patience=3,
                                    min_lr=tcfg.lr * 1e-3)
        cstate = self._load_controller_state()
        if cstate:
            plateau.best = cstate.get("plateau_best", plateau.best)
            plateau.wait = cstate.get("plateau_wait", plateau.wait)
        best_monitor = (cstate or {}).get("best_monitor", np.inf)
        early = EarlyStopOnAccuracy(0.99)
        # the stop decision survives a restart: resuming from the early-stop
        # checkpoint would otherwise train on toward tcfg.epochs
        early_stopped = bool((cstate or {}).get("early_stopped", False))
        if early_stopped:
            print("* early stop recorded in controller.json; skipping the "
                  "main loop", flush=True)

        while not early_stopped and epoch < tcfg.epochs:
            if len(sampler) == 0:
                raise ValueError(
                    f"training split has {len(sampler.labels)} samples, "
                    f"fewer than batch_size={dcfg.batch_size}; no batch "
                    "can be formed (the run would silently do nothing)")
            state, m = self._epoch(state, pipe, sampler, epoch, seed)
            epoch += 1
            m["lr"] = get_lr(state)
            self.logger.log(epoch, m, prefix="train/")
            if epoch % tcfg.save_every_epochs == 0 or epoch == tcfg.epochs:
                self._save_ckpt(epoch, state)
                # plateau monitors val loss like the reference's
                # ReduceLROnPlateau(monitor='val_loss'); train loss is the
                # fallback only when there is no validation split
                monitored = m.get("loss", 0.0)
                if val_pipe is not None:
                    vm = self._val_metrics(state, val_pipe)
                    vm.update(self._validate(state, ds, val_idx, epoch))
                    self.logger.log(epoch, vm, prefix="val/")
                    monitored = vm.get("loss", monitored)
                monitored = self._broadcast([monitored])[0]
                if monitored < best_monitor:
                    best_monitor = monitored
                    self._save_ckpt("best", state)
                new_lr = plateau.update(monitored)
                if not np.isclose(new_lr, get_lr(state), rtol=1e-5):
                    state = set_lr(state, new_lr)
                    print(f"* lr -> {new_lr:g}", flush=True)
                self._save_controller_state(plateau, best_monitor)
            if "acc" in m and early.update(self._broadcast([m["acc"]])[0]):
                print(f"* early stop at epoch {epoch} (train acc "
                      f"{m['acc']:.3f})", flush=True)
                early_stopped = True
                break

        self._save_ckpt(epoch, state)
        if early_stopped:
            # recorded only behind the checkpoint of the stop epoch: a
            # restart that reads it skips the loop and keeps that checkpoint
            self._save_controller_state(plateau, best_monitor,
                                        early_stopped=True)

        # ---- extra fine-tune on train+val with the new_lr heuristic ----
        if tcfg.extra_epochs > 0 and len(val_idx) > 0:
            last_lr = get_lr(state)
            if self.mcfg.nclasses == 150:
                new_lr = (10 ** math.ceil(math.log10(last_lr))) * 0.1
            else:
                new_lr = min(10 ** math.ceil(math.log10(last_lr)), last_lr)
            state = set_lr(state, new_lr)
            full_pipe = GaitPipeline(ds, dcfg, self.modalities,
                                     labmap=labmap,
                                     norm_stats=self.norm_stats,
                                     device=self.device)
            full_sampler = BalancedGaitSampler(ds.labels, ds.gaits,
                                               dcfg.batch_size,
                                               dcfg.repetitions, seed=seed,
                                               gait_groups=dcfg.gait_groups)
            # the reference fine-tunes from epoch `epochs` to epochs + extra,
            # i.e. exactly extra_epochs, even when early stopping ended the
            # main loop sooner
            epoch = max(epoch, tcfg.epochs)
            target = tcfg.epochs + tcfg.extra_epochs
            while epoch < target:
                state, m = self._epoch(state, full_pipe, full_sampler,
                                       epoch, seed)
                epoch += 1
                self.logger.log(epoch, m, prefix="finetune/")
                if (epoch % tcfg.save_every_epochs == 0
                        or epoch == target):
                    self._save_ckpt(epoch, state)

        return state
