"""Checkpointing and resume, in a torch format.

Port of ``ugaitnet_tpu/core/checkpoint.py`` with the same layout: one
checkpoint per saved epoch under ``<experdir>/ckpt/<epoch>/`` plus the
``ckpt/best/`` slot, each holding one torch file, ``state.pt``, with the
step, the model's ``state_dict`` and the optimizer's ``state_dict``, all on
the CPU.  Files load with ``torch.load(..., weights_only=True)``.

A file is published atomically: it is written under a temporary name in its
step directory and renamed into place, so a process killed mid-write never
leaves a step that ``latest_checkpoint_step`` picks up (a step counts only
once its ``state.pt`` exists), and an overwritten 'best' is either the old
file or the new one.

Also provides "surgery" restore: load a checkpoint whose classifier head has
a different class count, keeping every compatible weight (Keras
load_weights(by_name=True, skip_mismatch=True) parity).
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import re
import tempfile
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"


def _ckpt_root(experdir: str) -> str:
    return os.path.join(os.path.abspath(experdir), "ckpt")


def _step_dir(step) -> str:
    """Integer epochs plus the special 'best' slot
    (ModelCheckpoint(save_best_only=True) parity)."""
    return "best" if step == "best" else str(int(step))


def checkpoint_path(experdir: str, step) -> str:
    """The file of step ``step`` (an epoch or 'best')."""
    return os.path.join(_ckpt_root(experdir), _step_dir(step), STATE_FILE)


def _to_cpu(tree):
    """A copy of a state_dict tree with every tensor detached and copied to
    the CPU (a copy even for CPU tensors: the train step updates the live
    ones in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def snapshot(state) -> Dict[str, Any]:
    """{"step", "model", "optimizer"} of a ``TrainState``, on the CPU; a bare
    module gives {"step": 0, "model": ...}."""
    if isinstance(state, torch.nn.Module):
        return {"step": 0, "model": _to_cpu(state.state_dict())}
    return {"step": int(state.step),
            "model": _to_cpu(state.model.state_dict()),
            "optimizer": _to_cpu(state.optimizer.state_dict())}


def _publish(path: str, payload: Dict[str, Any]) -> str:
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".state-", suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def save_checkpoint(experdir: str, step, state) -> str:
    """Save a ``TrainState`` (or a bare module) at an integer epoch or
    'best', blocking until the file is published."""
    return _publish(checkpoint_path(experdir, step), snapshot(state))


class AsyncCheckpointWriter:
    """Checkpoint saves that do not wait for the disk.

    ``save()`` copies the state to the CPU synchronously (the train step
    updates parameters and moments in place, so the values must be read
    before training goes on), then hands the write to one background thread.
    Writes run one at a time, in order; ``save()`` blocks only while
    ``MAX_PENDING`` snapshots are already queued, which bounds the host
    memory they hold.  An exception of a write is raised again at the next
    ``save()`` or ``wait()``.  ``wait()`` must run before a just-written
    checkpoint is read and before the process exits; ``Trainer.fit`` calls
    it before it returns or raises, and ``close()`` (the context manager's
    exit) also stops the thread.
    """

    MAX_PENDING = 2

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        # (future, holds a snapshot)
        self._pending: "collections.deque" = collections.deque()

    def _reap(self, block: bool) -> None:
        while self._pending and (
                block or self._pending[0][0].done()
                or sum(s for _, s in self._pending) >= self.MAX_PENDING):
            self._pending.popleft()[0].result()   # raises a failed write

    def save(self, experdir: str, step, state) -> str:
        self._reap(block=False)
        path = checkpoint_path(experdir, step)
        self._pending.append((self._pool.submit(_publish, path,
                                                snapshot(state)), True))
        return path

    def submit(self, fn, *args) -> None:
        """Run fn(*args) on the writer thread after every write queued
        before it: a small record that describes the checkpoints (the
        trainer's controller.json) is never published ahead of them, and
        does not count against MAX_PENDING."""
        self._reap(block=False)
        self._pending.append((self._pool.submit(fn, *args), False))

    def wait(self) -> None:
        self._reap(block=True)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def has_best_checkpoint(experdir: str) -> bool:
    return os.path.exists(checkpoint_path(experdir, "best"))


def latest_checkpoint_step(experdir: str, epoch_max: Optional[int] = None
                           ) -> Optional[int]:
    """Newest published step <= epoch_max (mj_findLatestFileModel parity);
    only digit-named directories holding a published file count."""
    root = _ckpt_root(experdir)
    if not os.path.isdir(root):
        return None
    steps = [int(d) for d in os.listdir(root) if re.fullmatch(r"\d+", d)
             and os.path.exists(os.path.join(root, d, STATE_FILE))]
    if epoch_max is not None:
        steps = [s for s in steps if s <= epoch_max]
    return max(steps) if steps else None


def restore_raw(experdir: str, step) -> Dict[str, Any]:
    """A checkpoint's payload, {"step", "model", "optimizer"}, on the CPU."""
    return torch.load(checkpoint_path(experdir, step), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(experdir: str, step, state):
    """Load a checkpoint into ``state`` (a ``TrainState``: the model's
    parameters, the optimizer's step counts, moments and lr, and the step;
    or a bare module) in place, on their devices, and return it."""
    raw = restore_raw(experdir, step)
    if isinstance(state, torch.nn.Module):
        state.load_state_dict(raw["model"])
        return state
    state.model.load_state_dict(raw["model"])
    state.optimizer.load_state_dict(raw["optimizer"])
    state.step = int(raw["step"])
    return state


def restore_params_surgery(experdir: str, step, target_params: Dict
                           ) -> Dict:
    """A model state_dict from the checkpoint, keeping target's entries
    wherever shapes mismatch (classifier-head surgery when nclasses
    changes)."""
    return merge_matching(target_params, restore_raw(experdir, step)["model"])


def merge_matching(target: Any, source: Any) -> Any:
    """Walk two nested trees (dicts, lists, tuples) by key, taking source
    leaves wherever the shapes match and keeping target's elsewhere (the
    Keras load_weights(by_name=True, skip_mismatch=True) semantics)."""
    if isinstance(target, dict):
        return {k: (merge_matching(v, source.get(k))
                    if isinstance(source, dict) else v)
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if isinstance(source, (list, tuple)) and len(source) == len(target):
            return type(target)(merge_matching(t, s)
                                for t, s in zip(target, source))
        return target
    if source is None or not isinstance(target, torch.Tensor):
        return target
    source = torch.as_tensor(source)
    if source.shape == target.shape:
        return source.to(dtype=target.dtype, device=target.device)
    return target
