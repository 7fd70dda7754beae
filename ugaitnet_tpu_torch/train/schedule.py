"""LR scheduling and early stopping as explicit host-side controllers.

The port's own copy of ``ugaitnet_tpu/train/schedule.py`` (numpy only), so
the port imports nothing of the JAX package.  The plateau logic is a small
host state machine (exactly how Keras callbacks mutate optimizer.lr); the
trainer writes its lr into the optimizer's param groups
(``train/train_step.py:set_lr``):

  * ReduceLROnPlateau — Keras semantics, used by the TUM mains
    (the reference's mains/mj_trainUWYHGaitNet_DataGen_1mod.py:245-248).
  * ReduceLROnPlateauOrSlowdown — the reference's relative-min-delta variant
    (its callbacks/lr_scheduler.py:7-127; dead code there, a
    first-class option here).
  * EarlyStopOnAccuracy — stop when train accuracy exceeds a threshold
    (mains/..._1mod.py:615-620, acc > 0.99).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.1
    patience: int = 10
    min_delta: float = 1e-4
    cooldown: int = 0
    min_lr: float = 0.0
    mode: str = "min"

    wait: int = 0
    cooldown_counter: int = 0
    best: float = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.best is None:
            self.best = np.inf if self.mode == "min" else -np.inf

    def _improved(self, current: float) -> bool:
        if self.mode == "min":
            return current < self.best - self.min_delta
        return current > self.best + self.min_delta

    def update(self, current: float) -> float:
        """Feed the monitored metric for one epoch; returns current lr."""
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._improved(current):
            self.best = current
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience and self.lr > self.min_lr:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.wait = 0
        return self.lr


@dataclass
class ReduceLROnPlateauOrSlowdown(ReduceLROnPlateau):
    """Relative min_delta: an epoch counts as improvement only if the metric
    moved by more than min_delta *fraction of the best* (lr_scheduler.py:86-92)."""
    min_delta: float = 0.01

    def _improved(self, current: float) -> bool:
        if np.isinf(self.best):
            # first FINITE observation seeds best: with the +/-inf initial
            # best the relative threshold is inf*min_delta, which is nan at
            # min_delta=0 — comparisons would stay False forever, best
            # would never seed, and the LR would decay every `patience`
            # epochs even while the metric improved.  A nan metric (diverging
            # run) must never seed or count as improvement — it would re-seed
            # best every epoch, wait would never accumulate, and the LR would
            # never drop exactly when the run needs it to
            return np.isfinite(current)
        if self.mode == "min":
            # reference: less(best - current, best * min_delta) is the
            # *plateau* test; improvement is its complement.  No abs():
            # for a negative-valued metric the reference's threshold goes
            # negative too (almost any non-worsening epoch counts) — quirk
            # reproduced, not "fixed"
            return (self.best - current) >= self.best * self.min_delta
        # deliberate deviation: the reference's max branch tests
        # greater(best + current, best * min_delta) (lr_scheduler.py:87),
        # which is always-true for positive metrics — dead code with a
        # broken formula; we use the symmetric relative-improvement test
        return (current - self.best) >= abs(self.best) * self.min_delta


@dataclass
class EarlyStopOnAccuracy:
    threshold: float = 0.99
    patience: int = 1

    hits: int = 0

    def update(self, accuracy: float) -> bool:
        """Returns True when training should stop."""
        if accuracy > self.threshold:
            self.hits += 1
        else:
            self.hits = 0
        return self.hits >= self.patience
