"""Step-indexed schedules, on the host.

Counterpart of ``chadavit_tpu/train/schedules.py``: linear warmup then cosine
lr (the closed form of the reference's ``LinearWarmupCosineAnnealingLR``),
the EMA tau cosine, multistep and exponential lr, the factory, and the
host-side ``ReduceLROnPlateau`` controller :class:`PlateauScale`. The JAX
functions compute in float32 on traced steps; these compute the same float32
arithmetic with numpy scalars and return Python floats.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32


def warmup_cosine_lr(step, base_lr: float, total_steps: int, warmup_steps: int,
                     warmup_start_lr: float = 0.0, min_lr: float = 0.0) -> float:
    """Linear warmup then cosine annealing (reference ``lr_scheduler.py:127-149``)."""
    step = f32(step)
    if warmup_steps <= 0:
        warm = f32(base_lr)
    elif warmup_steps == 1:
        warm = f32(warmup_start_lr)
    else:
        warm = f32(warmup_start_lr) + step * f32(base_lr - warmup_start_lr) / f32(warmup_steps - 1)
    if step < warmup_steps:
        return float(warm)
    denom = f32(max(total_steps - warmup_steps, 1))
    cos = f32(min_lr) + f32(0.5 * (base_lr - min_lr)) * (
        f32(1.0) + np.cos(f32(np.pi) * (step - f32(warmup_steps)) / denom))
    return float(cos)


def cosine_tau(step, max_steps: int, base_tau: float, final_tau: float) -> float:
    """EMA momentum coefficient (reference ``momentum.py:84-87``)."""
    step = f32(step)
    c = np.cos(f32(np.pi) * step / f32(max(max_steps, 1)))
    return float(f32(final_tau) - f32(final_tau - base_tau) * (c + f32(1.0)) / f32(2.0))


def multistep_lr(step, base_lr: float, decay_steps, gamma: float = 0.1) -> float:
    """MultiStepLR (reference ``base.py:474``)."""
    factor = f32(1.0)
    for s in decay_steps:
        factor = factor * (f32(gamma) if step >= s else f32(1.0))
    return float(f32(base_lr) * factor)


def exponential_lr(step, base_lr: float, gamma: float = 0.95) -> float:
    """ExponentialLR, per step."""
    return float(f32(base_lr) * np.power(f32(gamma), f32(step)))


def make_lr_schedule(name: str, base_lr: float, total_steps: int,
                     warmup_steps: int = 0, warmup_start_lr: float = 0.0,
                     min_lr: float = 0.0, decay_steps=(), gamma: float = 0.1):
    """Schedule factory for the reference's scheduler names
    (``base.py:460-492``): warmup_cosine / step / exponential / none / reduce
    (a constant lr; the plateau decay is :class:`PlateauScale`)."""
    if name in ("warmup_cosine", None):
        return lambda step: warmup_cosine_lr(step, base_lr, total_steps, warmup_steps,
                                             warmup_start_lr, min_lr)
    if name == "step":
        return lambda step: multistep_lr(step, base_lr, decay_steps, gamma)
    if name == "exponential":
        return lambda step: exponential_lr(step, base_lr, gamma)
    if name in ("none", "reduce"):
        return lambda step: float(f32(base_lr))
    raise ValueError(f"unknown scheduler {name!r}; "
                     "expected warmup_cosine/step/exponential/none/reduce")


class PlateauScale:
    """Host-side ReduceLROnPlateau controller (torch defaults: mode=min,
    factor=0.1, patience=10, threshold=1e-4 rel, cooldown=0), reference
    ``src/methods/linear.py:360-361``: it watches a per-epoch metric and
    returns the lr multiplier."""

    def __init__(self, mode: str = "min", factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_scale: float = 0.0, eps: float = 1e-8):
        if mode not in ("min", "max") or threshold_mode not in ("rel", "abs"):
            raise ValueError(f"mode {mode!r}, threshold_mode {threshold_mode!r}")
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_scale, self.eps = cooldown, min_scale, eps
        self.scale = 1.0
        self.best = float("inf") if mode == "min" else -float("inf")
        self.num_bad = 0
        self.cooldown_counter = 0

    def _is_better(self, metric: float) -> bool:
        if self.mode == "min":
            thr = (self.best * (1.0 - self.threshold) if self.threshold_mode == "rel"
                   else self.best - self.threshold)
            return metric < thr
        thr = (self.best * (1.0 + self.threshold) if self.threshold_mode == "rel"
               else self.best + self.threshold)
        return metric > thr

    def step(self, metric: float) -> float:
        """Record one epoch's monitored metric; returns the current scale."""
        if self._is_better(float(metric)):
            self.best = float(metric)
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:  # cooldown suppresses bad-epoch counting
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            new = max(self.scale * self.factor, self.min_scale)
            if self.scale - new > self.eps:  # torch's eps guard on tiny deltas
                self.scale = new
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.scale
