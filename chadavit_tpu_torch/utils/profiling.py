"""Per-step timing of the train loop.

Counterpart of ``chadavit_tpu/utils/profiling.py::StepTimer`` (:472): rolling
wall-clock step times after a warm-up. Where the JAX loop's step returns
device arrays and the timer ticks on the host, a CUDA step returns before
the card finishes, so :meth:`StepTimer.tick` synchronizes the device first
(``sync=True``) and a step's time is its device time plus the host's share.
``tick(wait)`` also takes the seconds the loop waited for the step's batch,
so that ``data_wait_s`` says how long the host loader held the card idle.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch


class StepTimer:
    """Rolling per-step wall-clock stats; call ``tick()`` after each step."""

    def __init__(self, warmup: int = 2, device: Optional[torch.device] = None):
        self.warmup = warmup
        self.sync = device is not None and torch.device(device).type == "cuda"
        self.device = device
        self.n = 0
        self.total = 0.0
        self.wait_total = 0.0
        self.last: Optional[float] = None
        self._t = time.perf_counter()

    def tick(self, wait: float = 0.0) -> float:
        if self.sync:
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        dt = now - self._t
        self._t = now
        self.last = dt
        self.n += 1
        if self.n > self.warmup:
            self.total += dt
            self.wait_total += wait
        return dt

    @property
    def mean(self) -> float:
        steps = max(self.n - self.warmup, 1)
        return self.total / steps

    def images_per_sec(self, batch_size: int) -> float:
        return batch_size / self.mean if self.mean > 0 else 0.0

    def summary(self, batch_size: int) -> Dict[str, float]:
        return {"step_time_s": self.mean, "images_per_sec": self.images_per_sec(batch_size),
                "data_wait_s": self.wait_total / max(self.n - self.warmup, 1)}
