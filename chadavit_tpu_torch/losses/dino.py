"""DINO cross-entropy loss as a function, in PyTorch.

Counterpart of ``chadavit_tpu/losses/dino.py`` (``teacher_temp_schedule``
:29, ``dino_loss_and_center`` :49): the student logits are chunked by
``num_large_crops`` and the teacher's always in 2, same-view pairs are
skipped, the teacher temperature warms up linearly over epochs, and the EMA
center (part of the train state, not of a module) moves by the teacher batch
mean. The cross-replica center (the JAX ``axis_name`` path) belongs to the
port's parallel slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def teacher_temp_schedule(epoch, warmup_teacher_temp: float, teacher_temp: float,
                          warmup_teacher_temp_epochs: int) -> float:
    """Linear warmup then constant, in float32 as the JAX function computes it:
    ``np.linspace(a, b, n)[e] = a + (b - a) e / (n - 1)`` for ``e < n``."""
    f32 = np.float32
    e, n = f32(epoch), warmup_teacher_temp_epochs
    if n <= 0:
        return float(f32(teacher_temp))
    if n == 1:
        warm = f32(warmup_teacher_temp)
    else:
        warm = f32(warmup_teacher_temp) + f32(teacher_temp - warmup_teacher_temp) * e / f32(n - 1)
    return float(warm if e < n else f32(teacher_temp))


def dino_loss_and_center(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                         center: torch.Tensor, teacher_temp: float,
                         student_temp: float = 0.1, num_large_crops: int = 2,
                         center_momentum: float = 0.9) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, new_center)``. ``student_logits`` ``(crops * B, P)``
    crop-major, ``teacher_logits`` ``(2 B, P)``, ``center`` ``(1, P)``. The
    teacher side gets no gradient."""
    student_chunks = (student_logits / student_temp).chunk(num_large_crops, dim=0)
    teacher_probs = F.softmax((teacher_logits - center) / teacher_temp, dim=-1).detach()
    total = torch.zeros((), dtype=torch.float32, device=student_logits.device)
    n_terms = 0
    for iq, q in enumerate(teacher_probs.chunk(2, dim=0)):
        for iv, v in enumerate(student_chunks):
            if iv == iq:
                continue
            total = total + torch.sum(-q * F.log_softmax(v, dim=-1), dim=-1).mean()
            n_terms += 1
    loss = total / max(n_terms, 1)
    t = teacher_logits.detach()
    batch_center = t.sum(dim=0, keepdim=True) / t.shape[0]
    new_center = center * center_momentum + batch_center * (1.0 - center_momentum)
    return loss, new_center
