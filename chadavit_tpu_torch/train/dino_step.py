"""The DINO pretraining step, in PyTorch.

Counterpart of ``chadavit_tpu/train/dino_step.py`` (``DinoStepConfig`` :40,
``_clip_backbone_grads`` :72, ``make_dino_eval_loss`` :84,
``make_dino_train_step`` :116). One call of the step, as ``dino_step.py:152-268``:

- the teacher forward (EMA parameters, no grad) on both global crops as one
  ``(2B, C, H, W)`` pass, crop-major;
- the student forward with autograd and the head, the DINO loss and the new
  center, the backward;
- the per-parameter L2 clip of the backbone gradients (``dino.py:249-261``);
- the prototype freeze for the first ``freeze_last_layer`` epochs;
- the optimizer update, the EMA teacher with cosine tau, the center update.

``backbone_apply(backbone, crops, channel_counts) -> (M, D)`` and
``head_apply(head, feats) -> (M, P)`` take the modules, so that a caller can
pass a plain backbone. The state is updated in place: the parameters take
their updates with ``add_`` and the EMA runs as ``torch._foreach_mul_`` /
``_foreach_add_`` on the teacher. The online classifier (``num_classes > 0``)
and gradient accumulation (``accumulate > 1``) are not ported and raise.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from chadavit_tpu_torch.losses.dino import dino_loss_and_center, teacher_temp_schedule
from chadavit_tpu_torch.train.schedules import cosine_tau, warmup_cosine_lr
from chadavit_tpu_torch.train.state import DinoState

LAST_LAYER = ("head.last_layer.weight_v", "head.last_layer.weight_g")


class DinoStepConfig(NamedTuple):
    """The step's configuration (the JAX step's static fields)."""

    num_large_crops: int = 2
    student_temp: float = 0.1
    base_lr: float = 0.0
    warmup_steps: int = 0
    warmup_start_lr: float = 0.0
    min_lr: float = 0.0
    warmup_teacher_temp: float = 0.04
    teacher_temp: float = 0.07
    warmup_teacher_temp_epochs: int = 0
    center_momentum: float = 0.9
    clip_grad: float = 0.0
    freeze_last_layer: int = 1
    base_tau: float = 0.996
    final_tau: float = 1.0
    total_steps: int = 1
    steps_per_epoch: int = 1
    accumulate: int = 1
    num_classes: int = 0
    momentum_classifier: bool = False


def _clip_backbone_grads(grads, clip: float):
    """Per-parameter L2 clip (reference ``dino_clip_gradients``,
    ``dino.py:249-261``): a gradient whose norm exceeds ``clip`` is scaled by
    ``clip / (norm + 1e-6)``."""
    out = []
    for g in grads:
        coef = clip / (torch.linalg.vector_norm(g) + 1e-6)
        out.append(torch.where(coef < 1.0, g * coef, g))
    return out


def _flatten(batch):
    crops, cc = batch["crops"], batch["channel_counts"]
    nc, b = crops.shape[0], crops.shape[1]
    return nc, crops.reshape((nc * b,) + tuple(crops.shape[2:])), cc.repeat(nc)


def _teacher_temp(cfg: DinoStepConfig, epoch: int) -> float:
    return teacher_temp_schedule(epoch, cfg.warmup_teacher_temp, cfg.teacher_temp,
                                 cfg.warmup_teacher_temp_epochs)


def _check_supported(cfg: DinoStepConfig) -> None:
    if cfg.num_classes > 0:
        raise NotImplementedError("the online classifier (num_classes > 0) is not ported yet")
    if cfg.accumulate > 1:
        raise NotImplementedError("gradient accumulation (accumulate > 1) is not ported yet")


def make_dino_eval_loss(backbone_apply: Callable, head_apply: Callable,
                        cfg: DinoStepConfig) -> Callable:
    """SSL validation loss (reference ``DINO.validation_step``,
    ``dino.py:327-365``): the DINO cross-entropy on held-out crops with the
    current center and temperature, without updating them."""
    _check_supported(cfg)

    @torch.no_grad()
    def eval_loss(state: DinoState, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        _, flat, cc_rep = _flatten(batch)
        temp = _teacher_temp(cfg, state.step // cfg.steps_per_epoch)
        s_z = head_apply(state.student["head"],
                         backbone_apply(state.student["backbone"], flat, cc_rep))
        t_z = head_apply(state.teacher["head"],
                         backbone_apply(state.teacher["backbone"], flat, cc_rep))
        loss, _ = dino_loss_and_center(
            s_z.float(), t_z.float(), state.center, temp, student_temp=cfg.student_temp,
            num_large_crops=cfg.num_large_crops, center_momentum=cfg.center_momentum)
        return loss

    return eval_loss


def make_dino_train_step(backbone_apply: Callable, head_apply: Callable, tx,
                         cfg: DinoStepConfig, classifier_apply: Optional[Callable] = None
                         ) -> Callable[[DinoState, Dict[str, torch.Tensor]],
                                       Tuple[DinoState, Dict[str, object]]]:
    """The train step ``(state, batch) -> (state, metrics)``; batch
    ``{"crops": (num_large_crops, B, C_max, H, W), "channel_counts": (B,)}``
    on the model's device. Metrics: ``dino_loss``, ``teacher_entropy`` and
    ``center_norm`` as 0-d tensors on the device; ``lr``, ``tau``,
    ``teacher_temp`` and ``epoch`` as Python numbers."""
    _check_supported(cfg)
    if classifier_apply is not None:
        raise NotImplementedError("the online classifier is not ported yet")

    def train_step(state: DinoState, batch: Dict[str, torch.Tensor]):
        _, flat, cc_rep = _flatten(batch)
        epoch = state.step // cfg.steps_per_epoch
        teacher_temp = _teacher_temp(cfg, epoch)

        with torch.no_grad():  # the teacher takes the save-free launches
            t_z = head_apply(state.teacher["head"],
                             backbone_apply(state.teacher["backbone"], flat, cc_rep)).float()

        named = state.trainable()
        names = [n for n, _ in named]
        params = [p for _, p in named]
        s_z = head_apply(state.student["head"],
                         backbone_apply(state.student["backbone"], flat, cc_rep))
        loss, new_center = dino_loss_and_center(
            s_z.float(), t_z, state.center, teacher_temp, student_temp=cfg.student_temp,
            num_large_crops=cfg.num_large_crops, center_momentum=cfg.center_momentum)
        grads = torch.autograd.grad(loss, params, allow_unused=True)

        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
            logits = (t_z - state.center) / teacher_temp
            teacher_entropy = -torch.mean(torch.sum(
                F.softmax(logits, -1) * F.log_softmax(logits, -1), dim=-1))
            if cfg.clip_grad:
                bb = [i for i, n in enumerate(names) if n.startswith("backbone.")]
                for i, g in zip(bb, _clip_backbone_grads([grads[i] for i in bb],
                                                         cfg.clip_grad)):
                    grads[i] = g
            if cfg.freeze_last_layer > 0 and epoch < cfg.freeze_last_layer:
                for i, n in enumerate(names):
                    if n in LAST_LAYER:
                        grads[i] = torch.zeros_like(grads[i])
            updates, state.opt_state = tx.update(grads, state.opt_state, params)
            for p, u in zip(params, updates):
                p.add_(u)
            tau = cosine_tau(state.step, cfg.total_steps, cfg.base_tau, cfg.final_tau)
            teacher, student = state.ema_pairs()
            torch._foreach_mul_(teacher, tau)
            torch._foreach_add_(teacher, student,
                                alpha=float(np.float32(1.0) - np.float32(tau)))
            state.center = new_center
            center_norm = torch.linalg.vector_norm(new_center)
        metrics = {
            "dino_loss": loss.detach(),
            "lr": warmup_cosine_lr(state.step, cfg.base_lr, cfg.total_steps,
                                   cfg.warmup_steps, cfg.warmup_start_lr, cfg.min_lr),
            "tau": tau,
            "teacher_temp": teacher_temp,
            "teacher_entropy": teacher_entropy,
            "center_norm": center_norm,
            "epoch": epoch,
        }
        state.step += 1
        return state, metrics

    return train_step
