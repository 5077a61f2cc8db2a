"""The LARS optimizer over a list of tensors, with the reference's rules.

Counterpart of ``chadavit_tpu/train/optim.py`` (``lars_direction`` :33-73,
``wd_mask`` :76, ``build_group_tx`` :81): LARS with trust coefficient, lr
clipping and the exclusion of 1-D parameters from scaling and weight decay
(reference ``src/utils/lars.py:112-167``), momentum on the LARS direction
(0.9 in the canonical config, ``src/args/pretrain.py:219-222``), then
``-lr`` from the group's schedule. A transformation is an ``(init, update)``
pair as in optax: ``update(grads, state, params) -> (updates, state)``, the
caller adds the updates to the parameters.

"1-D" is the parameter's rank in the JAX layout: ``one_d`` at ``init`` says so
for each tensor, for the one parameter whose torch shape has another rank
(the head's ``weight_g``, ``(P, 1)`` here and ``(P,)`` in JAX). SGD, Adam and
AdamW are not ported yet and raise.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class LarsState(NamedTuple):
    count: int
    momentum: Optional[List[torch.Tensor]]
    one_d: List[bool]


def lars_direction(eta: float = 0.001, eps: float = 1e-8, weight_decay: float = 0.0,
                   momentum: float = 0.0, clip_lr: bool = False,
                   exclude_bias_n_norm: bool = True,
                   lr_schedule: Optional[Schedule] = None) -> GradientTransformation:
    """LARS descent direction (reference ``lars.py:124-165``); the trailing
    ``-lr`` is the enclosing group's. ``clip_lr`` divides the trust ratio by
    the *current* lr and caps it at 1 (``lars.py:146-147``), so it needs the
    group's lr schedule."""

    def init(params: Sequence[torch.Tensor],
             one_d: Optional[Sequence[bool]] = None) -> LarsState:
        one_d = [p.dim() == 1 for p in params] if one_d is None else list(one_d)
        mom = [torch.zeros_like(p) for p in params] if momentum != 0.0 else None
        return LarsState(count=0, momentum=mom, one_d=one_d)

    @torch.no_grad()
    def update(grads, state: LarsState, params):
        cur_lr = (lr_schedule(state.count) if clip_lr and lr_schedule is not None
                  else None)
        updates = []
        for g, p, is_1d in zip(grads, params, state.one_d):
            if exclude_bias_n_norm and is_1d:
                updates.append(g)
                continue
            p_norm = torch.linalg.vector_norm(p)
            g_norm = torch.linalg.vector_norm(g)
            trust = eta * p_norm / (g_norm + p_norm * weight_decay + eps)
            if cur_lr is not None:
                trust = torch.clamp(trust / cur_lr, max=1.0)
            nonzero = (p_norm != 0.0) & (g_norm != 0.0)
            updates.append(torch.where(nonzero, (g + weight_decay * p) * trust, g))
        if momentum == 0.0:
            return updates, state._replace(count=state.count + 1)
        bufs = [momentum * b + d for b, d in zip(state.momentum, updates)]
        return bufs, state._replace(count=state.count + 1, momentum=bufs)

    return GradientTransformation(init, update)


def wd_mask(params: Sequence[torch.Tensor],
            one_d: Optional[Sequence[bool]] = None) -> List[bool]:
    """True where weight decay applies (not on 1-D bias/norm parameters)."""
    one_d = [p.dim() == 1 for p in params] if one_d is None else one_d
    return [not o for o in one_d]


def build_group_tx(name: str, lr_schedule: Schedule, weight_decay: float,
                   extra_kwargs: Optional[Dict] = None,
                   exclude_bias_n_norm_wd: bool = False) -> GradientTransformation:
    """One parameter group's transformation with its lr schedule baked in
    (the reference's ``_OPTIMIZERS`` registry, ``base.py:67-72``); only
    ``"lars"`` is ported. ``exclude_bias_n_norm_wd`` belongs to SGD and Adam
    (LARS has its own ``exclude_bias_n_norm``)."""
    kw = dict(extra_kwargs or {})
    if name in ("sgd", "adam", "adamw"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet; use 'lars'")
    if name != "lars":
        raise ValueError(f"unknown optimizer {name!r}; expected sgd/lars/adam/adamw")
    direction = lars_direction(
        eta=kw.get("eta", 1e-3), eps=kw.get("eps", 1e-8), weight_decay=weight_decay,
        momentum=kw.get("momentum", 0.0), clip_lr=kw.get("clip_lr", False),
        exclude_bias_n_norm=kw.get("exclude_bias_n_norm", True), lr_schedule=lr_schedule)

    @torch.no_grad()
    def update(grads, state: LarsState, params):
        neg_lr = float(-np.float32(lr_schedule(state.count)))
        dirs, new_state = direction.update(grads, state, params)
        return [d * neg_lr for d in dirs], new_state

    return GradientTransformation(direction.init, update)
