"""Optimizers over lists of tensors, with the reference's parameter-group rules.

Counterpart of ``chadavit_tpu/train/optim.py`` (``lars_direction`` :33-73,
``wd_mask`` :76, ``build_group_tx`` :81, ``scale_updates_by_path`` :133,
``grouped_optimizer`` :160, ``label_params`` :169). A transformation is an
``(init, update)`` pair as in optax: ``init(params, one_d=None) -> state``,
``update(grads, state, params) -> (updates, state)``; the caller adds the
updates to the parameters. Each arithmetic step is the optax chain's, in its
order and in float32:

- ``lars``: the LARS direction with trust coefficient, lr clipping and the
  exclusion of 1-D parameters from scaling and weight decay (reference
  ``src/utils/lars.py:112-167``), momentum on that direction (0.9 in the
  canonical config, ``src/args/pretrain.py:219-222``);
- ``sgd``: weight decay ``g + wd p``, then momentum (``optax.trace``: the
  trace ``g + m t``, Nesterov optional);
- ``adam``: ``torch.optim.Adam``'s L2 decay, ``g + wd p`` BEFORE the moments,
  then ``optax.scale_by_adam`` (bias-corrected moments, ``eps`` outside the
  square root);
- ``adamw``: the moments first, then the decoupled ``+ wd p``;

each followed by ``-lr`` from the group's schedule at the group's own step
count. ``exclude_bias_n_norm_wd`` keeps the decay off 1-D parameters
(:func:`wd_mask`).

"1-D" is the parameter's rank in the JAX layout: ``one_d`` at ``init`` says so
for each tensor, for the one parameter whose torch shape has another rank
(the DINO head's ``weight_g``, ``(P, 1)`` here and ``(P,)`` in JAX).

Parameter groups are by name: :func:`label_params` labels names by prefix,
:func:`grouped_optimizer` runs one transformation per label (optax's
``multi_transform``), and :func:`scale_updates_by_path` scales each update by
its name's entry in a table (the layer-wise lr decay of the probes).
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


class SgdState(NamedTuple):
    count: int
    trace: Optional[List[torch.Tensor]]
    decay: List[bool]  # where weight decay applies


class AdamState(NamedTuple):
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    decay: List[bool]  # where weight decay applies


def _one_d(params: Sequence[torch.Tensor], one_d: Optional[Sequence[bool]]) -> List[bool]:
    return [p.dim() == 1 for p in params] if one_d is None else list(one_d)


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
        mom = [torch.zeros_like(p) for p in params] if momentum != 0.0 else None
        return LarsState(count=0, momentum=mom, one_d=_one_d(params, one_d))

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
    return [not o for o in _one_d(params, one_d)]


def _decayed(updates, params, decay: Sequence[bool], weight_decay: float):
    """``optax.add_decayed_weights``: ``u + wd p`` where ``decay``."""
    return [u + weight_decay * p if d else u for u, p, d in zip(updates, params, decay)]


def _neg_lr(lr_schedule: Schedule, count: int) -> float:
    """``optax.scale_by_schedule(-lr)``'s factor at ``count``, a float32 value."""
    return float(-np.float32(lr_schedule(count)))


def _sgd(lr_schedule: Schedule, weight_decay: float, momentum: float, nesterov: bool,
         exclude_bias_n_norm_wd: bool) -> GradientTransformation:
    def init(params, one_d=None) -> SgdState:
        decay = (wd_mask(params, one_d) if exclude_bias_n_norm_wd
                 else [True] * len(params))
        trace = [torch.zeros_like(p) for p in params] if momentum else None
        return SgdState(count=0, trace=trace, decay=decay)

    @torch.no_grad()
    def update(grads, state: SgdState, params):
        u = list(grads)
        if weight_decay:
            u = _decayed(u, params, state.decay, weight_decay)
        trace = state.trace
        if momentum:
            trace = [g + momentum * t for g, t in zip(u, trace)]
            u = [g + momentum * t for g, t in zip(u, trace)] if nesterov else trace
        neg_lr = _neg_lr(lr_schedule, state.count)
        return [x * neg_lr for x in u], state._replace(count=state.count + 1, trace=trace)

    return GradientTransformation(init, update)


def _adam(lr_schedule: Schedule, weight_decay: float, betas, eps: float,
          decoupled: bool, exclude_bias_n_norm_wd: bool) -> GradientTransformation:
    b1, b2 = float(betas[0]), float(betas[1])

    def init(params, one_d=None) -> AdamState:
        decay = (wd_mask(params, one_d) if exclude_bias_n_norm_wd
                 else [True] * len(params))
        return AdamState(count=0, mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params], decay=decay)

    @torch.no_grad()
    def update(grads, state: AdamState, params):
        g = list(grads)
        if weight_decay and not decoupled:
            g = _decayed(g, params, state.decay, weight_decay)
        mu = [(1 - b1) * x + b1 * m for x, m in zip(g, state.mu)]
        nu = [(1 - b2) * (x * x) + b2 * v for x, v in zip(g, state.nu)]
        count = state.count + 1
        # optax's bias correction, 1 - b**count, in float32
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        u = [(m / c1) / (torch.sqrt(v / c2) + eps) for m, v in zip(mu, nu)]
        if weight_decay and decoupled:
            u = _decayed(u, params, state.decay, weight_decay)
        neg_lr = _neg_lr(lr_schedule, state.count)
        return [x * neg_lr for x in u], AdamState(count=count, mu=mu, nu=nu,
                                                  decay=state.decay)

    return GradientTransformation(init, update)


def build_group_tx(name: str, lr_schedule: Schedule, weight_decay: float,
                   extra_kwargs: Optional[Dict] = None,
                   exclude_bias_n_norm_wd: bool = False) -> GradientTransformation:
    """One parameter group's transformation with its lr schedule baked in
    (the reference's ``_OPTIMIZERS`` registry {sgd, lars, adam, adamw},
    ``base.py:67-72``, with the YAML's ``optimizer.kwargs``).
    ``exclude_bias_n_norm_wd`` belongs to SGD and Adam (LARS has its own
    ``exclude_bias_n_norm``)."""
    kw = dict(extra_kwargs or {})
    if name == "sgd":
        return _sgd(lr_schedule, weight_decay, kw.get("momentum", 0.0),
                    kw.get("nesterov", False), exclude_bias_n_norm_wd)
    if name in ("adam", "adamw"):
        return _adam(lr_schedule, weight_decay, tuple(kw.get("betas", (0.9, 0.999))),
                     kw.get("eps", 1e-8), name == "adamw", exclude_bias_n_norm_wd)
    if name != "lars":
        raise ValueError(f"unknown optimizer {name!r}; expected sgd/lars/adam/adamw")
    direction = lars_direction(
        eta=kw.get("eta", 1e-3), eps=kw.get("eps", 1e-8), weight_decay=weight_decay,
        momentum=kw.get("momentum", 0.0), clip_lr=kw.get("clip_lr", False),
        exclude_bias_n_norm=kw.get("exclude_bias_n_norm", True), lr_schedule=lr_schedule)

    @torch.no_grad()
    def update(grads, state: LarsState, params):
        neg_lr = _neg_lr(lr_schedule, state.count)
        dirs, new_state = direction.update(grads, state, params)
        return [d * neg_lr for d in dirs], new_state

    return GradientTransformation(direction.init, update)


def scale_updates_by_path(key_scales: Dict[str, float], names: Sequence[str],
                          default: float = 1.0) -> GradientTransformation:
    """Multiply the update of each parameter (``names``, in the group's
    order) by its scale in ``key_scales``, else by ``default``: per-group
    ``lr_scale`` (reference layer-wise lr decay, ``misc.py:364-422``), which
    scales the whole update, weight decay included, as torch parameter
    groups do. JAX looks the scale up by the top-level key of the
    parameter's path; :func:`chadavit_tpu_torch.eval.probe.layer_decay_scales`
    maps those keys to the port's names."""
    scales = [key_scales.get(n, default) for n in names]

    def init(params, one_d=None):
        return None

    @torch.no_grad()
    def update(updates, state, params=None):
        return [u * s for u, s in zip(updates, scales)], state

    return GradientTransformation(init, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """Apply transformations in turn (``optax.chain``)."""

    def init(params, one_d=None):
        return tuple(tx.init(params, one_d) for tx in txs)

    def update(updates, state, params):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def grouped_optimizer(group_tx: Dict[str, GradientTransformation],
                      labels: Sequence[str]) -> GradientTransformation:
    """One transformation per group over a parameter list whose entries are
    labelled ``labels`` (optax's ``multi_transform``, the analogue of torch
    parameter groups); each group keeps its own state and step count."""
    labels = list(labels)
    members = {g: [i for i, lbl in enumerate(labels) if lbl == g] for g in group_tx}
    unknown = sorted(set(labels) - set(group_tx))
    if unknown:
        raise ValueError(f"labels without a transformation: {unknown}")

    def init(params, one_d=None):
        one_d = _one_d(params, one_d)
        return {g: tx.init([params[i] for i in members[g]], [one_d[i] for i in members[g]])
                for g, tx in group_tx.items()}

    def update(grads, state, params):
        out: List[Optional[torch.Tensor]] = [None] * len(labels)
        new = {}
        for g, tx in group_tx.items():
            idx = members[g]
            ups, new[g] = tx.update([grads[i] for i in idx], state[g], [params[i] for i in idx])
            for i, u in zip(idx, ups):
                out[i] = u
        return out, new

    return GradientTransformation(init, update)


def label_params(names: Sequence[str], rules: Dict[str, str],
                 default: str = "backbone") -> List[str]:
    """Label parameter names by prefix: the group of the first rule whose key
    starts the name, else ``default``."""
    out = []
    for name in names:
        lbl = default
        for prefix, group in rules.items():
            if name == prefix or name.startswith(prefix):
                lbl = group
                break
        out.append(lbl)
    return out
