"""Linear and regression probes: the train and eval steps (reference
``src/methods/linear.py`` and ``src/methods/regression.py``).

Counterpart of ``chadavit_tpu/eval/probe.py`` (``cross_entropy`` :27,
``mixup_cutmix`` :47, ``ProbeStepConfig`` :88, ``make_probe_train_step`` :97,
``make_probe_eval_step`` :145, ``layer_decay_scales`` :154):

- frozen mode: the backbone's features under ``torch.no_grad``, only the
  classifier trains (reference ``linear.py:386,525``: the backbone is kept
  out of the optimizer unless ``finetune``). The backbone is not in the
  optimizer at all, so it stays bit for bit what it was. This departs from
  the JAX probe on purpose: there the frozen backbone sits in the optimizer
  with zero gradients, and ``adamw``'s (or ``sgd``'s) weight decay still
  scales it by ``1 - lr * wd`` every step;
- finetune mode: gradients flow into the backbone (on the card through the
  layer's backward kernels), optionally with layer-wise lr decay (reference
  ``linear.py:290-303``) as per-parameter scale factors on the update;
- losses: cross-entropy with label smoothing (reference
  ``main_linear.py:131-150``), soft-target CE under mixup/cutmix, MSE for
  regression (``main_regression.py:108``).

Mixup/cutmix is a pure function of its random draws (:func:`mixup_cutmix`),
which :func:`mixup_draws` takes from an explicit ``torch.Generator``, so
that a test can feed it the JAX probe's draws.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from chadavit_tpu_torch.train.state import ProbeState

# the JAX top-level parameter keys of the embeddings and their port names
# (JAX ``patch_embed``/``patch_kernel``/``patch_bias`` -> ``token_learner``)
EMBEDDING_KEYS = ("cls_token", "pos_embed", "channel_token", "token_learner")


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, label_smoothing: float = 0.0,
                  num_classes: Optional[int] = None) -> torch.Tensor:
    """CE over int targets (``ignore_index=-1``: negative targets count for
    nothing) or over soft targets when ``targets`` is 2-D (mixup)."""
    logp = F.log_softmax(logits, -1)
    if targets.dim() == 2:
        return -torch.mean(torch.sum(targets * logp, -1))
    nc = num_classes or logits.shape[-1]
    valid = targets >= 0
    t = torch.where(valid, targets, torch.zeros_like(targets)).long()
    onehot = F.one_hot(t, nc).to(logits.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / nc
    per = -torch.sum(onehot * logp, -1)
    per = torch.where(valid, per, torch.zeros_like(per))
    return torch.sum(per) / torch.clamp(torch.sum(valid), min=1)


class MixupDraws(NamedTuple):
    """The random draws of one mixup/cutmix call."""
    perm: torch.Tensor  # (B,) permutation of the batch
    use_cutmix: bool
    lam: float          # Beta(alpha, alpha) of the chosen mode
    cy: int             # box centre
    cx: int


def mixup_draws(generator: torch.Generator, batch: int, h: int, w: int,
                mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0) -> MixupDraws:
    """Draw what :func:`mixup_cutmix` needs from ``generator`` (a CPU
    generator): the permutation, the mixup-or-cutmix coin, lambda from
    Beta(alpha, alpha) (numpy's, seeded from the generator: torch's Beta takes
    no generator), and the box centre."""
    perm = torch.randperm(batch, generator=generator)
    coin = bool(torch.rand((), generator=generator) < 0.5)
    use_cutmix = cutmix_alpha > 0 and (mixup_alpha <= 0 or coin)
    alpha = max(cutmix_alpha, 1e-8) if use_cutmix else max(mixup_alpha, 1e-8)
    seed = int(torch.randint(0, 2**62, (), generator=generator))
    lam = float(np.float32(np.random.default_rng(seed).beta(alpha, alpha)))
    cy = int(torch.randint(0, h, (), generator=generator))
    cx = int(torch.randint(0, w, (), generator=generator))
    return MixupDraws(perm, use_cutmix, lam, cy, cx)


def mixup_cutmix(images: torch.Tensor, targets: torch.Tensor, num_classes: int,
                 draws: MixupDraws) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch mixup or cutmix producing soft targets (reference: timm's Mixup,
    ``main_linear.py:140-150``). ``images`` (B, C, H, W)."""
    onehot = F.one_hot(targets.long(), num_classes).to(images.dtype)
    perm = draws.perm.to(images.device)
    h, w = images.shape[-2:]
    lam = torch.tensor(draws.lam, dtype=images.dtype)
    if not draws.use_cutmix:
        mixed = lam * images + (1 - lam) * images[perm]
        lam_out = float(lam)
    else:
        cut = torch.sqrt(1 - lam)
        ch, cw = int(cut * h), int(cut * w)
        y0, y1 = int(np.clip(draws.cy - ch // 2, 0, h)), int(np.clip(draws.cy + ch // 2, 0, h))
        x0, x1 = int(np.clip(draws.cx - cw // 2, 0, w)), int(np.clip(draws.cx + cw // 2, 0, w))
        mixed = images.clone()
        mixed[..., y0:y1, x0:x1] = images[perm][..., y0:y1, x0:x1]
        lam_out = float(np.float32(1.0) - np.float32((y1 - y0) * (x1 - x0)) / np.float32(h * w))
    lam_t = torch.tensor(lam_out, dtype=onehot.dtype, device=onehot.device)
    return mixed, lam_t * onehot + (1 - lam_t) * onehot[perm]


class ProbeStepConfig(NamedTuple):
    finetune: bool = False
    task: str = "classification"  # or "regression"
    num_classes: int = 2
    label_smoothing: float = 0.0
    mixup: float = 0.0
    cutmix: float = 0.0


def make_probe_train_step(feature_fn: Callable, classifier_apply: Callable, tx,
                          cfg: ProbeStepConfig) -> Callable:
    """``step(state, batch, generator=None, draws=None) -> (state, metrics)``;
    ``batch`` holds ``images``, ``channel_counts``, ``labels`` and optionally
    ``lr_scale``, a host multiplier of the update (``PlateauScale``). Mixup
    draws come from ``draws`` or else from ``generator``. The state is
    updated in place and returned."""

    def step(state: ProbeState, batch: Dict, generator: Optional[torch.Generator] = None,
             draws: Optional[MixupDraws] = None):
        images, counts, targets = batch["images"], batch["channel_counts"], batch["labels"]
        if cfg.task == "classification" and (cfg.mixup > 0 or cfg.cutmix > 0):
            if draws is None:
                draws = mixup_draws(generator, images.shape[0], *images.shape[-2:],
                                    cfg.mixup, cfg.cutmix)
            images, targets = mixup_cutmix(images, targets, cfg.num_classes, draws)

        if cfg.finetune:
            feats = feature_fn(state.backbone, images, counts)
        else:
            with torch.no_grad():
                feats = feature_fn(state.backbone, images, counts)
        logits = classifier_apply(state.classifier, feats)
        if cfg.task == "regression":
            loss = torch.mean((logits[:, 0] - targets.to(logits.dtype)) ** 2)
        else:
            loss = cross_entropy(logits, targets, cfg.label_smoothing, cfg.num_classes)

        params = [p for _, p in state.trainable()]
        grads = torch.autograd.grad(loss, params)
        updates, state.opt_state = tx.update(list(grads), state.opt_state, params)
        if "lr_scale" in batch:
            # the lr multiplier: every chain ends in -lr, so scaling the
            # update scales the lr
            updates = [u * float(batch["lr_scale"]) for u in updates]
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        state.step += 1
        metrics = {"loss": loss.detach()}
        if cfg.task == "classification" and targets.dim() == 1:
            metrics["acc1"] = (logits.detach().argmax(-1) == targets).float().mean() * 100
        return state, metrics

    return step


def make_probe_eval_step(feature_fn: Callable, classifier_apply: Callable) -> Callable:
    """``step(backbone, classifier, images, counts) -> logits``."""

    @torch.inference_mode()
    def step(backbone, classifier, images, counts):
        return classifier_apply(classifier, feature_fn(backbone, images, counts))

    return step


def layer_decay_scales(names: Sequence[str], layer_decay: float, depth: int
                       ) -> Dict[str, float]:
    """The lr scale of each backbone parameter for layer-wise lr decay
    (reference ``misc.py:364-422`` via timm): block i gets
    ``decay^(depth - i)``, the embeddings (JAX ``cls_token``, ``pos_embed``,
    ``channel_token``, ``patch_*``; here also ``token_learner.*``)
    ``decay^(depth + 1)``, everything else (the final norm) 1. ``names`` are
    the port's parameter names (``blocks.3.linear1.weight``)."""
    scales = {}
    for name in names:
        top = name.split(".")[0]
        if top == "blocks":
            scales[name] = layer_decay ** (depth - int(name.split(".")[1]))
        elif top in EMBEDDING_KEYS:
            scales[name] = layer_decay ** (depth + 1)
        else:
            scales[name] = 1.0
    return scales
