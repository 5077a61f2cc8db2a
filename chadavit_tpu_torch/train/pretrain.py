"""Wire backbone + DINO head + LARS + schedules into the train step.

Counterpart of ``chadavit_tpu/train/pretrain.py`` (``DinoPretrainSpec`` :26,
``build_dino`` :99, ``synthetic_dino_batch`` :348), on one device. Weights and
batches come from numpy seeds. The JAX ``mesh`` and ``fsdp`` options belong
to later slices of the port and raise, as do the backbones other than
ChAdaViT and the online classifier. ``device_augmentations`` (the config's
augmentation list) puts the multicrop into the step, as JAX
``pretrain.py:309-321`` compiles it into one program: the step takes the
raw decoded batch and draws its views on the device.

``spec.dtype`` is the compute dtype of the backbone and the head, float32 or
bfloat16 (the canonical pretrain config's ``precision: "bf16"``, which the
JAX trainer maps to bfloat16 activations, ``train/loop.py:45``). The
parameters, the optimizer state, LARS and the EMA stay float32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from chadavit_tpu_torch.data.device_augment import make_multicrop_fn
from chadavit_tpu_torch.models.chada_vit import ChAdaViT, chada_vit, random_state_dict
from chadavit_tpu_torch.models.dino_head import DINOHead, random_head_state_dict
from chadavit_tpu_torch.train.dino_step import DinoStepConfig, make_dino_train_step
from chadavit_tpu_torch.train.optim import build_group_tx
from chadavit_tpu_torch.train.schedules import warmup_cosine_lr
from chadavit_tpu_torch.train.state import DinoState
from chadavit_tpu_torch.utils.misc import resolve_device


@dataclass
class DinoPretrainSpec:
    """The knobs of the DINO pretrain step (the reference YAML,
    ``scripts/knn/bbbc048/dino_chada_vit_moyen.yaml:36-84``); the defaults are
    the canonical ChAdaViT-moyen run. ``backbone_kwargs`` go to the factory
    ``chada_vit`` as they are, ``ln_impl`` and ``block_impl`` among them."""

    backbone: str = "vit_channels"
    backbone_kwargs: Dict[str, Any] = field(default_factory=lambda: dict(
        embed_dim=192, patch_size=16, return_all_tokens=False, max_number_channels=10,
    ))
    img_size: int = 224
    max_channels: int = 10
    channels_strategy: Optional[str] = "multi_channels"
    mixed_channels: bool = True
    img_channels: int = 3
    proj_hidden_dim: int = 2048
    proj_output_dim: int = 256
    num_prototypes: int = 4096
    use_bn_in_head: bool = False
    norm_last_layer: bool = True
    student_temperature: float = 0.1
    teacher_temperature: float = 0.07
    warmup_teacher_temperature: float = 0.04
    warmup_teacher_temperature_epochs: int = 0
    clip_grad: float = 0.0
    freeze_last_layer: int = 1
    base_tau: float = 0.9995
    final_tau: float = 1.0
    optimizer: str = "lars"
    lr: float = 0.3
    weight_decay: float = 1e-6
    optimizer_kwargs: Dict[str, Any] = field(default_factory=lambda: dict(
        clip_lr=True, eta=0.02, exclude_bias_n_norm=True, momentum=0.9,
    ))
    exclude_bias_n_norm_wd: bool = False
    warmup_epochs: float = 10
    warmup_start_lr: float = 3e-5
    min_lr: float = 0.0
    num_classes: int = 0
    online_classifier: bool = False
    momentum_classifier: bool = False
    classifier_lr: float = 3e-3
    num_large_crops: int = 2
    max_epochs: int = 400
    steps_per_epoch: int = 100
    accumulate_grad_batches: int = 1
    dtype: Any = torch.float32

    @property
    def total_steps(self) -> int:
        return self.max_epochs * self.steps_per_epoch


def build_dino(spec: DinoPretrainSpec, device: Optional[str] = None, seed: int = 0,
               mesh=None, fsdp: bool = False, device_augmentations=None,
               backbone_apply: Optional[Callable] = None
               ) -> Tuple[DinoState, Callable, ChAdaViT, DINOHead]:
    """Returns ``(state, train_step, backbone, head)`` on ``device``.

    The backbone's weights come from ``random_state_dict(backbone, seed)``,
    the head's from ``random_head_state_dict(head, seed + 1)``.
    ``device=None`` means ``"cuda"``, and raises where CUDA is absent.
    ``backbone_apply(backbone, crops, channel_counts)`` replaces the
    backbone's own forward in the step (a plain reference, say).

    With ``device_augmentations`` (a list of augmentation nodes), the step
    takes ``{"images": raw (B, C, H, W) uint8/uint16 (or float) planes,
    "channel_counts", "generator" or "draws"}``: :func:`make_multicrop_fn`
    turns them into the global views on ``device``, in ``spec.dtype``, and
    the step runs on those crops (small views are not trained on, as in JAX).
    """
    if mesh is not None or fsdp:
        raise NotImplementedError("mesh and fsdp are not ported yet")
    if spec.backbone not in ("vit_channels", "chada_vit"):
        raise NotImplementedError(f"backbone {spec.backbone!r}: only ChAdaViT is ported")
    if spec.online_classifier and spec.num_classes > 0:
        raise NotImplementedError("the online classifier is not ported yet")
    if spec.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"dtype {spec.dtype}: the port trains in float32 or bfloat16")
    dev = resolve_device(device)
    bk = dict(spec.backbone_kwargs)
    bk.setdefault("img_size", spec.img_size)
    bk["dtype"] = spec.dtype  # as the JAX build_dino (pretrain.py:124)
    model = chada_vit(**bk)
    model.load_state_dict(random_state_dict(model, seed))
    head = DINOHead(in_dim=model.embed_dim, num_prototypes=spec.num_prototypes,
                    use_bn=spec.use_bn_in_head, norm_last_layer=spec.norm_last_layer,
                    hidden_dim=spec.proj_hidden_dim, bottleneck_dim=spec.proj_output_dim,
                    dtype=spec.dtype)
    head.load_state_dict(random_head_state_dict(head, seed + 1))
    student = {"backbone": model.to(dev), "head": head.to(dev)}

    warmup_steps = int(spec.warmup_epochs * spec.steps_per_epoch)
    lr_schedule = functools.partial(
        warmup_cosine_lr, base_lr=spec.lr, total_steps=spec.total_steps,
        warmup_steps=warmup_steps, warmup_start_lr=spec.warmup_start_lr,
        min_lr=spec.min_lr)
    tx = build_group_tx(spec.optimizer, lr_schedule, spec.weight_decay,
                        spec.optimizer_kwargs, spec.exclude_bias_n_norm_wd)
    state = DinoState.create(student, None, spec.num_prototypes)
    named = state.trainable()
    # the rank in the JAX layout: weight_g is (P,) there
    state.opt_state = tx.init([p for _, p in named],
                              [p.dim() == 1 or n == "head.last_layer.weight_g"
                               for n, p in named])

    cfg = DinoStepConfig(
        num_large_crops=spec.num_large_crops, student_temp=spec.student_temperature,
        warmup_teacher_temp=spec.warmup_teacher_temperature,
        teacher_temp=spec.teacher_temperature,
        warmup_teacher_temp_epochs=spec.warmup_teacher_temperature_epochs,
        clip_grad=spec.clip_grad, freeze_last_layer=spec.freeze_last_layer,
        base_tau=spec.base_tau, final_tau=spec.final_tau, total_steps=spec.total_steps,
        steps_per_epoch=spec.steps_per_epoch, accumulate=spec.accumulate_grad_batches,
        base_lr=spec.lr, warmup_steps=warmup_steps, warmup_start_lr=spec.warmup_start_lr,
        min_lr=spec.min_lr)

    def head_apply(head_module, feats):
        return head_module(feats)

    step = make_dino_train_step(backbone_apply or ChAdaViT.__call__, head_apply, tx, cfg)
    if device_augmentations is None:
        return state, step, model, head
    aug_fn = make_multicrop_fn([dict(a) for a in device_augmentations], dtype=spec.dtype,
                               device=str(dev))

    def fused_step(st: DinoState, batch: Dict[str, Any]):
        # the views' kernels under one name, for the profiler
        with torch.profiler.record_function("device_augment"):
            out = aug_fn(batch["images"], batch["channel_counts"],
                         generator=batch.get("generator"), draws=batch.get("draws"))
        return step(st, {"crops": out["crops"], "channel_counts": out["channel_counts"]})

    return state, fused_step, model, head


def synthetic_dino_batch(spec: DinoPretrainSpec, batch_size: int, seed: int = 0,
                         channel_counts: Optional[Sequence[int]] = None,
                         device: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Random mixed-channel batch in the train-step layout, from a numpy seed:
    the JAX function's draws (crops, then the counts unless ``channel_counts``
    fixes them), padded channels zeroed, crops in ``spec.dtype`` (JAX
    ``pretrain.py:359``). ``device=None`` means ``"cuda"``."""
    rng = np.random.default_rng(seed)
    crops = rng.standard_normal(
        (spec.num_large_crops, batch_size, spec.max_channels, spec.img_size, spec.img_size)
    ).astype(np.float32)
    if channel_counts is None:
        counts = rng.integers(1, spec.max_channels + 1, size=(batch_size,)).astype(np.int32)
    else:
        counts = np.asarray(channel_counts, np.int32)
    for i, c in enumerate(counts):
        crops[:, i, c:] = 0.0
    dev = resolve_device(device)
    return {"crops": torch.from_numpy(crops).to(device=dev, dtype=spec.dtype),
            "channel_counts": torch.from_numpy(counts).to(dev)}
