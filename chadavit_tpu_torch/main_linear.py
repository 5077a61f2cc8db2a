"""Linear probe / finetune evaluation (reference ``main_linear.py``).

The port's counterpart of the repository's root ``main_linear.py``
(``build_probe`` :28, ``run_probe`` :103), with the same command line plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions):

    python -m chadavit_tpu_torch.main_linear --config-path scripts/linear/bbbc048 \\
        --config-name dino_chada_vit_moyen.yaml [--device cpu] [dotted.key=value ...]

A frozen or finetuned backbone and a linear classifier, cross-entropy (label
smoothing, mixup, cutmix), the warmup-cosine schedule or the ``reduce``
plateau scale, epoch checkpoints with auto-resume, the validation suite and
the confusion-matrix PNG (reference ``src/methods/linear.py``). Frozen means
untouched: the backbone is not in the optimizer (``eval/probe.py``).
Outputs, in the working directory: ``{name}_probe_logs.txt`` (one JSON line
per logged step and the validation metrics) and, where matplotlib is
installed, ``{name}_confusion_matrix.png``.
"""

import os
from typing import List, NamedTuple

import numpy as np
import torch
from torch import nn

from chadavit_tpu_torch.cli import load_backbone_for_eval, load_cfg, parse_args
from chadavit_tpu_torch.config import parse_linear_cfg
from chadavit_tpu_torch.data.classification import dataset_img_channels, prepare_data
from chadavit_tpu_torch.data.datasets import DATASETS
from chadavit_tpu_torch.data.pipeline import device_prefetch, to_device
from chadavit_tpu_torch.eval.features import features_dim, make_feature_fn
from chadavit_tpu_torch.eval.metrics import (classification_suite, confusion_matrix,
                                             plot_confusion_matrix, regression_suite)
from chadavit_tpu_torch.eval.probe import (ProbeStepConfig, layer_decay_scales,
                                           make_probe_eval_step, make_probe_train_step)
from chadavit_tpu_torch.train.optim import (build_group_tx, chain, grouped_optimizer,
                                            label_params, scale_updates_by_path)
from chadavit_tpu_torch.train.schedules import PlateauScale, make_lr_schedule
from chadavit_tpu_torch.train.state import ProbeState
from chadavit_tpu_torch.utils.checkpoint import (AutoResumer, Checkpointer, load_payload,
                                                 load_state_dict_into)
from chadavit_tpu_torch.utils.logging import MetricLogger
from chadavit_tpu_torch.utils.misc import HostMemGuard, resolve_device, resolve_seed, seed_everything

CLASSIFIER_SEED = 1


class ProbeRun(NamedTuple):
    """What :func:`run_probe` returns: the validation metrics, the final
    probe state, every step's loss, and the run's train steps and
    validation batches."""
    results: dict
    state: ProbeState
    losses: List[float]
    steps: int
    val_batches: int


def linear_classifier(in_dim: int, out_dim: int, seed: int = CLASSIFIER_SEED) -> nn.Linear:
    """``nn.Linear(in_dim, out_dim)`` with flax ``nn.Dense``'s initializers
    drawn with numpy from ``seed``: a lecun-normal weight (a normal truncated
    at 2 standard deviations, scaled to variance 1 / in_dim) and a zero
    bias."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((out_dim, in_dim))
    bad = np.abs(w) > 2
    while bad.any():
        w[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(w) > 2
    std = np.sqrt(1.0 / in_dim) / 0.87962566103423978  # the truncated normal's std
    clf = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        clf.weight.copy_(torch.from_numpy((w * std).astype(np.float32)))
        clf.bias.zero_()
    return clf


def build_probe(cfg, model, steps_per_epoch: int, task: str = "classification"):
    """``(state, train_step, eval_step)`` of a parsed probe config for
    ``model`` (on its device): the classifier group at ``classifier_lr`` with
    weight decay 0 (reference ``base.py:406-414``), and when finetuning the
    backbone group at ``lr``, with layer-wise lr decay where ``layer_decay``
    is set (reference ``linear.py:290-303``)."""
    bk = cfg.backbone.get("kwargs", {})
    img_channels = cfg.data.get("img_channels", dataset_img_channels(cfg.data.dataset))
    feature_fn = make_feature_fn(
        model, cfg.get("channels_strategy"),
        return_all_tokens=bk.get("return_all_tokens", False),
        mixed_channels=cfg.get("mixed_channels", False),
        img_channels=img_channels,
    )
    num_out = 1 if task == "regression" else cfg.data.num_classes
    feats_dim = features_dim(cfg.get("channels_strategy"), bk.get("embed_dim", 192),
                             model.num_patches, img_channels,
                             bk.get("return_all_tokens", False))
    device = next(model.parameters()).device
    clf = linear_classifier(feats_dim, num_out).to(device)

    total_steps = cfg.max_epochs * steps_per_epoch
    warmup_steps = int(cfg.scheduler.warmup_epochs * steps_per_epoch)

    def mk_sched(lr):
        return make_lr_schedule(
            cfg.scheduler.get("name", "warmup_cosine"), lr, total_steps,
            warmup_steps=warmup_steps, warmup_start_lr=cfg.scheduler.warmup_start_lr,
            min_lr=cfg.scheduler.min_lr,
            decay_steps=[int(s * steps_per_epoch)
                         for s in (cfg.scheduler.get("lr_decay_steps") or [])],
            gamma=cfg.scheduler.get("gamma", 0.1))

    finetune = bool(cfg.get("finetune", False))
    kwargs = dict(cfg.optimizer.get("kwargs", {}))
    groups = {"classifier": build_group_tx(
        cfg.optimizer.name, mk_sched(cfg.optimizer.get("classifier_lr", cfg.optimizer.lr)),
        0.0, kwargs)}
    layer_decay = float(cfg.get("layer_decay", 0.0) or 0.0)
    if layer_decay > 0 and not finetune:
        raise ValueError("layer_decay requires finetune: True")
    if finetune:
        backbone_tx = build_group_tx(cfg.optimizer.name, mk_sched(cfg.optimizer.lr),
                                     cfg.optimizer.weight_decay, kwargs,
                                     cfg.optimizer.get("exclude_bias_n_norm_wd", False))
        if layer_decay > 0:
            # block i: decay^(depth-i), embeddings decay^(depth+1), final norm 1
            names = [n for n, _ in model.named_parameters()]
            scales = layer_decay_scales(names, layer_decay, bk.get("depth", 12))
            backbone_tx = chain(backbone_tx, scale_updates_by_path(scales, names))
        groups["backbone"] = backbone_tx
    state = ProbeState.create(model, clf, None, finetune)
    named = state.trainable()
    tx = grouped_optimizer(groups, label_params([n for n, _ in named],
                                                {"classifier.": "classifier"}))
    state.opt_state = tx.init([p for _, p in named])

    step_cfg = ProbeStepConfig(
        finetune=finetune, task=task, num_classes=num_out,
        label_smoothing=cfg.get("label_smoothing", 0.0),
        mixup=cfg.get("mixup", 0.0), cutmix=cfg.get("cutmix", 0.0))

    def clf_apply(classifier, feats):
        return classifier(feats)

    return (state, make_probe_train_step(feature_fn, clf_apply, tx, step_cfg),
            make_probe_eval_step(feature_fn, clf_apply))


def mixup_generator(seed: int, step: int) -> torch.Generator:
    """The generator of step ``step``'s mixup draws: a function of the run's
    seed and the step alone, so a resumed run draws what the straight run
    drew."""
    return torch.Generator().manual_seed(seed * 1_000_003 + step)


def probe_loaders(cfg):
    """(train loader, validation loader or None) of a parsed probe config:
    the train transform and a shuffled, unbucketed train loader, as the JAX
    entry point builds them."""
    bk = cfg.backbone.get("kwargs", {})
    img_channels = cfg.data.get("img_channels", dataset_img_channels(cfg.data.dataset))
    max_channels = (bk.get("max_number_channels", img_channels)
                    if cfg.backbone.name in ("vit_channels", "chada_vit") else img_channels)
    return prepare_data(
        cfg.data.dataset,
        train_path=cfg.data.get("train_path"),
        val_path=cfg.data.get("val_path"),
        batch_size=cfg.optimizer.batch_size,
        max_channels=max_channels,
        num_workers=cfg.data.get("num_workers", 4),
        crop_size=cfg.data.get("augmentations", {}).get("crop_size", 224),
        sample_ratio=cfg.data.get("sample_ratio", 1.0),
        subset_seed=resolve_seed(cfg),
        auto_augment=bool(cfg.get("auto_augment", False)),
    )


def run_probe(cfg, task: str = "classification", device=None) -> ProbeRun:
    """Train and validate the probe of a parsed config on ``device``
    (``None`` means cuda)."""
    dev = resolve_device(device)
    seed = resolve_seed(cfg)
    # host RNGs seeded before the datasets are built (the sample_ratio draw;
    # reference main_linear.py:73)
    seed_everything(seed)
    model = load_backbone_for_eval(cfg, dev)
    train_loader, val_loader = probe_loaders(cfg)
    steps_per_epoch = max(len(train_loader), 1)
    state, train_step, eval_step = build_probe(cfg, model, steps_per_epoch, task)

    logger = MetricLogger(".", name=f"{cfg.name}_probe_logs.txt")
    max_steps = cfg.get("max_steps")
    # the "reduce" scheduler (reference linear.py:360-361): a host plateau
    # controller of the mean train loss per epoch, scaling the update
    plateau = PlateauScale() if cfg.scheduler.get("name") == "reduce" else None
    lr_scale = 1.0
    done = 0

    # epoch checkpoints and auto-resume (reference main_linear.py:198-214);
    # the payload's epoch is the last COMPLETED one, lr_scale rides along
    ckptr = None
    start_epoch = 0
    if cfg.checkpoint.enabled:
        resume_path = cfg.get("resume_from_checkpoint")
        run_id = None
        if resume_path is None and cfg.auto_resume.enabled:
            resume_path, run_id = AutoResumer(
                checkpoint_dir=os.path.join(cfg.checkpoint.dir, cfg.get("method") or "base"),
                max_hours=cfg.auto_resume.get("max_hours", 36),
            ).find_checkpoint(cfg)
        if resume_path:
            payload = load_payload(resume_path)
            load_state_dict_into(state, payload)
            lr_scale = float(payload["extra"]["lr_scale"])
            start_epoch = int(payload["extra"]["epoch"]) + 1
            done = state.step
            print(f"auto-resumed probe from {resume_path} at epoch {start_epoch}")
        ckptr = Checkpointer(cfg, base_dir=cfg.checkpoint.dir,
                             frequency=cfg.checkpoint.frequency,
                             keep_prev=cfg.checkpoint.get("keep_prev", False),
                             run_id=run_id)

    def _extra(epoch_completed):
        return {"lr_scale": float(lr_scale), "epoch": int(epoch_completed)}

    # a mid-epoch save records epoch - 1, so a resumed run redoes that epoch
    guard = HostMemGuard(cfg.get("host_mem_guard_mb"))

    def _upload(batch):
        return to_device({k: batch[k] for k in ("images", "channel_counts", "labels")}, dev)

    losses = []
    first = done
    for epoch in range(start_epoch, cfg.max_epochs):
        train_loader.set_epoch(epoch)
        epoch_loss = []
        for batch in device_prefetch(iter(train_loader), _upload):
            if plateau is not None:
                batch["lr_scale"] = lr_scale
            state, metrics = train_step(state, batch, generator=mixup_generator(seed, done))
            done += 1
            losses.append(metrics["loss"])
            epoch_loss.append(metrics["loss"])
            if done % cfg.get("log_every", 50) == 0:
                logger.log({k: float(v) for k, v in metrics.items()}, step=done)
                if ckptr:
                    guard.check(lambda: ckptr.save_step(state, done, _extra(epoch - 1)),
                                where=f"probe step {done} (epoch {epoch} restarts)")
            if max_steps and done >= max_steps:
                break
        if plateau is not None and epoch_loss:
            lr_scale = plateau.step(float(torch.stack(epoch_loss).mean()))
        if ckptr:
            ckptr.save(state, epoch, _extra(epoch))
        if max_steps and done >= max_steps:
            break

    # validation: the full metric suite (reference linear.py:577-628)
    results = {}
    val_batches = 0
    if val_loader is not None:
        logits_all, targets_all = [], []
        for batch in device_prefetch(iter(val_loader), _upload):
            logits = eval_step(state.backbone, state.classifier, batch["images"],
                               batch["channel_counts"])
            logits_all.append(logits.float().cpu().numpy())
            targets_all.append(batch["labels"].cpu().numpy())
            val_batches += 1
        logits_all = np.concatenate(logits_all)
        targets_all = np.concatenate(targets_all)
        if task == "regression":
            results = regression_suite(logits_all[:, 0], targets_all)
        else:
            results = classification_suite(logits_all, targets_all, cfg.data.num_classes)
            cm = confusion_matrix(logits_all.argmax(1), targets_all, cfg.data.num_classes)
            names = getattr(DATASETS.get(cfg.data.dataset), "int_to_labels", None)
            class_names = ([names[i] for i in sorted(names)] if names
                           else [str(i) for i in range(cfg.data.num_classes)])
            plot_confusion_matrix(cm, class_names, f"{cfg.name}_confusion_matrix.png")
        print("validation:", {k: round(float(v), 4) for k, v in results.items()})
        logger.log(results, step=done)
    return ProbeRun(results, state, [float(x) for x in losses], done - first, val_batches)


def main(argv=None):
    args = parse_args(argv, description=__doc__)
    return run_probe(parse_linear_cfg(load_cfg(args)), task="classification",
                     device=args.device).results


if __name__ == "__main__":
    main()
