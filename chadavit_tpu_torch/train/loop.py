"""Training loop orchestration: config -> data -> train step -> checkpoints.

Counterpart of ``chadavit_tpu/train/loop.py`` (``spec_from_cfg`` :39,
``build_pretrain_loader`` :91, ``run_dino_pretrain`` :196), on one device: a
plain Python loop around the DINO step, with the host loader feeding pinned
copies to the card a few batches ahead, checkpoints and exact-step
auto-resume, the SIGTERM/SIGUSR1 preemption hook and offline metric logging.

The loader is the host multicrop loader, or with ``device_augmentations:
true`` the raw loader of JAX ``loop.py:95-104``/``:128-170``: the host decodes
(the native C++ decoder where it builds, else PIL) and resizes to the base
crop size, the raw uint8/uint16 planes go to the card as they are, and the
step draws its views there from a generator of the step's own index.

Not ported yet, each raising ``NotImplementedError`` with its key: online
kNN (``knn_eval``; the offline kNN of a checkpoint is the port's
``main_knn``), the training-time UMAP (``auto_umap``), tensor
parallelism (``model_parallel``), ``fsdp``, more than one device
(``devices``) and more than one host (``num_nodes``).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from chadavit_tpu_torch.config import Config
from chadavit_tpu_torch.data import (
    FullTransformPipeline,
    HostLoader,
    NCropAugmentation,
    build_transform_pipeline,
    device_prefetch,
    prepare_datasets,
    to_device,
)
from chadavit_tpu_torch.data import native
from chadavit_tpu_torch.data.device_augment import aug_generator
from chadavit_tpu_torch.data.transforms import RawResize
from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, build_dino
from chadavit_tpu_torch.utils.checkpoint import AutoResumer, Checkpointer, restore_state
from chadavit_tpu_torch.utils.logging import MetricLogger
from chadavit_tpu_torch.utils.misc import (
    HostMemGuard,
    host_rss_bytes,
    pretty_param_summary,
    resolve_device,
    resolve_seed,
    seed_everything,
)
from chadavit_tpu_torch.utils.profiling import StepTimer


def spec_from_cfg(cfg: Config, steps_per_epoch: int) -> DinoPretrainSpec:
    """Map a parsed pretrain config onto the step spec; ``precision``
    ``bf16*`` means bfloat16 compute, anything else float32 (JAX
    ``loop.py:45``)."""
    bk = dict(cfg.backbone.get("kwargs", {}))
    mk = cfg.get("method_kwargs", {})
    opt = cfg.optimizer
    sched = cfg.scheduler
    dtype = (torch.bfloat16 if str(cfg.get("precision", "bf16")).startswith("bf16")
             else torch.float32)
    return DinoPretrainSpec(
        backbone=cfg.backbone.name,
        backbone_kwargs=bk,
        img_size=cfg.get("augmentations", [{}])[0].get("crop_size", 224) if cfg.get("augmentations") else 224,
        max_channels=bk.get("max_number_channels", cfg.data.get("max_img_channels", 10)),
        proj_hidden_dim=mk.get("proj_hidden_dim", 2048),
        proj_output_dim=mk.get("proj_output_dim", 256),
        num_prototypes=mk.get("num_prototypes", 4096),
        use_bn_in_head=mk.get("use_bn_in_head", False),
        norm_last_layer=mk.get("norm_last_layer", True),
        student_temperature=mk.get("student_temperature", 0.1),
        teacher_temperature=mk.get("teacher_temperature", 0.07),
        warmup_teacher_temperature=mk.get("warmup_teacher_temperature", 0.04),
        warmup_teacher_temperature_epochs=mk.get("warmup_teacher_temperature_epochs", 0),
        clip_grad=mk.get("clip_grad", 0),
        freeze_last_layer=mk.get("freeze_last_layer", 1),
        base_tau=cfg.momentum.base_tau,
        final_tau=cfg.momentum.final_tau,
        optimizer=opt.name,
        lr=opt.lr,
        weight_decay=opt.weight_decay,
        optimizer_kwargs=dict(opt.get("kwargs", {})),
        exclude_bias_n_norm_wd=opt.get("exclude_bias_n_norm_wd", False),
        warmup_epochs=sched.warmup_epochs,
        warmup_start_lr=sched.warmup_start_lr if sched.warmup_epochs > 0 else opt.lr,
        min_lr=sched.min_lr,
        channels_strategy=cfg.get("channels_strategy", "multi_channels"),
        mixed_channels=cfg.get("mixed_channels", True),
        img_channels=cfg.data.get("img_channels", 3),
        # online classifier on detached feats for labeled non-mixed pretrain
        # (reference base.py:233,561-563; disabled under mixed_channels)
        num_classes=int(cfg.data.get("num_classes", 0) or 0),
        online_classifier=(not cfg.get("mixed_channels", True)
                           and int(cfg.data.get("num_classes", 0) or 0) > 0),
        momentum_classifier=bool(cfg.get("momentum_classifier", False)),
        classifier_lr=float(opt.get("classifier_lr", 3e-3) or 3e-3),
        num_large_crops=cfg.data.num_large_crops,
        max_epochs=cfg.max_epochs,
        steps_per_epoch=steps_per_epoch,
        accumulate_grad_batches=cfg.get("accumulate_grad_batches", 1) or 1,
        dtype=dtype,
    )


def unported_keys(cfg: Config) -> None:
    """Raise ``NotImplementedError`` naming the first config key that asks for
    a part of the JAX loop the port does not have yet."""
    devices = cfg.get("devices", 1)
    n_devices = len(devices) if isinstance(devices, (list, tuple)) else int(devices or 1)
    asks = [
        ("knn_eval", bool((cfg.get("knn_eval") or {}).get("enabled", False))),
        ("auto_umap", bool((cfg.get("auto_umap") or {}).get("enabled", False))),
        ("model_parallel", int(cfg.get("model_parallel", 1) or 1) > 1),
        ("fsdp", bool(cfg.get("fsdp", False))),
        ("devices", n_devices > 1),
        ("num_nodes", int(cfg.get("num_nodes", 1) or 1) > 1),
    ]
    for key, asked in asks:
        if asked:
            hint = ("; the offline kNN of a checkpoint is ported: "
                    "python -m chadavit_tpu_torch.main_knn" if key == "knn_eval" else "")
            raise NotImplementedError(
                f"{key}={cfg.get(key)!r}: not ported yet; the port's pretrain loop runs "
                f"on one device of one host{hint}")


def build_pretrain_loader(cfg: Config, seed: int = 0) -> HostLoader:
    """Multi-crop SSL loader from the config's augmentation pipelines
    (reference ``main_pretrain.py:101-136``).

    With ``device_augmentations: true`` the host only decodes and resizes to
    the base crop size, and the loader yields the raw planes (``images``)
    for the step to augment on the device (JAX ``loop.py:91-170``)."""
    device_augs = bool(cfg.get("device_augmentations", False))
    crop = cfg["augmentations"][0]["crop_size"] if cfg.get("augmentations") else 224
    if device_augs:
        transform = RawResize(crop)
    else:
        pipelines = [
            NCropAugmentation(
                build_transform_pipeline(cfg.data.dataset, aug, seed=seed + i),
                aug.get("num_crops", 1),
            )
            for i, aug in enumerate(cfg.get("augmentations", []))
        ]
        transform = FullTransformPipeline(pipelines)
    if cfg.get("debug_augmentations", False):  # reference main_pretrain.py:120-122
        print("Transforms:")
        print(transform)
    if cfg.data.dataset == "synthetic":
        ds_kwargs = dict(n=cfg.data.get("size", 256), img_size=crop,
                         max_channels=cfg.data.get("max_img_channels", 10))
    elif cfg.data.dataset == "synthetic_structured":
        from chadavit_tpu_torch.data.synthetic import SyntheticStructured

        ds_kwargs = dict(n=cfg.data.get("size", 512), img_size=crop,
                         max_channels=cfg.data.get("max_img_channels", 4),
                         num_classes=cfg.data.get("num_classes",
                                                  SyntheticStructured.NUM_CLASSES))
    elif device_augs:
        # manifest datasets keep the raw integer planes for the device
        ds_kwargs = dict(raw=True)
    else:
        ds_kwargs = {}
    dataset = prepare_datasets(
        cfg.data.dataset,
        transform=transform,
        train_path=cfg.data.get("train_path"),
        train=True,
        sample_ratio=cfg.data.get("sample_ratio", 1.0),
        # local-RNG subset draw, independent of prior global-RNG consumption
        subset_seed=seed,
        **ds_kwargs,
    )
    max_channels = (cfg.backbone.get("kwargs", {}).get("max_number_channels")
                    or cfg.data.get("max_img_channels", 10))
    loader_kwargs = {}
    if device_augs:
        # RawResize keeps the decoder's dtype: 1-2 bytes a pixel to the card
        probe = np.asarray(dataset[0][0])
        loader_kwargs = dict(channels_last=True, dtype=probe.dtype)
        if hasattr(dataset, "file_list"):  # image files on disk
            batched = (cfg.data.get("native_loader", True)
                       and probe.dtype in (np.uint8, np.uint16) and native.is_available())
            print("decoder: " + native.describe() + (
                ", whole batches in the C++ thread pool" if batched else ", one sample at a time"))
            if batched:
                # with data.cache_decoded, epochs after the first decode nothing
                cache = (native.DecodedPlaneCache(
                    int(cfg.data.get("cache_decoded_mb", 2048)) * 2**20)
                    if cfg.data.get("cache_decoded", False) else None)
                loader_kwargs["native_batch_fn"] = native.make_dense_batch_fn(
                    dataset, crop, num_threads=int(cfg.data.get("decode_threads", 4) or 4),
                    out_depth=16 if probe.dtype == np.uint16 else 8,
                    regression=getattr(dataset, "task", "") == "regression", cache=cache)
    return HostLoader(
        dataset,
        batch_size=cfg.optimizer.batch_size,
        max_channels=max_channels,
        num_workers=cfg.data.get("num_workers", 4),
        seed=seed,
        # group batches by channel count and pad only to the bucket width
        bucket_by_channels=cfg.get("bucket_by_channels", False),
        bucket_round=int(cfg.get("bucket_round", 1)),
        **loader_kwargs,
    )


def _timed(iterable):
    """Yield ``(seconds the consumer waited for the item, item)``."""
    it = iter(iterable)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        yield time.perf_counter() - t0, item


def run_dino_pretrain(cfg: Config, max_steps: Optional[int] = None,
                      device: Optional[str] = None) -> Dict:
    """Full DINO pretraining (the ``main_pretrain.py`` engine). Returns the
    last step's metrics. ``max_steps`` truncates the run; ``device`` is a
    torch device, ``None`` meaning ``"cuda"`` (raising where CUDA is
    absent)."""
    unported_keys(cfg)
    dev = resolve_device(device)
    seed = resolve_seed(cfg)
    # seed host RNGs BEFORE dataset construction (reference main_pretrain.py:80)
    seed_everything(seed)
    loader = build_pretrain_loader(cfg, seed=seed)
    steps_per_epoch = max(len(loader), 1)
    spec = spec_from_cfg(cfg, steps_per_epoch)
    # with on-device augmentation the multicrop runs inside the step
    device_augs = ([dict(a) for a in cfg.get("augmentations", [])]
                   if cfg.get("device_augmentations", False) else None)
    state, train_step, model, head = build_dino(spec, device=str(dev), seed=seed,
                                                device_augmentations=device_augs)

    print("student parameters (backbone):\n" + pretty_param_summary(state.student["backbone"]))
    print("student parameters (head):\n" + pretty_param_summary(state.student["head"]))

    # checkpointing + auto-resume (reference main_pretrain.py:211-230); resume
    # is EXACT-step: deterministic batch order, per-sample augmentation
    # generators, the whole train state restored
    ckptr = None
    start_epoch = 0
    start_step = 0
    if cfg.checkpoint.enabled:
        resume_path = cfg.get("resume_from_checkpoint")
        run_id = None
        if resume_path is None and cfg.auto_resume.enabled:
            resume_path, run_id = AutoResumer(
                checkpoint_dir=os.path.join(cfg.checkpoint.dir, cfg.get("method", "dino")),
                max_hours=cfg.auto_resume.get("max_hours", 36),
            ).find_checkpoint(cfg)
        if resume_path:
            state = restore_state(resume_path, state)
            start_step = state.step
            start_epoch = start_step // steps_per_epoch
            print(f"auto-resumed from {resume_path} at step {start_step} "
                  f"(epoch {start_epoch})")
        ckptr = Checkpointer(cfg, base_dir=cfg.checkpoint.dir,
                             frequency=cfg.checkpoint.frequency,
                             keep_prev=cfg.checkpoint.get("keep_prev", False),
                             run_id=run_id)

    # preemption hook (reference SLURMEnvironment(requeue_signal=SIGUSR1)):
    # SIGTERM/SIGUSR1 -> checkpoint at the current step and return; a second
    # signal exits at once. The previous handlers come back when the run ends.
    preempted = threading.Event()

    def _on_preempt(*_):
        if preempted.is_set():
            raise SystemExit(143)
        preempted.set()

    previous = {}
    if threading.current_thread() is threading.main_thread():
        for _sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                previous[_sig] = signal.signal(_sig, _on_preempt)
            except (ValueError, OSError):  # pragma: no cover
                pass
    try:
        return _train(cfg, loader, spec, state, train_step, ckptr, dev, start_epoch,
                      start_step, steps_per_epoch, max_steps, preempted, seed,
                      device_augs is not None)
    finally:
        for _sig, handler in previous.items():
            # None: the handler was not installed from Python
            signal.signal(_sig, signal.SIG_DFL if handler is None else handler)


def _train(cfg, loader, spec, state, train_step, ckptr, dev, start_epoch, start_step,
           steps_per_epoch, max_steps, preempted, seed, device_augs) -> Dict:
    step_ckpt_every = int(cfg.checkpoint.get("step_frequency", 0) or 0) \
        if cfg.checkpoint.enabled else 0
    log_every = cfg.get("log_every", 50)
    logger = MetricLogger(ckptr.path if ckptr else ".", stdout_every=log_every)
    timer = StepTimer(device=dev)
    guard = HostMemGuard(cfg.get("host_mem_guard_mb"))
    # the crops go over as float32 and are cast on the device
    casts = {"crops": spec.dtype} if spec.dtype != torch.float32 else {}

    def _upload(item):
        g, batch = item  # the global step this batch feeds
        if device_augs:
            # the raw planes as they are; the step converts them and draws
            # its views from a generator of (seed + 1, g), as JAX folds g in
            out = to_device({"images": batch["images"],
                             "channel_counts": batch["channel_counts"]}, dev)
            out["generator"] = aug_generator(seed + 1, g, dev)
            return out
        return to_device({"crops": batch["crops"], "channel_counts": batch["channel_counts"]},
                         dev, casts)

    metrics = {}
    done = 0
    gstep = start_step  # mirror of state.step
    for epoch in range(start_epoch, cfg.max_epochs):
        loader.set_epoch(epoch)
        skip = start_step % steps_per_epoch if epoch == start_epoch else 0
        # mid-epoch resume starts the loader AT the skip point: the consumed
        # prefix is neither decoded nor collated (HostLoader.iter_from)
        batches = device_prefetch(enumerate(loader.iter_from(skip), start=gstep),
                                  upload=_upload, depth=int(cfg.get("device_prefetch", 2)))
        for wait, dev_batch in _timed(batches):
            state, metrics = train_step(state, dev_batch)
            timer.tick(wait)
            done += 1
            gstep += 1
            if done % log_every == 0:
                logger.log({**{k: float(v) for k, v in metrics.items()},
                            **timer.summary(cfg.optimizer.batch_size),
                            "host_rss_gb": round(host_rss_bytes() / 2**30, 3)},
                           step=gstep)
                guard.check(lambda: ckptr.save_step(state, gstep), where=f"step {gstep}")
            if ckptr and step_ckpt_every and gstep % step_ckpt_every == 0:
                ckptr.save_step(state, gstep)
            if preempted.is_set():
                if ckptr:
                    ckptr.save_step(state, gstep)
                print(f"preemption signal: checkpointed at step {gstep}, exiting")
                return {k: float(v) for k, v in metrics.items()}
            if max_steps and done >= max_steps:
                if ckptr:
                    ckptr.save(state, epoch)
                return {k: float(v) for k, v in metrics.items()}
        if ckptr:
            ckptr.save(state, epoch)
        metrics = {k: float(v) for k, v in metrics.items()}
    return dict(metrics)
