"""Config system: the reference's YAML schema, parsed without Hydra/OmegaConf.

Counterpart of ``chadavit_tpu/config.py`` for the pretrain and evaluation
entry points (``Config`` :67, ``select`` :104, ``load_yaml`` :122,
``_common_defaults`` :146, the ``_*_defaults``, ``parse_pretrain_cfg`` :273,
``parse_linear_cfg`` :321, ``parse_regression_cfg`` :343, ``parse_knn_cfg``
:351, ``save_args_json`` :388), with the same defaulting rules, the lr scaling rule
``lr *= batch_size * num_devices * num_nodes / 256`` among them (reference
``args/pretrain.py:204-214``), so the same YAML files give the same config.

Hydra's ``defaults:`` list is supported minimally: entries of the form
``{augmentations: file.yaml}`` load ``<cfg_dir>/augmentations/file.yaml``;
other entries are skipped if absent. YAML is read with PyYAML, which only
:func:`load_yaml` needs: where it is missing, that function raises and the
rest of the module works.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

try:
    import yaml
except ImportError:  # only load_yaml needs it
    yaml = None

# reference args/pretrain.py:23-34
N_CLASSES_PER_DATASET = {
    "cifar10": 10,
    "cifar100": 100,
    "stl10": 10,
    "imagenet": 1000,
    "imagenet100": 100,
    "bloodmnist": 8,
    "bbbc021": 14,
    "bbbc048": 7,
    "cyclops": 17,
    "tissuemnist": 8,
}

# reference args/pretrain.py:36-51
SUPPORTED_DATASETS = [
    "cifar10", "cifar100", "stl10", "imagenet", "imagenet100",
    "idrcell100k", "idrcell100k_3channels", "bloodmnist", "bbbc021",
    "bbbc048", "cyclops", "tissuemnist", "mtbenchreg", "bray",
    "bbbc021xbray", "synthetic", "synthetic_structured",  # rebuild additions
]

# PyYAML's YAML-1.1 resolver reads '1e-6' (no dot) as a string; the loader
# below registers the full scientific-notation float pattern
_FLOAT_RE = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_LOADER = None


def _yaml_load(f):
    global _LOADER
    if yaml is None:
        raise RuntimeError("load_yaml needs PyYAML, which this Python lacks")
    if _LOADER is None:
        class _Loader(yaml.SafeLoader):
            """SafeLoader with the scientific-notation float pattern."""

        _Loader.add_implicit_resolver("tag:yaml.org,2002:float", _FLOAT_RE,
                                      list("-+0123456789."))
        _LOADER = _Loader
    return yaml.load(f, Loader=_LOADER)


class Config(dict):
    """dict with attribute access; nested dicts wrap lazily."""

    def __getattr__(self, key):
        try:
            v = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        if isinstance(v, dict) and not isinstance(v, Config):
            v = Config(v)
            self[key] = v
        return v

    def __setattr__(self, key, value):
        self[key] = value

    def to_dict(self) -> dict:
        def conv(v):
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v
        return conv(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def _wrap(obj):
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def select(cfg: Config, path: str, default: Any = None) -> Any:
    """Dotted-path get with default; the string "None" means None
    (reference ``misc.py:457-462``). Sets the default back into the config."""
    parts = path.split(".")
    node = cfg
    for p in parts[:-1]:
        if not isinstance(node, dict) or p not in node or node[p] is None:
            node[p] = Config()
        node = node[p] if isinstance(node[p], dict) else node.setdefault(p, Config())
    leaf = parts[-1]
    if isinstance(node, dict) and leaf in node and node[leaf] is not None:
        v = node[leaf]
        return None if v == "None" else v
    if isinstance(node, dict):
        node[leaf] = default
    return default


def load_yaml(path: str) -> Config:
    """Load a YAML config, resolving the minimal Hydra composition used by the
    reference configs (a ``defaults:`` list with an augmentations file)."""
    with open(path) as f:
        raw = _yaml_load(f) or {}
    cfg = _wrap(raw)
    base_dir = os.path.dirname(os.path.abspath(path))
    for entry in cfg.pop("defaults", []) or []:
        if not isinstance(entry, dict):
            continue
        for group, fname in entry.items():
            if group.startswith("override") or group == "_self_":
                continue
            sub_path = os.path.join(base_dir, str(group), str(fname))
            if not str(fname).endswith((".yaml", ".yml")):
                sub_path += ".yaml"
            if os.path.exists(sub_path):
                with open(sub_path) as f:
                    sub = _yaml_load(f)
                cfg[group] = _wrap(sub)
    cfg.pop("hydra", None)
    return cfg


def _common_defaults(cfg: Config) -> Config:
    cfg["ssl_val_loss"] = select(cfg, "ssl_val_loss", False)
    cfg["debug"] = select(cfg, "debug", False)
    select(cfg, "channels_strategy", None)
    select(cfg, "mixed_channels", False)
    # slurm block kept for config compatibility (args/pretrain.py:80-97)
    select(cfg, "slurm.enabled", False)
    select(cfg, "slurm.num_nodes", 1)
    # checkpoint / auto-resume (checkpointer.py:50-63, auto_resumer.py:109+)
    select(cfg, "checkpoint.enabled", False)
    select(cfg, "checkpoint.dir", "trained_models")
    select(cfg, "checkpoint.frequency", 1)
    select(cfg, "checkpoint.keep_prev", False)
    select(cfg, "auto_resume.enabled", False)
    select(cfg, "auto_resume.max_hours", 36)
    # mid-epoch (preemption-safe) checkpoints every N steps; 0 = epoch-only
    select(cfg, "checkpoint.step_frequency", 0)
    # training-time UMAP of val features (reference AutoUMAP callback)
    select(cfg, "auto_umap.enabled", False)
    select(cfg, "auto_umap.frequency", 1)
    # wandb (args/pretrain.py:99-116) — offline metrics logging here
    select(cfg, "wandb.enabled", False)
    select(cfg, "wandb.project", "chadavit_tpu")
    # lightning-equivalent runtime keys (args/pretrain.py:118-132)
    select(cfg, "seed", None)
    select(cfg, "resume_from_checkpoint", None)
    select(cfg, "strategy", None)
    select(cfg, "max_epochs", 100)
    select(cfg, "devices", 1)
    select(cfg, "num_nodes", 1)
    select(cfg, "precision", "bf16")
    # host-memory guard threshold in MiB (utils/misc.py::HostMemGuard)
    select(cfg, "host_mem_guard_mb", None)
    # data block (args/pretrain.py:54-78)
    select(cfg, "data.val_path", None)
    select(cfg, "data.format", "image_folder")
    select(cfg, "data.no_labels", False)
    select(cfg, "data.fraction", -1)
    select(cfg, "data.img_channels", 3)
    select(cfg, "data.max_img_channels", cfg.data.get("img_channels", 3) if "data" in cfg else 3)
    select(cfg, "data.sample_ratio", 1.0)
    select(cfg, "data.num_workers", 4)
    return cfg


def _num_devices(cfg: Config) -> int:
    devices = cfg.get("devices", 1)
    return len(devices) if isinstance(devices, (list, tuple)) else int(devices)


def _scale_lrs(cfg: Config):
    """lr scaling rule (reference args/pretrain.py:204-214)."""
    scale = cfg.optimizer.batch_size * _num_devices(cfg) * cfg.get("num_nodes", 1) / 256
    cfg.optimizer.lr = cfg.optimizer.lr * scale
    if cfg.data.get("val_path") is not None and cfg.optimizer.get("classifier_lr") is not None:
        cfg.optimizer.classifier_lr = cfg.optimizer.classifier_lr * scale
    tl_lr = select(cfg, "optimizer.token_learner_lr", None)
    if tl_lr is not None:
        cfg.optimizer.token_learner_lr = tl_lr * scale


def _optimizer_defaults(cfg: Config):
    """Per-optimizer kwarg defaults (reference args/pretrain.py:216-231)."""
    select(cfg, "optimizer.kwargs", Config())
    name = cfg.optimizer.name
    if name == "sgd":
        select(cfg, "optimizer.kwargs.momentum", 0.9)
    elif name == "lars":
        select(cfg, "optimizer.kwargs.momentum", 0.9)
        select(cfg, "optimizer.kwargs.eta", 1e-3)
        select(cfg, "optimizer.kwargs.clip_lr", False)
        select(cfg, "optimizer.kwargs.exclude_bias_n_norm", False)
    elif name == "adamw":
        select(cfg, "optimizer.kwargs.betas", [0.9, 0.999])
    select(cfg, "optimizer.exclude_bias_n_norm_wd", False)
    select(cfg, "optimizer.weight_decay", 0.0)


def _accumulate_defaults(cfg: Config):
    """Gradient accumulation rescales every lr-like quantity by the number of
    accumulated batches (reference base.py:258-272)."""
    acc = select(cfg, "accumulate_grad_batches", 1) or 1
    if acc > 1:
        cfg.optimizer.lr = cfg.optimizer.lr * acc
        if cfg.optimizer.get("classifier_lr"):
            cfg.optimizer.classifier_lr = cfg.optimizer.classifier_lr * acc
        if cfg.optimizer.get("token_learner_lr"):
            cfg.optimizer.token_learner_lr = cfg.optimizer.token_learner_lr * acc
        cfg.scheduler.min_lr = cfg.scheduler.get("min_lr", 0.0) * acc
        cfg.scheduler.warmup_start_lr = cfg.scheduler.get("warmup_start_lr", 3e-5) * acc


def _scheduler_defaults(cfg: Config):
    """Scheduler defaults (reference base.py add_and_assert_specific_cfg)."""
    select(cfg, "scheduler.name", "warmup_cosine")
    select(cfg, "scheduler.lr_decay_steps", None)
    select(cfg, "scheduler.min_lr", 0.0)
    select(cfg, "scheduler.warmup_start_lr", 3e-5)
    select(cfg, "scheduler.warmup_epochs", 10)
    select(cfg, "scheduler.interval", "step")


def _num_classes(cfg: Config):
    ds = cfg.data.dataset
    if cfg.data.get("num_classes") is not None:
        return  # explicitly configured
    if ds in N_CLASSES_PER_DATASET:
        cfg.data.num_classes = N_CLASSES_PER_DATASET[ds]
    elif ds == "synthetic":
        from chadavit_tpu_torch.data.datasets import SyntheticChannels

        cfg.data.num_classes = SyntheticChannels.NUM_CLASSES
    elif ds == "synthetic_structured":
        from chadavit_tpu_torch.data.synthetic import SyntheticStructured

        cfg.data.num_classes = SyntheticStructured.NUM_CLASSES
    else:
        train_path = cfg.data.get("train_path")
        n = 1
        if train_path and os.path.isdir(train_path):
            n = max(1, sum(e.is_dir() for e in os.scandir(train_path)))
        cfg.data.num_classes = n


def parse_pretrain_cfg(cfg: Config) -> Config:
    """Pretrain defaults (reference ``args/pretrain.py:134-233``)."""
    cfg = _common_defaults(cfg)
    select(cfg, "backbone.kwargs.return_all_tokens", False)
    select(cfg, "debug_augmentations", False)  # reference args/pretrain.py:74
    assert cfg.data.dataset in SUPPORTED_DATASETS, cfg.data.dataset

    # DINO method defaults (reference methods/dino.py:197-223)
    if cfg.get("method") == "dino":
        select(cfg, "method_kwargs.clip_grad", 0)
        select(cfg, "method_kwargs.freeze_last_layer", 1)
        select(cfg, "method_kwargs.norm_last_layer", True)
        select(cfg, "method_kwargs.use_bn_in_head", False)
        select(cfg, "method_kwargs.student_temperature", 0.1)
        select(cfg, "method_kwargs.teacher_temperature", 0.07)
        select(cfg, "method_kwargs.warmup_teacher_temperature", 0.04)
        select(cfg, "method_kwargs.warmup_teacher_temperature_epochs", 0)
    select(cfg, "momentum.base_tau", 0.996)
    select(cfg, "momentum.final_tau", 1.0)

    # exact-width channel bucketing by default: pad mixed-channel batches only
    # to the batch's true width; datasets without per-index channel counts
    # fall back (HostLoader guards on dataset.channel_count)
    select(cfg, "bucket_by_channels", True)

    _num_classes(cfg)

    # crop counting (reference args/pretrain.py:190-198)
    augs = cfg.get("augmentations") or []
    if augs:
        big = augs[0]["crop_size"]
        large = sum(a["num_crops"] for a in augs if a["crop_size"] == big)
        small = sum(a["num_crops"] for a in augs if a["crop_size"] != big)
    else:
        large, small = 2, 0
    cfg.data.num_large_crops = large
    cfg.data.num_small_crops = small

    _scale_lrs(cfg)
    _optimizer_defaults(cfg)
    _scheduler_defaults(cfg)
    _accumulate_defaults(cfg)
    return cfg


def parse_linear_cfg(cfg: Config) -> Config:
    """Linear-probe defaults (reference ``args/linear.py:127+``)."""
    cfg = _common_defaults(cfg)
    select(cfg, "backbone.kwargs.return_all_tokens", False)
    select(cfg, "pretrain_method", None)
    select(cfg, "pretrained_feature_extractor", None)
    select(cfg, "finetune", False)
    select(cfg, "auto_augment", False)
    select(cfg, "label_smoothing", 0.0)
    select(cfg, "mixup", 0.0)
    select(cfg, "cutmix", 0.0)
    select(cfg, "layer_decay", 0.0)
    select(cfg, "data.augmentations.crop_size", 224)
    select(cfg, "data.augmentations.mean", [0.485, 0.456, 0.406])
    select(cfg, "data.augmentations.std", [0.228, 0.224, 0.225])
    _num_classes(cfg)
    _scale_lrs(cfg)
    _optimizer_defaults(cfg)
    _scheduler_defaults(cfg)
    _accumulate_defaults(cfg)
    return cfg


def parse_regression_cfg(cfg: Config) -> Config:
    """Regression defaults (reference ``args/regression.py``); the linear
    skeleton with a 1-output regressor."""
    cfg = parse_linear_cfg(cfg)
    cfg.data.num_classes = 1
    return cfg


def parse_knn_cfg(cfg: Config) -> Config:
    """Offline kNN defaults (reference ``args/knn.py:133-136``)."""
    cfg = _common_defaults(cfg)
    select(cfg, "backbone.kwargs.return_all_tokens", False)
    select(cfg, "knn_eval_offline.enabled", True)
    select(cfg, "knn_eval_offline.k", [1, 2, 5, 10, 20, 50, 100, 200])
    select(cfg, "knn_eval_offline.temperature", [0.01, 0.02, 0.05, 0.07, 0.1, 0.2, 0.5, 1])
    select(cfg, "knn_eval_offline.feature_type", ["backbone"])
    select(cfg, "knn_eval_offline.distance_function", ["cosine", "euclidean"])
    select(cfg, "optimizer.batch_size", 64)
    _num_classes(cfg)
    return cfg


def save_args_json(cfg: Config, path: str):
    """Dump the full config next to checkpoints (reference checkpointer.py:119-130
    ``args.json`` sidecar — the auto-resume matching contract)."""
    with open(path, "w") as f:
        f.write(cfg.to_json())
