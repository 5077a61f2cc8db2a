"""Classification / evaluation data (reference
``src/data/classification_dataloader.py``): per-dataset train/val transform
pipelines and the train/val loaders, with dense collation.

Counterpart of ``chadavit_tpu/data/classification.py`` (``EVAL_PROTOCOLS``
:35, ``prepare_transforms`` :76, ``prepare_data`` :122,
``dataset_img_channels`` :212) on the port's ``HostLoader``, datasets and
transforms. The loaders' batch order is the JAX loaders'. The probe's train
loader draws each sample's augmentation from a generator of its own
(``data/pipeline.py``), where the JAX loader draws from the pipeline's one
generator; the validation transforms draw nothing. ``native_loader`` takes
the C++ :class:`~chadavit_tpu_torch.data.native.NativeEvalLoader` for the
evaluation loaders, as JAX ``classification.py:157-180`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

from chadavit_tpu_torch.data import native
from chadavit_tpu_torch.data.datasets import DATASETS, prepare_datasets
from chadavit_tpu_torch.data.pipeline import HostLoader
from chadavit_tpu_torch.data.transforms import AugmentationPipeline

# per-dataset normalization constants (reference classification_dataloader.py:63-115)
_CIFAR_NORM = ((0.4914, 0.4822, 0.4465), (0.247, 0.243, 0.261))
_STL_NORM = ((0.4914, 0.4823, 0.4466), (0.247, 0.243, 0.261))
_IMAGENET_NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))

# Table-driven eval protocol, one row per reference pipeline
# (classification_dataloader.py:63-304). Fields:
#   scale       - train RandomResizedCrop scale range
#   interp      - train RRC interpolation ("cubic" for the albumentations
#                 microscopy pipelines, "bilinear" for the torchvision ones)
#   val         - validation geometry:
#                   "none"         no resize (cifar; images already crop-sized)
#                   "square"       square resize to crop_size (stl)
#                   "square_crop"  A.Resize(8/7*crop square) -> CenterCrop(crop)
#                   "shorter_crop" Resize(8/7*crop shorter side) -> CenterCrop(crop)
#   norm        - (mean, std) or None (microscopy sets ship un-normalized)
#   train_is_val- train pipeline IS the val pipeline (bbbc021xbray)
EVAL_PROTOCOLS = {
    "cifar10": dict(scale=(0.08, 1.0), interp="bilinear", val="none", norm=_CIFAR_NORM),
    "cifar100": dict(scale=(0.08, 1.0), interp="bilinear", val="none", norm=_CIFAR_NORM),
    "stl10": dict(scale=(0.08, 1.0), interp="bilinear", val="square", norm=_STL_NORM),
    "imagenet": dict(scale=(0.08, 1.0), interp="bilinear", val="shorter_crop", norm=_IMAGENET_NORM),
    "imagenet100": dict(scale=(0.08, 1.0), interp="bilinear", val="shorter_crop", norm=_IMAGENET_NORM),
    "idrcell100k": dict(scale=(0.08, 1.0), interp="cubic", val="square_crop", norm=None),
    "idrcell100k_3channels": dict(scale=(0.08, 1.0), interp="cubic", val="square_crop", norm=None),
    "bray": dict(scale=(0.08, 1.0), interp="cubic", val="square_crop", norm=None),
    "bbbc021": dict(scale=(0.2, 1.0), interp="cubic", val="square_crop", norm=None),
    "bbbc021xbray": dict(scale=None, interp="bilinear", val="square_crop", norm=None,
                         train_is_val=True),
    "bloodmnist": dict(scale=(0.9, 1.0), interp="bilinear", val="shorter_crop", norm=None),
    "tissuemnist": dict(scale=(0.9, 1.0), interp="bilinear", val="shorter_crop", norm=None),
    "cyclops": dict(scale=(0.9, 1.0), interp="bilinear", val="shorter_crop", norm=None),
    "transloc": dict(scale=(0.9, 1.0), interp="bilinear", val="shorter_crop", norm=None),
    "bbbc048": dict(scale=(0.2, 1.0), interp="bilinear", val="shorter_crop", norm=None),
    "mtbenchreg": dict(scale=(0.2, 1.0), interp="bilinear", val="shorter_crop", norm=None),
}

_DEFAULT_PROTOCOL = dict(scale=(0.08, 1.0), interp="cubic", val="square_crop", norm=None)


def _val_cfg(proto: dict, crop_size: int) -> dict:
    cfg = {"crop_size": crop_size}
    kind = proto["val"]
    if kind == "none":
        cfg["resize"] = {"enabled": False}
    elif kind == "square":
        cfg["resize"] = {"size": crop_size, "shorter_side": False}
    else:
        # the canonical 256->224 ratio, scaled for non-224 crops (smoke tests)
        resize = int(round(crop_size * 256 / 224))
        cfg["resize"] = {"size": resize, "shorter_side": kind == "shorter_crop"}
        cfg["center_crop"] = {"size": crop_size}
    if proto["norm"]:
        cfg["normalize"] = {"mean": list(proto["norm"][0]), "std": list(proto["norm"][1])}
    return cfg


def prepare_transforms(dataset: str, crop_size: int = 224, auto_augment: bool = False,
                       ) -> Tuple[AugmentationPipeline, AugmentationPipeline]:
    """(train_transform, val_transform) per dataset, matching the reference's
    hardcoded pipelines (``classification_dataloader.py:53-316``) row by row.

    ``auto_augment`` swaps the train pipeline for a timm-style
    RandAugment recipe (reference ``classification_dataloader.py:544-556``)."""
    proto = EVAL_PROTOCOLS.get(dataset, _DEFAULT_PROTOCOL)
    val_cfg = _val_cfg(proto, crop_size)

    if auto_augment:
        train_cfg = {
            "crop_size": crop_size,
            "rrc": {"enabled": True, "crop_min_scale": 0.08, "crop_max_scale": 1.0,
                    "interpolation": "cubic"},
            "horizontal_flip": {"prob": 0.5},
            "rand_augment": {"enabled": True, "magnitude": 9, "magnitude_std": 0.5,
                             "num_ops": 2},
            "random_erase": {"prob": 0.25},
            "normalize": {"mean": list(_IMAGENET_NORM[0]), "std": list(_IMAGENET_NORM[1])},
        }
    elif proto.get("train_is_val"):
        train_cfg = val_cfg
    else:
        train_cfg = {
            "crop_size": crop_size,
            "rrc": {"enabled": True, "crop_min_scale": proto["scale"][0],
                    "crop_max_scale": proto["scale"][1],
                    "interpolation": proto["interp"]},
            "horizontal_flip": {"prob": 0.5},
        }
        if proto["norm"]:
            train_cfg["normalize"] = {"mean": list(proto["norm"][0]),
                                      "std": list(proto["norm"][1])}
    return AugmentationPipeline(train_cfg), AugmentationPipeline(val_cfg)


def prepare_data(
    dataset: str,
    train_path: Optional[str],
    val_path: Optional[str],
    batch_size: int,
    max_channels: int,
    num_workers: int = 4,
    crop_size: int = 224,
    sample_ratio: float = 1.0,
    subset_seed=None,
    auto_augment: bool = False,
    val_transform_for_train: bool = False,
    native_loader: bool = False,
    bucket_round: int = 1,
) -> Tuple[HostLoader, Optional[HostLoader]]:
    """Build (train_loader, val_loader) (reference
    ``classification_dataloader.py:508-582``; ``main_knn.py:205-223`` passes the
    *val* transform for both splits via ``val_transform_for_train``).

    The evaluation loaders (the validation split's, and the train split's
    under ``val_transform_for_train``) group batches by channel count, so
    batch order differs from dataset index order; each batch's (feature,
    target) pairs stay aligned. The loaders' seed is 0.
    ``bucket_round`` rounds each bucket's padded width up to a multiple
    (``max_channels`` pads every batch to one width; padded channels are
    masked, so features are unchanged).

    ``native_loader=True`` with ``val_transform_for_train`` (the evaluation
    paths: a deterministic transform) takes the C++
    :class:`~chadavit_tpu_torch.data.native.NativeEvalLoader` where the
    native decoder builds and the dataset is not ``synthetic``: decode, the
    protocol's resize and centre crop (bilinear, as the host path) and
    [0, 1] normalisation in the thread pool, batches in file order padded to
    ``max_channels``, no validation loader without ``val_path``. It prints
    which decoder the loaders use. A file whose codec the build lacks raises
    :class:`~chadavit_tpu_torch.data.native.MissingCodecError`."""
    if native_loader and val_transform_for_train and dataset != "synthetic":
        batched = native.is_available()
        print("eval decoder: " + native.describe() + (
            ", whole batches in the C++ thread pool (NativeEvalLoader)" if batched
            else ", one sample at a time (the host loader)"))
        if batched:
            return _native_loaders(dataset, train_path, val_path, batch_size, max_channels,
                                   crop_size, sample_ratio, subset_seed)

    t_train, t_val = prepare_transforms(dataset, crop_size, auto_augment=auto_augment)
    if val_transform_for_train:
        t_train = t_val

    synth = dict(img_size=crop_size, max_channels=max_channels) if dataset == "synthetic" else {}
    train_ds = prepare_datasets(dataset, transform=t_train, train_path=train_path,
                                train=True, sample_ratio=sample_ratio,
                                subset_seed=subset_seed, **synth)
    # exact-width channel buckets for the evaluation loaders; the SHUFFLED
    # probe-training loader keeps full random mixing (bucketing would make
    # every gradient minibatch channel-homogeneous)
    bk = dict(bucket_by_channels=True, bucket_round=bucket_round)
    bk_train = bk if val_transform_for_train else dict(bucket_by_channels=False)
    train_loader = HostLoader(train_ds, batch_size=batch_size, max_channels=max_channels,
                              num_workers=num_workers, seed=0,
                              shuffle=not val_transform_for_train, drop_last=False,
                              **bk_train)
    val_loader = None
    if val_path is not None or dataset == "synthetic":
        val_ds = prepare_datasets(dataset, transform=t_val, train_path=val_path or train_path,
                                  train=False, **synth)
        val_loader = HostLoader(val_ds, batch_size=batch_size, max_channels=max_channels,
                                num_workers=num_workers, seed=0,
                                shuffle=False, drop_last=False, **bk)
    return train_loader, val_loader


def _native_loaders(dataset, train_path, val_path, batch_size, max_channels, crop_size,
                    sample_ratio, subset_seed):
    """(train, val or None) native eval loaders over the protocol's
    validation geometry: resize mode 0 (square), 1 (square then centre crop)
    or 2 (shorter side then centre crop) to ``crop_size * 256 / 224``."""
    mode = {"none": 0, "square": 0, "square_crop": 1, "shorter_crop": 2}[
        EVAL_PROTOCOLS.get(dataset, _DEFAULT_PROTOCOL)["val"]]
    nk = dict(batch_size=batch_size, max_channels=max_channels, size=crop_size,
              resize_mode=mode, resize_size=int(round(crop_size * 256 / 224)) if mode else 0)
    train_ds = prepare_datasets(dataset, transform=None, train_path=train_path, train=True,
                                sample_ratio=sample_ratio, subset_seed=subset_seed)
    val = None
    if val_path is not None:
        val = native.NativeEvalLoader(
            prepare_datasets(dataset, transform=None, train_path=val_path, train=False), **nk)
    return native.NativeEvalLoader(train_ds, **nk), val


def dataset_img_channels(dataset: str, default: int = 3) -> int:
    cls = DATASETS.get(dataset)
    return getattr(cls, "img_channels", default) if cls else default
