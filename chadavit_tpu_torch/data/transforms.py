"""Channel-count-agnostic augmentations, numpy/cv2-based.

A copy of ``chadavit_tpu/data/transforms.py`` (numpy; cv2 optional exactly
as there), so that the port augments as the JAX package does without
importing it. The pretrain loader (``data/pipeline.py::HostLoader``) hands
each sample its own generator, so the crops do not depend on the order in
which worker threads reach the samples.

Re-implements the semantics of the reference's albumentations pipeline for
multichannel microscopy (reference ``src/data/pretrain_dataloader.py:230-328``
and ``src/data/custom_transforms.py``) without albumentations:

- images are HWC float32 with any channel count;
- ``CustomColorJitter`` is the paper's microscopy jitter: an independent
  per-channel intensity shift followed by a brightness blend toward zero with
  per-channel gamma, clamped to [0, 1] (reference ``custom_transforms.py:313-351``);
- geometric ops (RRC, flip, resize) apply to all channels jointly; photometric
  ops are per-channel.

Each op is a callable ``(img, rng) -> img``; ``AugmentationPipeline`` composes
them from the same YAML node schema the reference uses, and
``NCropAugmentation`` / ``FullTransformPipeline`` reproduce the multi-crop
wrappers (reference ``pretrain_dataloader.py:132-228``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

Array = np.ndarray
Rng = np.random.Generator


_INTERP = {"cubic": 2, "bilinear": 1, "nearest": 0}  # cv2 codes when available


def _resize(img: Array, h: int, w: int, interp: str = "cubic") -> Array:
    if cv2 is not None:
        code = {"cubic": cv2.INTER_CUBIC, "bilinear": cv2.INTER_LINEAR,
                "nearest": cv2.INTER_NEAREST}[interp]
        out = cv2.resize(img, (w, h), interpolation=code)
        if out.ndim == 2:
            out = out[:, :, None]
        return out
    # nearest fallback
    ys = (np.arange(h) * img.shape[0] / h).astype(int)
    xs = (np.arange(w) * img.shape[1] / w).astype(int)
    return img[ys][:, xs]


class RandomResizedCrop:
    """``interp`` matches the source pipeline: the reference's albumentations
    microscopy RRCs pin ``cv2.INTER_CUBIC`` (``classification_dataloader.py:124``)
    while its torchvision RRCs use the bilinear default."""

    def __init__(self, size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interp: str = "cubic"):
        self.size, self.scale, self.ratio, self.interp = size, scale, ratio, interp

    def __call__(self, img: Array, rng: Rng) -> Array:
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = rng.uniform(*self.scale) * area
            log_r = rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1]))
            ar = np.exp(log_r)
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                y = rng.integers(0, h - ch + 1)
                x = rng.integers(0, w - cw + 1)
                return _resize(img[y : y + ch, x : x + cw], self.size, self.size, self.interp)
        return _resize(img, self.size, self.size, self.interp)  # fallback: full-image resize


class Resize:
    """Square resize (albumentations ``A.Resize(h, w)``) or torchvision-style
    shorter-side resize (``transforms.Resize(size)``) when ``shorter_side``."""

    def __init__(self, size: int, shorter_side: bool = False, interp: str = "bilinear"):
        self.size, self.shorter_side, self.interp = size, shorter_side, interp

    def __call__(self, img: Array, rng: Rng) -> Array:
        if not self.shorter_side:
            return _resize(img, self.size, self.size, self.interp)
        h, w = img.shape[:2]
        if h <= w:
            nh, nw = self.size, max(1, int(round(w * self.size / h)))
        else:
            nh, nw = max(1, int(round(h * self.size / w))), self.size
        return _resize(img, nh, nw, self.interp)


class CenterCrop:
    """Deterministic center crop (torchvision ``CenterCrop`` / ``A.CenterCrop``),
    zero-padding when the image is smaller than the crop."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Array, rng: Rng) -> Array:
        h, w = img.shape[:2]
        s = self.size
        if h < s or w < s:
            pad_h, pad_w = max(s - h, 0), max(s - w, 0)
            img = np.pad(img, ((pad_h // 2, pad_h - pad_h // 2),
                               (pad_w // 2, pad_w - pad_w // 2), (0, 0)))
            h, w = img.shape[:2]
        y = (h - s) // 2
        x = (w - s) // 2
        return img[y : y + s, x : x + s]


class CustomColorJitter:
    """Per-channel intensity shift + gamma/brightness blend (reference
    ``custom_transforms.py:301-367``; defaults shift +-0.3, gamma 0.5-1.5)."""

    def __init__(self, int_min_shift=-0.3, int_max_shift=0.3,
                 gamma_min=0.5, gamma_max=1.5, p=0.5):
        self.int_min_shift, self.int_max_shift = int_min_shift, int_max_shift
        self.gamma_min, self.gamma_max = gamma_min, gamma_max
        self.p = p

    def __call__(self, img: Array, rng: Rng) -> Array:
        if rng.random() >= self.p:
            return img
        c = img.shape[-1]
        shifts = rng.uniform(self.int_min_shift, self.int_max_shift, c).astype(np.float32)
        gammas = rng.uniform(self.gamma_min, self.gamma_max, c).astype(np.float32)
        out = (img + shifts) * gammas  # shift then brightness blend toward zero
        return np.clip(out, 0.0, 1.0).astype(np.float32)


class ToGray:
    """Mean over channels broadcast back to every channel (channel-agnostic
    analogue of A.ToGray used at grayscale.prob, ``pretrain_dataloader.py:303``)."""

    def __init__(self, p=0.2):
        self.p = p

    def __call__(self, img: Array, rng: Rng) -> Array:
        if rng.random() >= self.p:
            return img
        g = img.mean(axis=-1, keepdims=True)
        return np.repeat(g, img.shape[-1], axis=-1).astype(img.dtype)


class GaussianBlur:
    def __init__(self, p=0.5, sigma=(0.1, 2.0)):
        self.p, self.sigma = p, sigma

    def __call__(self, img: Array, rng: Rng) -> Array:
        if rng.random() >= self.p:
            return img
        s = rng.uniform(*self.sigma)
        if cv2 is not None:
            out = cv2.GaussianBlur(img, (0, 0), sigmaX=s, sigmaY=s)
            if out.ndim == 2:
                out = out[:, :, None]
            return out
        return img


class Solarization:
    """Invert pixels above a threshold (reference ``pretrain_dataloader.py:113-127``)."""

    def __init__(self, p=0.0, threshold=0.5):
        self.p, self.threshold = p, threshold

    def __call__(self, img: Array, rng: Rng) -> Array:
        if rng.random() >= self.p:
            return img
        return np.where(img >= self.threshold, 1.0 - img, img).astype(img.dtype)


class Equalization:
    """Per-channel histogram equalization on the [0,1] range (reference
    ``pretrain_dataloader.py:128-131`` / A.Equalize)."""

    def __init__(self, p=0.0, bins=256):
        self.p, self.bins = p, bins

    def __call__(self, img: Array, rng: Rng) -> Array:
        if rng.random() >= self.p:
            return img
        out = np.empty_like(img)
        for c in range(img.shape[-1]):
            ch = img[..., c]
            hist, edges = np.histogram(np.clip(ch, 0, 1), bins=self.bins, range=(0, 1))
            cdf = hist.cumsum().astype(np.float64)
            if cdf[-1] == 0:
                out[..., c] = ch
                continue
            cdf /= cdf[-1]
            idx = np.clip((ch * (self.bins - 1)).astype(int), 0, self.bins - 1)
            out[..., c] = cdf[idx].astype(img.dtype)
        return out


class RandomChannelDiscard:
    """Randomly drop up to ``max_discard`` channels from a multichannel image
    (reference ``RandomDiscarder``, ``channels_strategies.py:8-28`` — present
    but unused in the reference's canonical configs; opt-in here too)."""

    def __init__(self, max_discard: int = 1, p: float = 0.5):
        self.max_discard = max_discard
        self.p = p

    def __call__(self, img: Array, rng: Rng) -> Array:
        c = img.shape[-1]
        if c <= 1 or rng.random() >= self.p:
            return img
        n_drop = int(rng.integers(1, self.max_discard + 1))
        n_drop = min(n_drop, c - 1)
        keep = np.sort(rng.choice(c, c - n_drop, replace=False))
        return img[..., keep]


class RandAugment:
    """timm-style RandAugment (``rand-m9-mstd0.5-inc1``): ``num_ops`` ops drawn
    per image, each applied with prob 0.5 at magnitude ~ N(m, std) clipped to
    [0, 10] with *increasing*-severity mappings. Channel-count-agnostic
    reimplementation for HWC float [0,1] images (the reference delegates to
    ``timm.data.create_transform``, ``classification_dataloader.py:544-556``;
    ops match timm's rand set, not bit-exactly its PIL kernels)."""

    def __init__(self, num_ops: int = 2, magnitude: float = 9.0,
                 magnitude_std: float = 0.5, op_prob: float = 0.5):
        self.num_ops, self.m, self.m_std, self.op_prob = num_ops, magnitude, magnitude_std, op_prob
        self.op_names = [
            "autocontrast", "equalize", "rotate", "posterize", "solarize",
            "solarize_add", "color", "contrast", "brightness", "sharpness",
            "shear_x", "shear_y", "translate_x", "translate_y",
        ]

    # --- helpers -----------------------------------------------------------
    @staticmethod
    def _warp(img: Array, mat: Array) -> Array:
        if cv2 is None:
            return img
        h, w = img.shape[:2]
        out = np.empty_like(img)
        for c in range(img.shape[-1]):  # cv2 caps channels at 4; microscopy has 10
            out[..., c] = cv2.warpAffine(img[..., c], mat, (w, h),
                                         flags=cv2.INTER_LINEAR, borderValue=0.0)
        return out

    @staticmethod
    def _blend(a: Array, b: Array, factor: float) -> Array:
        return np.clip(b + factor * (a - b), 0.0, 1.0).astype(np.float32)

    def _apply(self, name: str, img: Array, frac: float, rng: Rng) -> Array:
        h, w = img.shape[:2]
        sign = 1.0 if rng.random() < 0.5 else -1.0
        if name == "autocontrast":
            out = np.empty_like(img)
            for c in range(img.shape[-1]):
                ch = img[..., c]
                lo, hi = float(ch.min()), float(ch.max())
                out[..., c] = (ch - lo) / (hi - lo) if hi > lo else ch
            return out
        if name == "equalize":
            return Equalization(p=1.0)(img, rng)
        if name == "rotate":
            ang = sign * frac * 30.0
            mat = cv2.getRotationMatrix2D((w / 2, h / 2), ang, 1.0) if cv2 is not None else None
            return self._warp(img, mat) if mat is not None else img
        if name == "posterize":
            bits = max(1, 4 - int(frac * 4))
            q = float(1 << bits)
            return (np.floor(img * (q - 1)) / (q - 1)).astype(np.float32)
        if name == "solarize":
            thr = 1.0 - frac
            return np.where(img >= thr, 1.0 - img, img).astype(np.float32)
        if name == "solarize_add":
            add = frac * 110.0 / 255.0
            return np.where(img < 0.5, np.clip(img + add, 0, 1), img).astype(np.float32)
        if name == "color":  # saturation toward per-pixel gray
            gray = img.mean(axis=-1, keepdims=True)
            return self._blend(img, np.broadcast_to(gray, img.shape), 1.0 + sign * frac * 0.9)
        if name == "contrast":
            mean = float(img.mean())
            return self._blend(img, np.full_like(img, mean), 1.0 + sign * frac * 0.9)
        if name == "brightness":
            return self._blend(img, np.zeros_like(img), 1.0 + sign * frac * 0.9)
        if name == "sharpness":
            if cv2 is None:
                return img
            blurred = cv2.GaussianBlur(img, (3, 3), 0)
            if blurred.ndim == 2:
                blurred = blurred[:, :, None]
            return self._blend(img, blurred, 1.0 + sign * frac * 0.9)
        if name == "shear_x" or name == "shear_y":
            v = sign * frac * 0.3
            mat = np.array([[1, v, 0], [0, 1, 0]] if name == "shear_x"
                           else [[1, 0, 0], [v, 1, 0]], np.float32)
            return self._warp(img, mat)
        if name == "translate_x" or name == "translate_y":
            v = sign * frac * 0.45
            dx, dy = (v * w, 0) if name == "translate_x" else (0, v * h)
            mat = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
            return self._warp(img, mat)
        return img

    def __call__(self, img: Array, rng: Rng) -> Array:
        for name in rng.choice(self.op_names, self.num_ops, replace=True):
            if rng.random() >= self.op_prob:
                continue
            m = float(np.clip(rng.normal(self.m, self.m_std), 0.0, 10.0))
            img = self._apply(str(name), img, m / 10.0, rng)
        return img


class RandomErasing:
    """timm random erasing, mode "pixel": replace a random rectangle with
    gaussian noise (reference auto-augment recipe sets ``re_prob=0.25``)."""

    def __init__(self, p: float = 0.25, area=(0.02, 0.33), ratio=(0.3, 3.3)):
        self.p, self.area, self.ratio = p, area, ratio

    def __call__(self, img: Array, rng: Rng) -> Array:
        if rng.random() >= self.p:
            return img
        h, w = img.shape[:2]
        for _ in range(10):
            target = rng.uniform(*self.area) * h * w
            ar = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            eh, ew = int(round(np.sqrt(target / ar))), int(round(np.sqrt(target * ar)))
            if 0 < eh <= h and 0 < ew <= w:
                y = rng.integers(0, h - eh + 1)
                x = rng.integers(0, w - ew + 1)
                img = img.copy()
                img[y : y + eh, x : x + ew] = rng.normal(
                    0.0, 1.0, (eh, ew, img.shape[-1])).astype(np.float32)
                return img
        return img


class HorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img: Array, rng: Rng) -> Array:
        return img[:, ::-1] if rng.random() < self.p else img


class Normalize:
    def __init__(self, mean: Sequence[float], std: Sequence[float], p=1.0):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.p = p

    def __call__(self, img: Array, rng: Rng) -> Array:
        if rng.random() >= self.p:
            return img
        c = img.shape[-1]
        mean = np.resize(self.mean, c)
        std = np.resize(self.std, c)
        return ((img - mean) / std).astype(np.float32)


class AugmentationPipeline:
    """Compose ops from a reference-format augmentation YAML node (the schema
    documented at ``pretrain_dataloader.py:231-256``); output is CHW float32."""

    def __init__(self, cfg: dict, seed: Optional[int] = None):
        self.ops: List[Callable] = []
        g = lambda k, d=None: cfg.get(k, d) if isinstance(cfg, dict) else getattr(cfg, k, d)  # noqa: E731

        crop_size = g("crop_size", 224)
        rrc = g("rrc", {}) or {}
        resize_cfg = g("resize", None)
        if rrc.get("enabled", False):
            self.ops.append(RandomResizedCrop(
                crop_size,
                scale=(rrc.get("crop_min_scale", 0.08), rrc.get("crop_max_scale", 1.0)),
                interp=rrc.get("interpolation", "cubic"),
            ))
        elif resize_cfg is not None:
            # explicit geometric protocol: optional resize (square or
            # shorter-side) then optional center crop — the reference's eval
            # pipelines (classification_dataloader.py:63-304)
            if resize_cfg.get("enabled", True):
                self.ops.append(Resize(resize_cfg.get("size", crop_size),
                                       shorter_side=resize_cfg.get("shorter_side", False),
                                       interp=resize_cfg.get("interpolation", "bilinear")))
        else:
            self.ops.append(Resize(crop_size, interp="cubic"))
        cc = g("center_crop", None)
        if cc:
            self.ops.append(CenterCrop(cc.get("size", crop_size)))

        cj = g("color_jitter", {}) or {}
        if cj.get("prob", 0):
            self.ops.append(CustomColorJitter(
                int_min_shift=cj.get("int_min_shift", -0.3),
                int_max_shift=cj.get("int_max_shift", 0.3),
                gamma_min=cj.get("gamma_min", 0.5),
                gamma_max=cj.get("gamma_max", 1.5),
                p=cj.get("prob", 0.8),
            ))
        gs = g("grayscale", {}) or {}
        if gs.get("prob", 0):
            self.ops.append(ToGray(p=gs["prob"]))
        gb = g("gaussian_blur", {}) or {}
        if gb.get("prob", 0):
            self.ops.append(GaussianBlur(p=gb["prob"]))
        sol = g("solarization", {}) or {}
        if sol.get("prob", 0):
            self.ops.append(Solarization(p=sol["prob"]))
        eq = g("equalization", {}) or {}
        if eq.get("prob", 0):
            self.ops.append(Equalization(p=eq["prob"]))
        hf = g("horizontal_flip", {}) or {}
        if hf.get("prob", 0):
            self.ops.append(HorizontalFlip(p=hf["prob"]))
        ra = g("rand_augment", {}) or {}
        if ra.get("enabled", False):
            self.ops.append(RandAugment(num_ops=ra.get("num_ops", 2),
                                        magnitude=ra.get("magnitude", 9.0),
                                        magnitude_std=ra.get("magnitude_std", 0.5)))
        norm = g("normalize", None)
        if norm:
            self.ops.append(Normalize(norm.get("mean", [0.0]), norm.get("std", [1.0]),
                                      p=norm.get("prob", 1.0)))
        re_cfg = g("random_erase", {}) or {}
        if re_cfg.get("prob", 0):
            # after normalization, gaussian fill in normalized space (timm order)
            self.ops.append(RandomErasing(p=re_cfg["prob"]))
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: Array, rng: Optional[Rng] = None) -> Array:
        rng = rng or self.rng
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        for op in self.ops:
            img = op(img, rng)
        return np.ascontiguousarray(img.transpose(2, 0, 1))  # CHW

    def __repr__(self) -> str:  # printed by debug_augmentations
        return "Compose(" + ", ".join(type(op).__name__ for op in self.ops) + ")"


class RawResize:
    """Host-side dtype-preserving square resize to HWC — the minimal host work
    for the on-device augmentation path: decode -> resize -> transfer raw
    uint8/uint16 planes; [0,1] conversion and all random views happen on the
    accelerator (``device_augment.make_multicrop_fn``)."""

    def __init__(self, size: int, interp: str = "bilinear"):
        self.size, self.interp = size, interp

    def __call__(self, img: Array, rng=None) -> Array:
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[:2] == (self.size, self.size):
            return img
        return _resize(img, self.size, self.size, self.interp)


class NCropAugmentation:
    """Apply one pipeline N times (reference ``pretrain_dataloader.py:132-158``)."""

    def __init__(self, transform: Callable, num_crops: int):
        self.transform, self.num_crops = transform, num_crops

    def __call__(self, img: Array, rng: Optional[Rng] = None) -> List[Array]:
        return [self.transform(img, rng) for _ in range(self.num_crops)]

    def __repr__(self) -> str:  # reference pretrain_dataloader.py:156-158
        return f"{self.num_crops} x [{self.transform}]"


class FullTransformPipeline:
    """Concatenate several NCrop pipelines (reference ``pretrain_dataloader.py:186-228``)."""

    def __init__(self, transforms: Sequence[NCropAugmentation]):
        self.transforms = list(transforms)

    def __call__(self, img: Array, rng: Optional[Rng] = None) -> List[Array]:
        out: List[Array] = []
        for t in self.transforms:
            out.extend(t(img, rng))
        return out

    def __repr__(self) -> str:  # reference pretrain_dataloader.py:227-228
        return "\n".join(str(t) for t in self.transforms)


def build_transform_pipeline(dataset: str, cfg: dict, seed: Optional[int] = None) -> AugmentationPipeline:
    """Name-compatible factory (reference ``pretrain_dataloader.py:230``)."""
    return AugmentationPipeline(cfg, seed=seed)
