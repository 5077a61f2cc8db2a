"""On-device batched augmentation: the multicrop views of the pretrain step,
computed on the card from the raw decoded batch.

Counterpart of ``chadavit_tpu/data/device_augment.py``. The host decodes and
resizes once; random resized crop, per-channel colour jitter, grayscale,
gaussian blur, solarization, equalization, flip and normalization run as
plain torch ops over the dense ``(B, C_max, H, W)`` batch on the images'
device. The JAX module has no Pallas kernel (XLA fuses these ops), so neither
has this one. Multi-crop views come from one call, ``(num_crops, B, C_max, S, S)``.

All ops are channel-count-agnostic and safe under padding: padded channel
planes are zero and every op maps zero planes to (near-)zero planes, so the
analytic channel mask stays valid; jitter, gray and equalize re-zero the
planes past ``channel_counts`` exactly.

Every random op is split into a draw and an apply. The draws of one view are
a dict of tensors, ``{op: {name: tensor}}``, taken from a ``torch.Generator``
on the images' device (:meth:`DeviceAugmentPipeline.draw`); the apply reads
them. The names and shapes are those of the JAX module's variates (the
uniforms and Bernoullis it draws from its key tree), so a test can feed the
port JAX's own draws. The resample and blur matrices are batched products
with float32 accumulation, as the JAX module's ``preferred_element_type``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
Draws = Dict[str, Dict[str, Tensor]]

RATIO = (3 / 4, 4 / 3)  # the RRC aspect-ratio range (JAX random_resized_crop)
BLUR_SIGMA, BLUR_RADIUS = (0.1, 2.0), 4
INT_SHIFT, GAMMA = (-0.3, 0.3), (0.5, 1.5)


def aug_generator(seed: int, step: int, device) -> torch.Generator:
    """The augmentation generator of train step ``step``: seeded from
    ``(seed, step)`` alone, as the JAX loop folds the step into its key
    (``fold_in(aug_base, g)``), so an exact-step resume draws the same views."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


def _uniform(gen, shape, lo, hi, device) -> Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _bernoulli(gen, p, n, device) -> Tensor:
    return torch.rand((n,), generator=gen, device=device) < p


def _per_image(mask: Tensor) -> Tensor:
    return mask.reshape(-1, 1, 1, 1)


def _valid_planes(channel_counts: Tensor, c: int) -> Tensor:
    """(B, C, 1, 1): True on the real channel planes of each image."""
    idx = torch.arange(c, device=channel_counts.device)
    return (idx[None, :] < channel_counts[:, None]).reshape(-1, c, 1, 1)


# ---- random resized crop -------------------------------------------------
def draw_rrc(gen, b: int, scale, ratio=RATIO, device=None) -> Dict[str, Tensor]:
    return {"scale": _uniform(gen, (b,), scale[0], scale[1], device),
            "log_ratio": _uniform(gen, (b,), math.log(ratio[0]), math.log(ratio[1]), device),
            "u_y": torch.rand((b,), generator=gen, device=device),
            "u_x": torch.rand((b,), generator=gen, device=device)}


def rrc_params(d: Dict[str, Tensor], h: int, w: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-image crop boxes (y0, x0, ch, cw) in float (JAX
    ``_rand_resized_crop_params``)."""
    area = d["scale"] * (h * w)
    ar = torch.exp(d["log_ratio"])
    cw = torch.clamp(torch.sqrt(area * ar), 8.0, w)
    ch = torch.clamp(torch.sqrt(area / ar), 8.0, h)
    return d["u_y"] * (h - ch), d["u_x"] * (w - cw), ch, cw


def lerp_matrix(src_pos: Tensor, in_size: int) -> Tensor:
    """Bilinear weights as a dense ``(B, out, in_size)`` matrix, rows summing
    to 1 (edge-clamped), from fractional source coordinates ``(B, out)``."""
    src = torch.clamp(src_pos, 0.0, in_size - 1.0)
    grid = torch.arange(in_size, dtype=src.dtype, device=src.device)
    return torch.clamp(1.0 - torch.abs(src[..., None] - grid[None, None, :]), min=0.0)


def batched_resample(images: Tensor, wy: Tensor, wx: Tensor) -> Tensor:
    """(B, C, H, W) x (B, oh, H) x (B, ow, W) -> (B, C, oh, ow): two batched
    products in the images' dtype, summed in float32, the intermediate and
    the result rounded to that dtype (JAX ``_batched_resample``)."""
    dt = images.dtype
    b, c, h, w = images.shape
    oh, ow = wy.shape[1], wx.shape[1]
    # (B, oh, H) @ (B, H, C*W): the rows of every plane at once
    x = images.permute(0, 2, 1, 3).reshape(b, h, c * w)
    tmp = torch.bmm(wy.to(dt), x).reshape(b, oh, c, w)
    # (B, oh*C, W) @ (B, W, ow)
    out = torch.bmm(tmp.reshape(b, oh * c, w), wx.to(dt).transpose(1, 2))
    return out.reshape(b, oh, c, ow).permute(0, 2, 1, 3).contiguous()


def random_resized_crop(images: Tensor, size: int, d: Dict[str, Tensor]) -> Tensor:
    """Per-image crop box then bilinear resize to ``size``, (B, C, H, W) ->
    (B, C, size, size), as two interpolation-matrix products."""
    _, _, h, w = images.shape
    y0, x0, ch, cw = rrc_params(d, h, w)
    i = torch.arange(size, dtype=torch.float32, device=images.device)[None, :]
    src_y = y0[:, None] + (i + 0.5) * (ch[:, None] / size) - 0.5
    src_x = x0[:, None] + (i + 0.5) * (cw[:, None] / size) - 0.5
    return batched_resample(images, lerp_matrix(src_y, h), lerp_matrix(src_x, w))


def _linear_resize_matrix(in_size: int, out_size: int, device) -> Tensor:
    """(out, in) weights of ``jax.image.resize(..., "linear")`` along one axis:
    the triangle kernel, widened by in/out when downsampling (antialias),
    columns normalised, samples outside the input zeroed (JAX
    ``jax._src.image.scale.compute_weight_mat`` with translation 0)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    grid = torch.arange(in_size, dtype=torch.float32, device=device)
    x = torch.abs(sample_f[None, :] - grid[:, None]) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)  # (in, out)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).t()


def resize(images: Tensor, size: int) -> Tensor:
    """Square linear resize with JAX's antialiasing, (B, C, H, W) -> (B, C,
    size, size); the input unchanged when it is that size already."""
    b, _, h, w = images.shape
    if h == size and w == size:
        return images
    wy = _linear_resize_matrix(h, size, images.device).expand(b, size, h)
    wx = _linear_resize_matrix(w, size, images.device).expand(b, size, w)
    return batched_resample(images, wy, wx)


# ---- the per-image ops ---------------------------------------------------
def draw_flip(gen, b, p, device=None):
    return {"apply": _bernoulli(gen, p, b, device)}


def horizontal_flip(images: Tensor, d: Dict[str, Tensor]) -> Tensor:
    return torch.where(_per_image(d["apply"]), images.flip(-1), images)


def draw_color_jitter(gen, b, c, p, int_shift=INT_SHIFT, gamma=GAMMA, device=None):
    return {"apply": _bernoulli(gen, p, b, device),
            "shift": _uniform(gen, (b, c), int_shift[0], int_shift[1], device),
            "gamma": _uniform(gen, (b, c), gamma[0], gamma[1], device)}


def color_jitter(images: Tensor, d: Dict[str, Tensor],
                 channel_counts: Optional[Tensor] = None) -> Tensor:
    """Per-channel intensity shift and brightness gain, clamped to [0, 1]
    (reference ``custom_transforms.py:313-351``). The float32 draws promote
    the result to float32, as in JAX. Padding-aware: planes past
    ``channel_counts`` are exactly zero."""
    b, c = images.shape[:2]
    jittered = torch.clamp((images + d["shift"].reshape(b, c, 1, 1))
                           * d["gamma"].reshape(b, c, 1, 1), 0.0, 1.0)
    out = torch.where(_per_image(d["apply"]), jittered, images)
    if channel_counts is not None:
        out = torch.where(_valid_planes(channel_counts, c), out, torch.zeros_like(out))
    return out


def draw_gray(gen, b, p, device=None):
    return {"apply": _bernoulli(gen, p, b, device)}


def to_gray(images: Tensor, d: Dict[str, Tensor], channel_counts: Tensor) -> Tensor:
    """The mean over the real channels, put on every real channel."""
    c = images.shape[1]
    counts = torch.clamp(channel_counts.to(images.dtype), min=1).reshape(-1, 1, 1, 1)
    mean = images.sum(dim=1, keepdim=True) / counts
    valid = _valid_planes(channel_counts, c)
    gray = torch.where(valid, mean, torch.zeros_like(mean))
    return torch.where(_per_image(d["apply"]), gray, images)


def draw_blur(gen, b, p, sigma=BLUR_SIGMA, device=None):
    return {"apply": _bernoulli(gen, p, b, device),
            "sigma": _uniform(gen, (b,), sigma[0], sigma[1], device)}


def gaussian_blur(images: Tensor, d: Dict[str, Tensor], radius: int = BLUR_RADIUS) -> Tensor:
    """Separable gaussian blur of a per-image sigma, fixed support, zero
    padding at the borders, normalised kernel; the 1-D kernels expanded into
    banded (S, S) matrices so that the blur is two batched products."""
    _, _, h, w = images.shape
    dev = images.device
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    k = torch.exp(-0.5 * (x[None, :] / d["sigma"][:, None]) ** 2)  # (B, K)
    k = k / k.sum(dim=1, keepdim=True)

    def band(size):
        idx = (torch.arange(size, device=dev)[None, :]
               - torch.arange(size, device=dev)[:, None]) + radius  # j - i + r
        valid = (idx >= 0) & (idx < 2 * radius + 1)
        w_band = k[:, torch.clamp(idx, 0, 2 * radius)]  # (B, S, S)
        return torch.where(valid[None], w_band, torch.zeros_like(w_band))

    blurred = batched_resample(images, band(h), band(w))
    return torch.where(_per_image(d["apply"]), blurred, images)


def draw_solarize(gen, b, p, device=None):
    return {"apply": _bernoulli(gen, p, b, device)}


def solarize(images: Tensor, d: Dict[str, Tensor], threshold: float = 0.5) -> Tensor:
    sol = torch.where(images >= threshold, 1.0 - images, images)
    return torch.where(_per_image(d["apply"]), sol, images)


def draw_equalize(gen, b, p, device=None):
    return {"apply": _bernoulli(gen, p, b, device)}


def equalize(images: Tensor, d: Dict[str, Tensor], channel_counts: Tensor,
             bins: int = 256) -> Tensor:
    """Per-channel histogram equalization on [0, 1] with the host op's two
    indexings (JAX ``equalize``): histogram bins ``floor(clip(v) * bins)``
    capped at ``bins - 1``, the CDF looked up at ``floor(v * (bins - 1))``
    clipped. The histograms are integer counts (``bincount``), exact on any
    device. Planes past ``channel_counts`` are re-zeroed."""
    b, c, h, w = images.shape
    clipped = torch.clamp(images, 0.0, 1.0)
    hist_idx = torch.clamp((clipped * bins).to(torch.int32), max=bins - 1).reshape(b * c, h * w)
    seg = hist_idx.to(torch.int64) + (torch.arange(b * c, device=images.device)
                                      * bins)[:, None]
    hist = torch.bincount(seg.flatten(), minlength=b * c * bins).reshape(b * c, bins)
    cdf = torch.cumsum(hist.to(torch.float32), dim=1)
    cdf = cdf / cdf[:, -1:]  # the total mass is H * W, never 0
    look = torch.clamp((images * (bins - 1)).to(torch.int32), 0, bins - 1)
    out = torch.gather(cdf, 1, look.reshape(b * c, h * w).to(torch.int64))
    out = out.reshape(b, c, h, w).to(images.dtype)
    out = torch.where(_valid_planes(channel_counts, c), out, torch.zeros_like(out))
    return torch.where(_per_image(d["apply"]), out, images)


def normalize(images: Tensor, mean: Sequence[float], std: Sequence[float]) -> Tensor:
    """Per-channel (x - mean) / std, the lists repeated cyclically to C."""
    c = images.shape[1]

    def per_channel(v):
        v = torch.tensor(list(v), dtype=images.dtype, device=images.device)
        return v.repeat(-(-c // v.numel()))[:c].reshape(1, c, 1, 1)

    return (images - per_channel(mean)) / per_channel(std)


class DeviceAugmentPipeline:
    """One augmentation node of the config (the reference YAML schema) as a
    view function: ``pipe(images, channel_counts, generator=..., draws=...)``
    -> ``(B, C, S, S)``. The ops run in the JAX pipeline's order; an op of
    probability 0 is skipped and draws nothing."""

    def __init__(self, cfg: Dict[str, Any]):
        def g(k, d=None):
            return cfg.get(k, d) if isinstance(cfg, dict) else getattr(cfg, k, d)

        self.size = g("crop_size", 224)
        rrc = g("rrc", {}) or {}
        self.rrc_enabled = rrc.get("enabled", False)
        self.rrc_scale = (rrc.get("crop_min_scale", 0.08), rrc.get("crop_max_scale", 1.0))
        self.cj = (g("color_jitter", {}) or {}).get("prob", 0)
        self.gray = (g("grayscale", {}) or {}).get("prob", 0)
        self.blur = (g("gaussian_blur", {}) or {}).get("prob", 0)
        self.sol = (g("solarization", {}) or {}).get("prob", 0)
        self.eq = (g("equalization", {}) or {}).get("prob", 0)
        self.flip = (g("horizontal_flip", {}) or {}).get("prob", 0)
        norm = g("normalize", None)
        self.norm = (norm.get("mean", [0.0]), norm.get("std", [1.0])) if norm else None

    def draw(self, generator: torch.Generator, b: int, c: int, device) -> Draws:
        """The draws of one view of a (b, c, ., .) batch, in op order."""
        out: Draws = {}
        if self.rrc_enabled:
            out["rrc"] = draw_rrc(generator, b, self.rrc_scale, device=device)
        if self.cj:
            out["color_jitter"] = draw_color_jitter(generator, b, c, self.cj, device=device)
        if self.gray:
            out["grayscale"] = draw_gray(generator, b, self.gray, device=device)
        if self.blur:
            out["gaussian_blur"] = draw_blur(generator, b, self.blur, device=device)
        if self.sol:
            out["solarization"] = draw_solarize(generator, b, self.sol, device=device)
        if self.eq:
            out["equalization"] = draw_equalize(generator, b, self.eq, device=device)
        if self.flip:
            out["horizontal_flip"] = draw_flip(generator, b, self.flip, device=device)
        return out

    def apply(self, images: Tensor, channel_counts: Tensor, draws: Draws) -> Tensor:
        if self.rrc_enabled:
            x = random_resized_crop(images, self.size, draws["rrc"])
        else:
            x = resize(images, self.size)
        if self.cj:
            x = color_jitter(x, draws["color_jitter"], channel_counts)
        if self.gray:
            x = to_gray(x, draws["grayscale"], channel_counts)
        if self.blur:
            x = gaussian_blur(x, draws["gaussian_blur"])
        if self.sol:
            x = solarize(x, draws["solarization"])
        if self.eq:
            x = equalize(x, draws["equalization"], channel_counts)
        if self.flip:
            x = horizontal_flip(x, draws["horizontal_flip"])
        if self.norm:
            x = normalize(x, *self.norm)
        return x

    def __call__(self, images: Tensor, channel_counts: Tensor,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Draws] = None) -> Tensor:
        if draws is None:
            b, c = images.shape[:2]
            draws = self.draw(generator, b, c, images.device)
        return self.apply(images, channel_counts, draws)


def to_unit(images: Tensor, dtype: torch.dtype) -> Tensor:
    """Raw planes to ``dtype``: uint8 over 255, uint16 over 65535 (the
    decoder's integer planes), anything else cast as it is."""
    scale = {torch.uint8: 1.0 / 255.0, torch.uint16: 1.0 / 65535.0}.get(images.dtype)
    if images.dtype == torch.uint16:  # few ops take uint16: go through int32
        images = images.to(torch.int32)
    out = images.to(dtype)
    return out * scale if scale is not None else out


def make_multicrop_fn(aug_cfgs: Sequence[Dict[str, Any]], dtype: torch.dtype = torch.float32,
                      device: Optional[str] = None):
    """Multi-crop from a raw batch, the views of the config list (2 large +
    N small in the reference recipes). Returns ``fn(images, channel_counts,
    generator=None, draws=None) -> {"crops": (n_large, B, C, S, S),
    "channel_counts", ["small_crops"]}`` in ``dtype``.

    The batch moves to ``device`` as it is (``None`` means the card, raising
    where there is none) and is converted to [0, 1] there: the host sends 1-2
    bytes a pixel. The views draw from ``generator`` in view order, or read
    ``draws``, one dict per view (:meth:`DeviceAugmentPipeline.draw`)."""
    pipelines = []
    for cfg in aug_cfgs:
        n = cfg.get("num_crops", 1) if isinstance(cfg, dict) else getattr(cfg, "num_crops", 1)
        pipelines.extend([DeviceAugmentPipeline(cfg)] * n)
    big = pipelines[0].size
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to augment on the CPU")
        device = "cuda"
    dev = torch.device(device)

    @torch.no_grad()
    def fn(images: Tensor, channel_counts: Tensor, generator: Optional[torch.Generator] = None,
           draws: Optional[Sequence[Draws]] = None) -> Dict[str, Tensor]:
        if (generator is None) == (draws is None):
            raise ValueError("pass exactly one of generator and draws")
        images = to_unit(images.to(dev, non_blocking=True), dtype)
        channel_counts = channel_counts.to(dev, non_blocking=True)
        large, small = [], []
        for i, pipe in enumerate(pipelines):
            # some ops (jitter, blur) promote to float32: pin the output dtype
            view = pipe(images, channel_counts, generator,
                        None if draws is None else draws[i]).to(dtype)
            (large if pipe.size == big else small).append(view)
        out = {"crops": torch.stack(large, 0), "channel_counts": channel_counts}
        if small:
            out["small_crops"] = torch.stack(small, 0)
        return out

    fn.pipelines = pipelines
    return fn


def draws_to(draws: Sequence[Draws], device) -> list:
    """A copy of the views' draws on ``device``."""
    return [{op: {k: v.to(device) for k, v in d.items()} for op, d in view.items()}
            for view in draws]
