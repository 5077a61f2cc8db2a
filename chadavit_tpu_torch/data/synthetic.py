"""Synthetic microscopy-like image rendering with learnable class structure.

A copy of ``chadavit_tpu/data/synthetic.py`` (numpy only), so that the port
renders the same images without importing the JAX package; its dataset also
has ``get(index, aug_rng)``, as the port's datasets do (``datasets.py``).

Two consumers share the renderer:
- :class:`SyntheticStructured` — an in-memory labeled dataset for learning
  tests (can DINO + kNN beat chance?) and dataset-free smoke configs;
- ``tools/generate_disk_dataset.py`` — writes the same images as on-disk
  PNG/TIFF per-channel planes + CSV manifest (decode benchmarks, learning
  runs through the full production path).

Each image is gaussian blobs ("cells") + band-limited background texture +
shot noise; when ``num_classes > 0`` the class determines a sinusoidal
texture orientation and spatial frequency shared by all channels of the
image — a translation-invariant signature any reasonable embedding separates,
so kNN accuracy on learned features is a clean learning-dynamics probe.
(The reference has no equivalent; its value proposition is learned-embedding
quality, reference ``README.md:71-95``.)
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def render_structured_image(seed: int, img_size: int, n_channels: int,
                            depth: int, label: int, num_classes: int) -> np.ndarray:
    """(H, W, C) integer planes (uint8 when depth 8, uint16 when 16)."""
    rng = np.random.default_rng(seed)
    h = w = img_size
    ax_y = np.arange(h, dtype=np.float32)
    ax_x = np.arange(w, dtype=np.float32)
    planes = []
    if num_classes:
        # class signature: texture orientation + spatial frequency
        theta = np.pi * label / num_classes
        freq = 2.0 * np.pi * (4 + 3 * (label % 4)) / img_size
        yy = ax_y[:, None] * np.float32(np.sin(theta))
        xx = ax_x[None, :] * np.float32(np.cos(theta))
    coarse_n = max(h // 8, 1)
    up = h // coarse_n
    for _ in range(n_channels):
        img = np.zeros((h, w), np.float32)
        # gaussian blobs ("cells"); isotropic -> separable outer product
        for _b in range(int(rng.integers(3, 9))):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            s = rng.uniform(max(h / 40.0, 2.0), max(h / 10.0, 4.0))
            a = rng.uniform(0.3, 1.0)
            gy = np.exp(-((ax_y - cy) ** 2) / (2 * s * s))
            gx = np.exp(-((ax_x - cx) ** 2) / (2 * s * s))
            img += a * np.outer(gy, gx)
        # band-limited background texture (coarse noise, nearest upsampled)
        coarse = rng.random((coarse_n, coarse_n)).astype(np.float32)
        img += 0.25 * np.kron(coarse, np.ones((up, up), np.float32))[:h, :w]
        if num_classes:
            phase = rng.uniform(0, 2 * np.pi)
            img += 0.35 * np.sin(freq * (xx + yy) + phase).astype(np.float32)
        img += rng.normal(0, 0.02, (h, w)).astype(np.float32)  # shot noise
        img -= img.min()
        img /= max(img.max(), 1e-6)
        planes.append(img)
    stack = np.stack(planes, -1)
    if depth == 16:
        return (stack * 65535.0 + 0.5).astype(np.uint16)
    return (stack * 255.0 + 0.5).astype(np.uint8)


class SyntheticStructured:
    """In-memory labeled dataset over :func:`render_structured_image`.

    Samples are HWC integer planes (like decoded microscopy files); pass a
    transform for host augmentation or leave ``None`` for the raw-transfer
    device-augmentation path. Deterministic per (seed, index)."""

    task = "pretrain"
    NUM_CLASSES = 8

    def __init__(self, n: int = 512, img_size: int = 64, min_channels: int = 1,
                 max_channels: int = 4, num_classes: int = NUM_CLASSES,
                 transform: Optional[Callable] = None, seed: int = 0,
                 depth: int = 8, train: bool = True):
        self.n, self.img_size = n, img_size
        self.min_channels, self.max_channels = min_channels, max_channels
        self.num_classes = num_classes
        self.transform = transform
        # disjoint index streams for train/val splits of the same spec
        self.seed = seed + (0 if train else 500_000_011)
        self.depth = depth

    def __len__(self):
        return self.n

    def channel_count(self, index: int) -> int:
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        return int(rng.integers(self.min_channels, self.max_channels + 1))

    def __getitem__(self, index: int):
        return self.get(index)

    def get(self, index: int, aug_rng=None):
        """Sample ``index``; ``aug_rng`` goes to the transform (None: its own)."""
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        c = int(rng.integers(self.min_channels, self.max_channels + 1))
        # unlabeled mode (num_classes=0): no class signature, sentinel label
        label = int(rng.integers(0, self.num_classes)) if self.num_classes > 0 else -1
        img = render_structured_image(self.seed * 1_000_003 + index + 1,
                                      self.img_size, c, self.depth, label,
                                      self.num_classes)
        if self.transform is not None:
            img = self.transform(img, aug_rng)
        return img, label
