"""Augmentation visualizer (reference ``src/utils/vizualize_aug.py:6``):
save a grid of raw vs augmented channel planes for one sample.

A copy of ``chadavit_tpu/utils/viz.py`` (numpy and matplotlib only)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def vizualize_aug(save_dir: str, raw_image: np.ndarray, augmented_image: np.ndarray,
                  index_to_query="sample") -> Optional[str]:
    """raw: HWC, augmented: CHW (pipeline output). Returns the saved path or
    None when matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    raw = np.asarray(raw_image)
    aug = np.asarray(augmented_image)
    if aug.ndim == 3 and aug.shape[0] <= 16:  # CHW -> HWC planes
        aug = aug.transpose(1, 2, 0)
    c = min(raw.shape[-1], aug.shape[-1])
    fig, axes = plt.subplots(2, c, figsize=(2.2 * c, 4.6), squeeze=False)
    for i in range(c):
        axes[0][i].imshow(raw[..., i], cmap="gray")
        axes[0][i].set_title(f"raw ch{i}", fontsize=8)
        axes[1][i].imshow(aug[..., i], cmap="gray")
        axes[1][i].set_title(f"aug ch{i}", fontsize=8)
        for ax in (axes[0][i], axes[1][i]):
            ax.axis("off")
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"aug_{index_to_query}.png")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
