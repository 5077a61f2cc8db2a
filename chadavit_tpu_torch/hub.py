"""High-level embedding API — the ``HOW_TO_USE.ipynb`` contract, in PyTorch.

Counterpart of ``chadavit_tpu/hub.py`` (``load_chadavit16_moyen`` :23,
``collate_images`` :48, ``extract_embeddings`` :66): build
``chadavit16-moyen`` (patch 16, embed 192, depth 12, heads 2, max 10
channels), load a checkpoint with the ``encoder->backbone->strip`` remap,
collate a ragged list of ``(C_i, H, W)`` images, and extract ``(B, 192)`` CLS
embeddings. The model runs on the GPU unless the caller asks for the CPU.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from chadavit_tpu_torch.models.chada_vit import ChAdaViT, chada_vit, random_state_dict
from chadavit_tpu_torch.models.import_torch import import_backbone_checkpoint

CHADAVIT16_MOYEN_MD5 = "e8a24ac58b8e34bdce10e0024d507f2e"  # HOW_TO_USE cell-8/9


def load_chadavit16_moyen(checkpoint: Optional[str] = None, img_size: int = 224,
                          dtype: torch.dtype = torch.float32,
                          device: Optional[str] = None, seed: int = 0,
                          verify_md5: bool = False) -> ChAdaViT:
    """The canonical checkpoint config, in eval mode on ``device``.

    ``dtype`` is the compute dtype (float32 or bfloat16), as in the JAX hub
    (``hub.py:31-32``): the parameters stay float32 on the device, LayerNorm
    parameters included, and are cast at use. ``device=None`` means
    ``"cuda"``, and raises where CUDA is absent: pass ``device="cpu"`` to run
    the plain versions on the CPU. With no ``checkpoint`` the weights come
    from ``seed`` through numpy (:func:`random_state_dict`).
    ``verify_md5=True`` checks the published checkpoint hash (cell-8/9).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("load_chadavit16_moyen: CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        device = "cuda"
    model = chada_vit(patch_size=16, embed_dim=192, return_all_tokens=False,
                      max_number_channels=10, img_size=img_size, dtype=dtype)
    if checkpoint and verify_md5:
        with open(checkpoint, "rb") as f:
            digest = hashlib.md5(f.read()).hexdigest()
        if digest != CHADAVIT16_MOYEN_MD5:
            raise ValueError(
                f"checkpoint md5 {digest} != published {CHADAVIT16_MOYEN_MD5}")
    sd = import_backbone_checkpoint(checkpoint) if checkpoint else random_state_dict(model, seed)
    model.load_state_dict(sd)
    return model.to(device=device).eval()


def collate_images(images: Sequence[np.ndarray], max_channels: int = 10
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged list of ``(C_i, H, W)`` arrays -> dense ``(B, C_max, H, W)``
    float32 plus ``(B,)`` int32 counts, on the CPU."""
    b = len(images)
    h, w = np.asarray(images[0]).shape[-2:]
    dense = np.zeros((b, max_channels, h, w), np.float32)
    counts = np.empty((b,), np.int32)
    for i, img in enumerate(images):
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = img[None]
        c = min(img.shape[0], max_channels)
        dense[i, :c] = img[:c]
        counts[i] = c
    return torch.from_numpy(dense), torch.from_numpy(counts)


@torch.inference_mode()
def extract_embeddings(model: ChAdaViT, images: Sequence[np.ndarray],
                       batch_size: int = 64, max_channels: int = 10) -> np.ndarray:
    """``(B, D)`` float32 CLS embeddings for a ragged list of multi-channel
    images, ``batch_size`` images per forward, on the model's device and in
    its compute dtype (the images are cast to it)."""
    device = next(model.parameters()).device
    out = []
    for s in range(0, len(images), batch_size):
        x, cc = collate_images(images[s:s + batch_size], max_channels)
        x = x.to(device=device, dtype=model.dtype)
        emb = model(x, cc.to(device))
        out.append(emb.float().cpu().numpy())
    return np.concatenate(out)


def random_images(channel_counts: Sequence[int], img_size: int = 224,
                  seed: int = 0) -> list:
    """``(c, img_size, img_size)`` float32 images drawn uniformly in [0, 1)
    from ``seed``, one per count: the seeded inputs of the smoke run and of
    the committed JAX fixture."""
    rng = np.random.default_rng(seed)
    return [rng.random((c, img_size, img_size), dtype=np.float32)
            for c in channel_counts]
