"""Feature extraction with the reference's channel-strategy semantics.

Counterpart of ``chadavit_tpu/eval/features.py`` (``features_dim`` :26,
``make_feature_fn`` :36, ``extract_features`` :77). The reference regroups
backbone outputs per strategy (reference ``src/methods/base.py:508-559``,
``linear.py:400-427``):

- ``multi_channels`` (ChAdaViT) + ``return_all_tokens=False`` -> CLS ``(B, D)``;
- ``multi_channels`` + ``return_all_tokens=True`` with a fixed per-dataset
  channel count ``c`` -> all real tokens flattened ``(B, c*N*D)``;
- ``one_channel`` (a plain ViT per channel plane) and the RGB / fixed-channel
  ViT need ``models/vit.py``, which is not ported: they raise
  ``NotImplementedError`` naming ``channels_strategy``.

``mixed_channels`` batches (ragged counts) only support the CLS mode; the
reference disables regrouping there (``base.py:537``).

A feature function takes the backbone module: ``fn(model, images,
channel_counts) -> (B, F)``. On CUDA tensors the model runs the port's
kernels, on CPU tensors their plain versions.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from chadavit_tpu_torch.data.pipeline import device_prefetch, to_device


def features_dim(strategy: Optional[str], embed_dim: int, num_patches: int,
                 img_channels: int, return_all_tokens: bool) -> int:
    """Feature dimensionality per strategy (reference ``base.py:209-230``)."""
    if strategy == "multi_channels":
        return img_channels * num_patches * embed_dim if return_all_tokens else embed_dim
    if strategy == "one_channel":
        return img_channels * num_patches * embed_dim if return_all_tokens else img_channels * embed_dim
    return embed_dim


def make_feature_fn(
    model,
    strategy: Optional[str],
    return_all_tokens: bool = False,
    mixed_channels: bool = False,
    img_channels: int = 1,
) -> Callable:
    """Build ``fn(model, images, channel_counts) -> (B, F)`` features.

    ``images`` is dense ``(B, C_max, H, W)``; for fixed-channel datasets
    ``C_max == img_channels`` and all counts equal."""
    if strategy != "multi_channels":
        raise NotImplementedError(
            f"channels_strategy={strategy!r}: the port has only ChAdaViT's "
            "'multi_channels'; 'one_channel' and the plain ViT need models/vit.py")
    num_patches = model.num_patches

    def multi_channels(m, images, channel_counts):
        if return_all_tokens and not mixed_channels:
            tokens, _ = m(images, channel_counts, return_dense_tokens=True)
            # fixed channel count: the first img_channels*N tokens are real
            return tokens[:, :img_channels * num_patches].reshape(tokens.shape[0], -1)
        return m(images, channel_counts)

    return multi_channels


def extract_features(loader, feature_fn: Callable, model) -> Tuple[np.ndarray, np.ndarray]:
    """Run the feature fn over a loader (reference ``base.py:901-981`` /
    ``main_knn.py:44-70``) on the model's device, under
    ``torch.inference_mode``. Returns numpy ``(features, targets)``.

    The uploads run a batch ahead in a side thread (:func:`device_prefetch`).
    Each batch's features are copied to pinned host memory behind its forward
    and read one batch late, so that batch N+1's forward is queued before the
    host waits for batch N's copy, as JAX keeps one extraction in flight."""
    dev = next(model.parameters()).device
    dtype = getattr(model, "dtype", torch.float32)

    def _upload(batch):
        out = to_device({"images": batch["images"],
                         "channel_counts": batch["channel_counts"]}, dev,
                        {"images": dtype})
        return out["images"], out["channel_counts"], batch["labels"]

    def _start_fetch(out):
        out = out.float()
        if out.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _finish_fetch(pending):
        host, done = pending
        if done is not None:
            done.synchronize()
        return host.numpy().copy()

    feats, targets = [], []
    pending = None
    with torch.inference_mode():
        for images, counts, labels in device_prefetch(iter(loader), _upload, depth=2):
            started = _start_fetch(feature_fn(model, images, counts))
            if pending is not None:
                feats.append(_finish_fetch(pending))
            pending = started
            targets.append(np.asarray(labels))
        if pending is not None:
            feats.append(_finish_fetch(pending))
    return np.concatenate(feats), np.concatenate(targets)
