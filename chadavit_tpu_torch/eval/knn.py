"""Weighted k-NN evaluation as chunked matrix products on the device
(reference ``src/utils/knn.py:27-177``).

Counterpart of ``chadavit_tpu/eval/knn.py`` (``_knn_chunk`` :27,
``WeightedKNNClassifier`` :60, ``knn_classify`` :115), with the same
semantics:

- cosine distance: L2-normalised features (on the host, in float32, as JAX
  does), weights ``exp(sim / T)``;
- euclidean distance: weights ``1 / (dist + eps)``;
- the distance matrix in chunks of at most ``max_distance_matrix_size``
  entries (``knn.py:123-126``);
- ``num_classes`` from both splits' labels when not given;
- returns (top1, top5) percentages; top-5 counts a hit if the target is among
  the first ``min(5, k)`` ranked classes (``knn.py:162-169``).

Ties rank as ``lax.top_k`` and ``argsort`` rank them in JAX: equal
similarities by the lower train index, equal class scores by the lower class
index (with k = 1 every class but one scores 0). Both rankings are stable
sorts here; ``torch.topk`` promises no order among equal values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from chadavit_tpu_torch.utils.misc import resolve_device


def _l2_normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def _knn_chunk(test_feats: torch.Tensor, train_feats: torch.Tensor,
               train_targets: torch.Tensor, T: float, k: int, num_classes: int,
               distance_fx: str, epsilon: float = 1e-5) -> torch.Tensor:
    """The classes of each test row, ranked by their weighted votes."""
    prod = test_feats @ train_feats.T
    if distance_fx == "cosine":
        sims = prod
    else:
        d2 = ((test_feats * test_feats).sum(1, keepdim=True) - 2 * prod
              + (train_feats * train_feats).sum(1)[None, :])
        sims = 1.0 / (torch.sqrt(torch.clamp(d2, min=0.0)) + epsilon)
    sims_k, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    sims_k, idx = sims_k[:, :k], idx[:, :k]
    neighbors = train_targets[idx]  # (B, k)
    weights = torch.exp(sims_k / T) if distance_fx == "cosine" else sims_k
    one_hot = torch.nn.functional.one_hot(neighbors, num_classes).to(weights.dtype)
    probs = (one_hot * weights[..., None]).sum(1)  # (B, num_classes)
    return torch.argsort(-probs, dim=1, stable=True)


class WeightedKNNClassifier:
    """Accumulate train/test features, then compute top1/top5 (reference API)."""

    def __init__(self, k: int = 20, T: float = 0.07,
                 max_distance_matrix_size: int = int(5e6),
                 distance_fx: str = "cosine", epsilon: float = 1e-5,
                 num_classes: Optional[int] = None, device=None):
        self.k, self.T = k, T
        self.max_distance_matrix_size = max_distance_matrix_size
        self.distance_fx = distance_fx
        self.epsilon = epsilon
        self.num_classes = num_classes
        self.device = device
        self._train_f, self._train_t, self._test_f, self._test_t = [], [], [], []

    def update(self, train_features=None, train_targets=None,
               test_features=None, test_targets=None):
        if (train_features is None) != (train_targets is None):
            raise ValueError("train features and targets go together")
        if (test_features is None) != (test_targets is None):
            raise ValueError("test features and targets go together")
        if train_features is not None:
            self._train_f.append(_numpy(train_features))
            self._train_t.append(_numpy(train_targets))
        if test_features is not None:
            self._test_f.append(_numpy(test_features))
            self._test_t.append(_numpy(test_targets))

    def compute(self) -> Tuple[float, float]:
        if not self._train_f or not self._test_f:
            return -1.0, -1.0
        top1, top5 = knn_classify(
            np.concatenate(self._train_f), np.concatenate(self._train_t),
            np.concatenate(self._test_f), np.concatenate(self._test_t),
            k=self.k, T=self.T, distance_fx=self.distance_fx,
            max_distance_matrix_size=self.max_distance_matrix_size,
            epsilon=self.epsilon, num_classes=self.num_classes, device=self.device,
        )
        self.reset()
        return top1, top5

    def reset(self):
        self._train_f, self._train_t, self._test_f, self._test_t = [], [], [], []

    __call__ = update


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def knn_classify(
    train_features,
    train_targets,
    test_features,
    test_targets,
    k: int = 20,
    T: float = 0.07,
    distance_fx: str = "cosine",
    max_distance_matrix_size: int = int(5e6),
    epsilon: float = 1e-5,
    num_classes: Optional[int] = None,
    device=None,
) -> Tuple[float, float]:
    """Functional weighted k-NN on ``device`` (``None`` means the card);
    returns (top1%, top5%). Features and targets are numpy arrays or
    tensors."""
    dev = resolve_device(device)
    train_features = _numpy(train_features).astype(np.float32)
    test_features = _numpy(test_features).astype(np.float32)
    train_targets = _numpy(train_targets).astype(np.int64)
    test_targets = _numpy(test_targets).astype(np.int64)
    if num_classes is None:
        # both splits' label ids: a val split missing some classes must not
        # shrink the vote space
        num_classes = int(max(np.max(train_targets), np.max(test_targets))) + 1
    n_train, n_test = len(train_targets), len(test_targets)
    k = min(k, n_train)

    if distance_fx == "cosine":
        train_features, test_features = (_l2_normalize(train_features),
                                         _l2_normalize(test_features))

    chunk = min(max(1, max_distance_matrix_size // max(n_train, 1)), n_test)
    train_f = torch.from_numpy(train_features).to(dev)
    train_t = torch.from_numpy(train_targets).to(dev)
    test_f = torch.from_numpy(test_features).to(dev)
    test_t = torch.from_numpy(test_targets).to(dev)

    top1 = top5 = 0
    for s in range(0, n_test, chunk):
        order = _knn_chunk(test_f[s:s + chunk], train_f, train_t, T, k, num_classes,
                           distance_fx, epsilon)
        correct = order == test_t[s:s + chunk, None]
        top1 += int(correct[:, 0].sum())
        top5 += int(correct[:, :min(5, k, correct.shape[1])].any(dim=1).sum())
    return top1 * 100.0 / n_test, top5 * 100.0 / n_test
