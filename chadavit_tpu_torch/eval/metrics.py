"""Metrics (reference ``src/utils/metrics.py`` + the torchmetrics suites of
``src/methods/linear.py:210-230`` and ``src/methods/regression.py:185-189``),
as numpy functions.

The port's copy of ``chadavit_tpu/eval/metrics.py``, which imports no JAX
either; the port keeps its own so that it imports nothing of the JAX package.

- ``accuracy_at_k``: top-k accuracy (reference ``metrics.py:26-53``).
- ``weighted_mean``: batch-size-weighted epoch averaging (``metrics.py:56-74``).
- ``confusion_matrix`` + optional heatmap PNG (``metrics.py:76-107``,
  ``linear.py:596-622``) via matplotlib when available.
- classification suite: acc1/acc5, macro precision/recall/F1, AUROC (sklearn
  when available).
- regression suite: MSE / MAE / R2 / Pearson correlation.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def accuracy_at_k(logits: np.ndarray, targets: np.ndarray, top_k: Sequence[int] = (1, 5)) -> List[float]:
    logits = np.asarray(logits)
    targets = np.asarray(targets)
    maxk = min(max(top_k), logits.shape[1])
    order = np.argsort(-logits, axis=1)[:, :maxk]
    correct = order == targets[:, None]
    out = []
    for k in top_k:
        k = min(k, maxk)
        out.append(float(correct[:, :k].any(axis=1).mean() * 100.0))
    return out


def weighted_mean(outputs: List[Dict], key: str, batch_size_key: str = "batch_size") -> float:
    """Batch-size-weighted mean over step outputs (reference ``metrics.py:56-74``)."""
    total = sum(o[batch_size_key] for o in outputs)
    if total == 0:
        return 0.0
    return float(sum(o[key] * o[batch_size_key] for o in outputs) / total)


def confusion_matrix(preds: np.ndarray, targets: np.ndarray, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), np.int64)
    for t, p in zip(np.asarray(targets).ravel(), np.asarray(preds).ravel()):
        cm[int(t), int(p)] += 1
    return cm


def plot_confusion_matrix(cm: np.ndarray, class_names: Sequence[str], path: str) -> bool:
    """Save a heatmap PNG (reference ``linear.py:596-622``); returns False if
    matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    fig, ax = plt.subplots(figsize=(max(6, len(class_names) * 0.6),) * 2)
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(class_names)), class_names, rotation=90, fontsize=7)
    ax.set_yticks(range(len(class_names)), class_names, fontsize=7)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center", fontsize=6)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return True


def classification_suite(logits: np.ndarray, targets: np.ndarray, num_classes: int) -> Dict[str, float]:
    logits = np.asarray(logits)
    targets = np.asarray(targets).astype(int)
    preds = logits.argmax(1)
    acc1, acc5 = accuracy_at_k(logits, targets, (1, 5))
    cm = confusion_matrix(preds, targets, num_classes)
    tp = np.diag(cm).astype(float)
    support = cm.sum(1)
    predicted = cm.sum(0)
    with np.errstate(divide="ignore", invalid="ignore"):
        recall = np.where(support > 0, tp / support, 0.0)
        precision = np.where(predicted > 0, tp / predicted, 0.0)
        f1 = np.where(precision + recall > 0, 2 * precision * recall / (precision + recall), 0.0)
    out = {
        "acc1": acc1,
        "acc5": acc5,
        "precision": float(precision.mean() * 100),
        "recall": float(recall.mean() * 100),
        "f1": float(f1.mean() * 100),
    }
    try:
        from sklearn.metrics import roc_auc_score

        probs = np.exp(logits - logits.max(1, keepdims=True))
        probs /= probs.sum(1, keepdims=True)
        present = np.unique(targets)
        if present.size > 1:
            out["auroc"] = float(roc_auc_score(
                targets, probs[:, present] if present.size < num_classes else probs,
                multi_class="ovr", average="macro",
                labels=present if present.size < num_classes else None,
            ) * 100)
    except Exception:
        pass
    return out


def regression_suite(preds: np.ndarray, targets: np.ndarray) -> Dict[str, float]:
    preds = np.asarray(preds, np.float64).ravel()
    targets = np.asarray(targets, np.float64).ravel()
    err = preds - targets
    mse = float(np.mean(err**2))
    mae = float(np.mean(np.abs(err)))
    ss_res = float(np.sum(err**2))
    ss_tot = float(np.sum((targets - targets.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    if preds.std() > 0 and targets.std() > 0:
        pearson = float(np.corrcoef(preds, targets)[0, 1])
    else:
        pearson = 0.0
    return {"mse": mse, "mae": mae, "r2": r2, "pearson": pearson}
