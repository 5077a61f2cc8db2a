"""2-D projections of features and their plots (reference
``src/utils/auto_umap.py``).

Counterpart of ``chadavit_tpu/utils/auto_umap.py`` (``project_2d`` :25,
``plot_scatter`` :38, ``plot_common_compounds`` :64, ``AutoUMAP`` :101):

- :func:`project_2d` takes umap-learn where it imports, as JAX does. Where
  JAX falls back to sklearn's ``TSNE``, the port runs its own t-SNE in torch
  on the given device (:func:`tsne`), with sklearn's defaults: P over the
  nearest neighbours by squared Euclidean distance with the per-row binary
  search for the perplexity, PCA initialisation, early exaggeration 12 for
  250 iterations at momentum 0.5, then 0.8, the gains and the stopping rules
  of sklearn's ``_gradient_descent``. The repulsive term is exact, summed in
  row chunks (memory O(n * chunk)), where sklearn's default takes
  Barnes-Hut's approximation of it.
- :func:`trustworthiness` is sklearn's ``manifold.trustworthiness`` for the
  Euclidean metric, so that a machine without sklearn can score an
  embedding.
- The plots need matplotlib; without it they return False and write
  nothing.
- :class:`AutoUMAP` is the training-time hook: ``umap_ep={N}.png`` of the
  validation features every ``frequency`` validation epochs.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from chadavit_tpu_torch.utils.misc import resolve_device

MACHINE_EPSILON = float(np.finfo(np.float64).eps)
PERPLEXITY_TOLERANCE = float(np.float32(1e-5))  # sklearn manifold/_utils.pyx
EPSILON_DBL = float(np.float32(1e-8))
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERS = 250
MAX_ITERS = 1000
N_ITER_CHECK = 50
N_ITER_WITHOUT_PROGRESS = 300
MIN_GRAD_NORM = 1e-7
MIN_GAIN = 0.01
CHUNK_ENTRIES = 1 << 22  # pairs a chunk of rows holds


def perplexity_for(n: int) -> int:
    """JAX ``project_2d``'s perplexity for ``n`` points."""
    return max(2, min(30, n // 4))


def _row_chunk(n: int) -> int:
    return max(1, min(n, CHUNK_ENTRIES // max(n, 1)))


def knn_sq_distances(x: torch.Tensor, k: int):
    """``(squared distances (n, k) ascending, indices (n, k))`` of each
    row's ``k`` nearest other rows, in float64."""
    x = x.double()
    sq = (x * x).sum(1)
    n = x.shape[0]
    dists, idx = [], []
    step = _row_chunk(n)
    for s in range(0, n, step):
        d2 = (sq[s:s + step, None] - 2 * x[s:s + step] @ x.T + sq[None, :]).clamp_(min=0)
        d2[torch.arange(d2.shape[0]), torch.arange(s, s + d2.shape[0])] = float("inf")
        d, i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        dists.append(d)
        idx.append(i)
    return torch.cat(dists), torch.cat(idx)


def conditional_p(sq_dists: torch.Tensor, perplexity: float) -> torch.Tensor:
    """P(j | i) over each row's neighbours (sklearn
    ``_binary_search_perplexity``): the precision of each row's Gaussian by
    at most 100 halvings or doublings until the entropy is within 1e-5 of
    log(perplexity). The distances are read as float32, as sklearn does."""
    d = sq_dists.float().double()
    n = d.shape[0]
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -float("inf"))
    hi = torch.full_like(beta, float("inf"))
    done = torch.zeros(n, dtype=torch.bool, device=d.device)
    want = float(np.log(np.float32(perplexity)))
    p = torch.zeros_like(d)
    for _ in range(100):
        pc = torch.exp(-d * beta[:, None])
        s = pc.sum(1)
        s = torch.where(s == 0, torch.full_like(s, EPSILON_DBL), s)
        pc = pc / s[:, None]
        diff = torch.log(s) + beta * (d * pc).sum(1) - want
        p = torch.where(done[:, None], p, pc)
        done = done | (diff.abs() <= PERPLEXITY_TOLERANCE)
        up, down = (diff > 0) & ~done, (diff <= 0) & ~done
        inf_hi, inf_lo = torch.isinf(hi), torch.isinf(lo)
        new_up = torch.where(inf_hi, beta * 2, (beta + hi) / 2)
        new_down = torch.where(inf_lo, beta / 2, (beta + lo) / 2)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(up, new_up, torch.where(down, new_down, beta))
        if bool(done.all()):
            break
    return p


def joint_probabilities_nn(x: torch.Tensor, perplexity: float):
    """The joint P of sklearn ``_joint_probabilities_nn`` over the
    ``min(n - 1, int(3 * perplexity + 1))`` nearest neighbours of each row:
    ``(P + P^T) / sum``, as ``(indices (2, nnz), values float64)``."""
    n = x.shape[0]
    k = min(n - 1, int(3.0 * perplexity + 1))
    d, idx = knn_sq_distances(x, k)
    cond = conditional_p(d, perplexity)
    rows = torch.arange(n, device=x.device).repeat_interleave(k)
    cols = idx.reshape(-1)
    # P + P^T: entries of one (i, j) pair summed
    keys, at = torch.unique(torch.cat([rows * n + cols, cols * n + rows]), return_inverse=True)
    vals = torch.zeros(keys.shape, dtype=cond.dtype, device=x.device).index_add_(
        0, at, torch.cat([cond.reshape(-1)] * 2))
    return torch.stack([keys // n, keys % n]), vals / max(float(vals.sum()), MACHINE_EPSILON)


def kl_divergence(y: torch.Tensor, p_idx: torch.Tensor, p_val: torch.Tensor,
                  compute_error: bool = True):
    """``(KL(P || Q), dKL/dy)`` of the embedding ``y`` (n, 2) under the
    Student-t Q of one degree of freedom (sklearn ``_kl_divergence``), with
    Q over every pair, in row chunks; P sparse. The KL is NaN unless
    ``compute_error``; the gradient has y's dtype."""
    yd = y.double()
    n = yd.shape[0]
    step = _row_chunk(n)

    def kernel(s):  # 1 / (1 + |y_i - y_j|^2) of rows s.., 0 on the diagonal
        w = 1.0 / (1.0 + ((yd[s:s + step, None, :] - yd[None, :, :]) ** 2).sum(-1))
        w[torch.arange(w.shape[0]), torch.arange(s, s + w.shape[0])] = 0.0
        return w

    whole = kernel(0) if step >= n else None  # one chunk holds every row
    z = whole.sum() if whole is not None else sum(kernel(s).sum() for s in range(0, n, step))
    grad = torch.zeros_like(yd)
    for s in range(0, n, step):
        w = whole if whole is not None else kernel(s)
        qw = torch.clamp(w / z, min=MACHINE_EPSILON) * w  # 0 on the diagonal, as w
        grad[s:s + step] -= yd[s:s + step] * qw.sum(1, keepdim=True) - qw @ yd
    i, j = p_idx
    diff = yd[i] - yd[j]
    w_ij = 1.0 / (1.0 + (diff * diff).sum(1))
    grad.index_add_(0, i, (p_val * w_ij)[:, None] * diff)
    kl = float("nan")
    if compute_error:
        q_ij = torch.clamp(w_ij / z, min=MACHINE_EPSILON)
        kl = float((p_val * torch.log(torch.clamp(p_val, min=MACHINE_EPSILON) / q_ij)).sum())
    return kl, (4.0 * grad).to(y.dtype)


def _gradient_descent(p_idx, p_val, y, it: int, max_iter: int, momentum: float,
                      learning_rate: float, n_iter_without_progress: int):
    """sklearn ``_gradient_descent`` with its gains, checks and stops;
    returns ``(y, KL, last iteration)``."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        error, grad = kl_divergence(y, p_idx, p_val, compute_error=check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_(min=MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y = y + update
        if check:
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if float(torch.linalg.vector_norm(grad)) <= MIN_GRAD_NORM:
                break
    return y, error, i


def pca_init(x: torch.Tensor) -> torch.Tensor:
    """sklearn's PCA start: the first two principal components (signs as
    ``svd_flip(u_based_decision=False)``), scaled so the first has standard
    deviation 1e-4; float32."""
    xc = x.double() - x.double().mean(0)
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    vt = vt[:2]
    signs = torch.sign(vt[torch.arange(2), vt.abs().argmax(1)])
    emb = (xc @ (vt * signs[:, None]).T).float()
    return emb / emb[:, 0].std(unbiased=False) * 1e-4


def tsne(features, device=None) -> np.ndarray:
    """t-SNE of ``features`` (n, F) to (n, 2) on ``device`` (``None`` means
    the card), as sklearn's ``TSNE(n_components=2, init="pca",
    learning_rate="auto", perplexity=perplexity_for(n))`` runs it, with the
    exact repulsive term."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(features, np.float32)).to(dev)
    n = x.shape[0]
    p_idx, p_val = joint_probabilities_nn(x, perplexity_for(n))
    y = pca_init(x)
    lr = max(n / EARLY_EXAGGERATION / 4, 50.0)
    y, _, it = _gradient_descent(p_idx, p_val * EARLY_EXAGGERATION, y, 0, EXPLORATION_ITERS,
                                 0.5, lr, EXPLORATION_ITERS)
    y, _, _ = _gradient_descent(p_idx, p_val, y, it + 1, MAX_ITERS, 0.8, lr,
                                N_ITER_WITHOUT_PROGRESS)
    return y.cpu().numpy()


def trustworthiness(x, emb, n_neighbors: int = 5) -> float:
    """sklearn ``manifold.trustworthiness`` with the Euclidean metric: 1
    less the penalised ranks, in ``x``, of each point's ``n_neighbors``
    nearest neighbours in ``emb`` that are not among its nearest in ``x``."""
    x = np.asarray(x, np.float64)
    emb = np.asarray(emb, np.float64)
    n = len(x)
    if n_neighbors >= n / 2:
        raise ValueError(f"n_neighbors ({n_neighbors}) should be less than n_samples / 2 "
                         f"({n / 2})")

    def order(a):
        sq = (a * a).sum(1)
        d = np.maximum(sq[:, None] - 2 * a @ a.T + sq[None, :], 0)
        np.fill_diagonal(d, np.inf)
        return np.argsort(d, axis=1, kind="stable")

    ind_x = order(x)
    ind_e = order(emb)[:, :n_neighbors]
    inverted = np.zeros((n, n), dtype=np.int64)
    inverted[np.arange(n)[:, None], ind_x] = np.arange(1, n + 1)
    ranks = inverted[np.arange(n)[:, None], ind_e] - n_neighbors
    t = np.sum(ranks[ranks > 0])
    return float(1.0 - t * (2.0 / (n * n_neighbors * (2.0 * n - 3.0 * n_neighbors - 1.0))))


def project_2d(features, seed: int = 5, device=None) -> np.ndarray:
    """(n, 2) embedding: umap-learn's where it imports, else :func:`tsne`
    on ``device`` (``None`` means the card)."""
    try:
        import umap
    except ImportError:
        return tsne(features, device=device)
    return umap.UMAP(n_components=2, random_state=seed).fit_transform(features)


def _pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    return plt


def plot_scatter(emb: np.ndarray, labels: np.ndarray, path_base: str,
                 label_names=None, save_pdf: bool = True) -> bool:
    """Class-coloured scatter as ``path_base.png`` (and ``.pdf``); False
    where matplotlib is missing."""
    plt = _pyplot()
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(8, 8))
    classes = np.unique(labels)
    cmap = plt.get_cmap("tab20")
    for i, c in enumerate(classes):
        m = labels == c
        name = label_names.get(int(c), str(c)) if label_names else str(c)
        ax.scatter(emb[m, 0], emb[m, 1], s=4, color=cmap(i % 20), label=name)
    if len(classes) <= 25:
        ax.legend(markerscale=3, fontsize=7)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(path_base + ".png", dpi=200)
    if save_pdf:
        fig.savefig(path_base + ".pdf")
    plt.close(fig)
    return True


def plot_common_compounds(emb: np.ndarray, dataset_idx: np.ndarray,
                          compound_idx: np.ndarray, path_base: str) -> bool:
    """Dual-dataset overlay as ``path_base.png``: only the compounds present
    in both datasets coloured, the rest light gray (reference
    ``plot_multi_labels``); False where matplotlib is missing."""
    plt = _pyplot()
    if plt is None:
        return False
    datasets = np.unique(dataset_idx)
    common = compound_idx
    if len(datasets) >= 2:
        common = np.intersect1d(compound_idx[dataset_idx == datasets[0]],
                                compound_idx[dataset_idx == datasets[1]])
    cmap = plt.get_cmap("hsv")
    colors = {int(c): cmap(i / max(len(common), 1)) for i, c in enumerate(np.unique(common))}

    fig, ax = plt.subplots(figsize=(10, 10))
    markers = ["o", "s", "D", "^", "v"]
    for i, ds in enumerate(datasets):
        m = dataset_idx == ds
        cs = [colors.get(int(c), (0.83, 0.83, 0.83, 0.5)) for c in compound_idx[m]]
        ax.scatter(emb[m, 0], emb[m, 1], s=24, c=cs, marker=markers[i % len(markers)],
                   alpha=0.6, linewidths=0)
    handles = [plt.Line2D([0], [0], marker="o", color="w", label=f"compound {c}",
                          markerfacecolor=col, markersize=8)
               for c, col in colors.items()]
    if handles and len(handles) <= 30:
        ax.legend(handles=handles, title="common compounds", fontsize=7)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(path_base + ".png", dpi=200)
    plt.close(fig)
    return True


class AutoUMAP:
    """Training-time hook: call :meth:`maybe_plot` at each validation epoch;
    it writes ``umap_ep={N}.png`` into ``out_dir`` every ``frequency``
    epochs (the reference's naming), projecting on ``device``."""

    def __init__(self, out_dir: str, frequency: int = 1, device=None):
        self.out_dir = out_dir
        self.frequency = max(1, int(frequency))
        self.device = device
        os.makedirs(out_dir, exist_ok=True)

    def maybe_plot(self, epoch: int, feats: np.ndarray, targets: np.ndarray,
                   seed: int = 5) -> Optional[str]:
        """The PNG's path, or None where nothing was written (not this
        epoch, under 8 points, or no matplotlib)."""
        if epoch % self.frequency != 0 or len(feats) < 8:
            return None
        emb = project_2d(feats, seed=seed, device=self.device)
        base = os.path.join(self.out_dir, f"umap_ep={epoch}")
        if plot_scatter(emb, targets, base, save_pdf=False):
            return base + ".png"
        print(f"auto-umap: {base}.png not written: matplotlib is not installed")
        return None
