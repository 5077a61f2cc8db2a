"""Attention maps of one image (reference ``main_attn.py``).

The port's counterpart of the repository's root ``main_attn.py``, with the
same command line plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions):

    python -m chadavit_tpu_torch.main_attn --config-path scripts/smoke \\
        --config-name knn_synthetic image_path=cell.png threshold=0.6 [--device cpu]

It loads one image (the mean of its colour planes where it has several),
resizes it to ``image_size`` (cv2, bilinear), crops it to a multiple of
``patch_size``, and runs the backbone's ``get_last_selfattention`` on it as
one channel (reference ``chada_vit.py:313-320``): every layer but the last
through the model's route, the last returning its weights through the plain
masked attention. It writes into ``output_dir``: the normalised input
(``img.png``), each head's CLS-to-patch map upsampled by ``patch_size``
(``attn-head{j}.png``) and their mean (``attn-mean.png``), and with
``threshold`` each head's top-mass mask over the input with its contour
(``mask_th{t}_head{j}.png``, reference ``main_attn.py:207-265``).
"""

import os

import numpy as np
import torch

from chadavit_tpu_torch.cli import load_backbone_for_eval, load_cfg, parse_args
from chadavit_tpu_torch.config import parse_attn_cfg
from chadavit_tpu_torch.utils.misc import resolve_device


def _save_map(arr: np.ndarray, path: str):
    a = arr - arr.min()
    if a.max() > 0:
        a = a / a.max()
    img = (a * 255).astype(np.uint8)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(path, img, cmap="inferno")
    except Exception:
        from PIL import Image

        Image.fromarray(img).save(path)


def threshold_mask(m: np.ndarray, threshold: float) -> np.ndarray:
    """Binary mask of the patches holding the top ``threshold`` of the
    attention mass (reference ``main_attn.py:210-226``: ascending sort,
    cumulative sum, keep the tail)."""
    flat = m.ravel()
    order = np.argsort(flat)
    val = flat[order] / max(flat.sum(), 1e-12)
    keep_sorted = np.cumsum(val) > (1.0 - threshold)
    keep = np.empty_like(keep_sorted)
    keep[order] = keep_sorted
    return keep.reshape(m.shape).astype(np.float32)


def _save_overlay(img01: np.ndarray, mask: np.ndarray, path: str,
                  color=(1.0, 0.35, 0.1), alpha: float = 0.5):
    """The input with a translucent coloured mask and its 1-pixel contour
    (reference ``display_instances``, ``main_attn.py:50-90``)."""
    from PIL import Image

    rgb = np.repeat(img01[:, :, None], 3, axis=2)
    m = mask > 0.5
    for c in range(3):
        ch = rgb[:, :, c]
        ch[m] = ch[m] * (1 - alpha) + alpha * color[c]
    interior = np.zeros_like(m)  # the contour: the mask less its erosion
    interior[1:-1, 1:-1] = (m[1:-1, 1:-1] & m[:-2, 1:-1] & m[2:, 1:-1]
                            & m[1:-1, :-2] & m[1:-1, 2:])
    edge = m & ~interior
    for c in range(3):
        rgb[:, :, c][edge] = color[c]
    Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(path)


def load_image(path: str, size: int, patch: int) -> np.ndarray:
    """The image as one float32 plane: colour planes averaged, resized to
    ``size`` (cv2 bilinear; 0 keeps its size), cropped to a multiple of
    ``patch``."""
    from PIL import Image

    img = np.asarray(Image.open(path), np.float32)
    if img.ndim == 3:
        img = img.mean(-1)
    if size and img.shape != (size, size):
        import cv2

        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    return img[:img.shape[0] - img.shape[0] % patch, :img.shape[1] - img.shape[1] % patch]


def run_attn(cfg, device=None) -> dict:
    """The maps of a parsed config on ``device`` (``None`` means cuda).
    Returns ``{"attention" (1, heads, S, S), "maps" (heads, H, W) upsampled,
    "masks" (heads, H, W) or None, "files", "model"}``."""
    dev = resolve_device(device)
    model = load_backbone_for_eval(cfg, dev)
    patch = cfg.get("patch_size", 16)
    img = load_image(cfg.image_path, int(cfg.get("image_size", 224) or 0), patch)
    h, w = img.shape
    x = torch.from_numpy(np.ascontiguousarray(img))[None, None].to(dev)
    with torch.inference_mode():
        attn = model.get_last_selfattention(x).float().cpu().numpy()  # (1, heads, S, S)
    nh = attn.shape[1]
    cls_attn = attn[0, :, 0, 1:].reshape(nh, h // patch, w // patch)  # CLS -> patches

    out_dir = cfg.get("output_dir", "attn_maps")
    os.makedirs(out_dir, exist_ok=True)
    files = []

    def out(name):
        files.append(os.path.join(out_dir, name))
        return files[-1]

    # the normalised input (the reference saves make_grid(img, normalize=True))
    from PIL import Image

    img01 = img - img.min()
    if img01.max() > 0:
        img01 = img01 / img01.max()
    Image.fromarray((img01 * 255).astype(np.uint8)).save(out("img.png"))
    # the raw maps and their mean (the reference thresholds only the masks,
    # main_attn.py:232-249)
    maps = np.stack([np.kron(cls_attn[j], np.ones((patch, patch))) for j in range(nh)])
    for j in range(nh):
        _save_map(maps[j], out(f"attn-head{j}.png"))
    _save_map(maps.mean(0), out("attn-mean.png"))
    threshold = cfg.get("threshold")
    masks = None
    if threshold:
        masks = np.stack([np.kron(threshold_mask(cls_attn[j], float(threshold)),
                                  np.ones((patch, patch))) for j in range(nh)])
        for j in range(nh):
            _save_overlay(img01, masks[j], out(f"mask_th{threshold}_head{j}.png"))
        print(f"saved {nh} head maps + mean + {nh} masked overlays to {out_dir}/")
    else:
        print(f"saved {nh} head maps + mean to {out_dir}/")
    return {"attention": attn, "maps": maps, "masks": masks, "files": files, "model": model}


def main(argv=None):
    args = parse_args(argv, description=__doc__)
    return run_attn(parse_attn_cfg(load_cfg(args)), device=args.device)


if __name__ == "__main__":
    main()
