"""Write an on-disk IDRCell100k-shaped microscopy dataset: per-channel
single-plane PNG files and a CSV manifest.

The port's copy of ``tools/generate_disk_dataset.py``. The reference trains
from per-channel files listed in a CSV manifest (reference
``custom_datasets.py:166-215``: an image id and a Python-list string of
channel file paths; IDRCell100K keeps its images under ``{root}/images``).
This writes that layout with :func:`render_structured_image`'s content
(blobs, band-limited texture, shot noise, so that the PNGs compress and
decode at realistic rates). With ``num_classes`` each image gets a class
(a texture signature shared by its channels) and the manifest takes the
labeled layout ``(id, target, paths)`` of the classification sets.

The PNGs are written by :func:`write_png` with the standard library's zlib
(8- or 16-bit grayscale, one filter byte a row), so no imaging package is
needed. Usage:

    python -m chadavit_tpu_torch.data.disk_dataset --out DIR --n 8000 [--classes 7] [--flat]
"""

from __future__ import annotations

import argparse
import csv
import multiprocessing as mp
import os
import struct
import time
import zlib

import numpy as np

from chadavit_tpu_torch.data.synthetic import render_structured_image


def write_png(path: str, plane: np.ndarray, level: int = 1) -> None:
    """One grayscale PNG of a (H, W) uint8 or uint16 plane (big-endian
    16-bit samples, filter type 0 on every row, zlib ``level``)."""
    if plane.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16 planes, not {plane.dtype}")
    h, w = plane.shape
    depth = 8 * plane.dtype.itemsize
    rows = np.ascontiguousarray(plane.astype(plane.dtype.newbyteorder(">")))
    raw = np.zeros((h, 1 + w * plane.dtype.itemsize), np.uint8)
    raw[:, 1:] = rows.view(np.uint8).reshape(h, -1)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        body = tag + payload
        return struct.pack(">I", len(payload)) + body + struct.pack(">I", zlib.crc32(body))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def _make_one(task):
    idx, seed, img_size, min_c, max_c, depth, num_classes, img_dir = task
    rng = np.random.default_rng(seed)
    c = int(rng.integers(min_c, max_c + 1))
    label = int(rng.integers(0, num_classes)) if num_classes else -1
    img = render_structured_image(seed + 1, img_size, c, depth, max(label, 0), num_classes)
    names = []
    for ci in range(c):
        name = f"img{idx:06d}_c{ci}.png"
        write_png(os.path.join(img_dir, name), img[:, :, ci])
        names.append(name)
    return idx, label, names


def generate(out_dir: str, n: int, img_size: int = 224, min_channels: int = 1,
             max_channels: int = 10, depth: int = 8, num_classes: int = 0,
             val_fraction: float = 0.0, seed: int = 0, workers: int = 4,
             image_subdir: str = "images") -> str:
    """Write ``n`` images into ``out_dir`` (``train.csv``, and ``test.csv``
    for the last ``val_fraction``); the same seed writes the same bytes.
    ``image_subdir=""`` puts the planes beside the manifest (the
    classification sets' layout), else under it (IDRCell100K's)."""
    img_dir = os.path.join(out_dir, image_subdir) if image_subdir else out_dir
    os.makedirs(img_dir, exist_ok=True)
    tasks = [(i, seed * 1_000_003 + i, img_size, min_channels, max_channels, depth,
              num_classes, img_dir) for i in range(n)]
    t0 = time.time()
    if workers > 1:
        with mp.get_context("spawn").Pool(workers) as pool:
            rows = pool.map(_make_one, tasks, chunksize=16)
    else:
        rows = [_make_one(t) for t in tasks]
    rows.sort()
    n_val = int(n * val_fraction)
    splits = {"train.csv": rows[: n - n_val]}
    if n_val:
        splits["test.csv"] = rows[n - n_val:]
    for fname, rs in splits.items():
        with open(os.path.join(out_dir, fname), "w", newline="") as f:
            wr = csv.writer(f)
            for idx, label, names in rs:
                if num_classes:
                    wr.writerow([f"img{idx:06d}", label, repr(names)])
                else:
                    wr.writerow([f"img{idx:06d}", repr(names)])
    dt = time.time() - t0
    n_planes = sum(len(r[2]) for r in rows)
    print(f"wrote {n} images / {n_planes} planes to {out_dir} in {dt:.1f}s "
          f"({n_planes / dt:.0f} planes/s)")
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--img-size", type=int, default=224)
    ap.add_argument("--min-channels", type=int, default=1)
    ap.add_argument("--max-channels", type=int, default=10)
    ap.add_argument("--depth", type=int, default=8, choices=(8, 16))
    ap.add_argument("--classes", type=int, default=0,
                    help="0 = unlabeled pretrain manifest; K>0 = labeled")
    ap.add_argument("--val-fraction", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--flat", action="store_true",
                    help="images next to the manifest (classification layout) "
                         "instead of under images/ (IDRCell100K layout)")
    a = ap.parse_args(argv)
    generate(a.out, a.n, a.img_size, a.min_channels, a.max_channels, a.depth, a.classes,
             a.val_fraction, a.seed, a.workers, image_subdir="" if a.flat else "images")


if __name__ == "__main__":
    main()
