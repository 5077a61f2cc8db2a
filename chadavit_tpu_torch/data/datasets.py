"""Dataset zoo: CSV-manifest microscopy datasets (reference
``src/data/custom_datasets.py`` — 12 near-identical Dataset classes, here one
manifest engine + declarative metadata per dataset).

The port's copy of ``chadavit_tpu/data/datasets.py``: the same classes and
disk formats, decoded by the port's native C++ decoder
(:mod:`chadavit_tpu_torch.data.native`) where it builds, else with PIL/cv2.
Each dataset has
``get(index, rng)``, which hands ``rng`` to the transform; the pretrain
loader calls it with a generator of the sample's own, and ``dataset[index]``
is ``get(index, None)`` (the transform's own generator).

Manifest format (reference ``IDRCell100K._collect_files``, ``custom_datasets.py:195-215``):
``{root_dir}/train.csv`` / ``test.csv`` rows are either
``image_id, "['ch1.png', 'ch2.png', ...]"`` (unlabeled) or
``image_id, target, "['ch1.png', ...]"`` (labeled / regression). Each channel
path is a single-channel image; channels stack into an HWC float32 array
(reference ``custom_datasets.py:166-190``).

Extras preserved:
- low-data-regime ``sample_ratio`` with cached file lists
  (``train_{Name}_{ratio}.txt``, reference ``custom_datasets.py:532-559``);
- ``dataset_with_index`` wrapper (reference ``pretrain_dataloader.py:52-67``);
- per-dataset class metadata (``int_to_labels`` etc.) as class attributes.
"""

from __future__ import annotations

import ast
import csv
import os
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from chadavit_tpu_torch.data.synthetic import SyntheticStructured  # noqa: F401


def _imread(path: str) -> np.ndarray:
    """Decode one single-channel image file in its NATIVE dtype (uint8/uint16
    raw pixel values): PNG/JPEG/TIFF through the native C++ decoder where it
    builds, else PIL/cv2 (the reference uses tifffile/cv2 for 16-bit TIFF,
    ``misc.py:465-478``); .npy raw. A float TIFF, which has no raw integer
    form, goes to cv2/PIL; a file whose codec the native build lacks raises."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path)
    if ext in (".png", ".jpg", ".jpeg", ".tif", ".tiff"):
        from chadavit_tpu_torch.data import native

        if native.is_available():
            try:
                return native.decode_plane_raw(path)
            except native.MissingCodecError:
                raise
            except RuntimeError:
                pass  # fall back below (a float TIFF)
    if ext in (".tif", ".tiff"):
        try:
            import cv2

            img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if img is not None:
                return img
        except Exception:
            pass
    from PIL import Image

    return np.array(Image.open(path))


def _dtype_scale(dt: np.dtype) -> float:
    """Divisor mapping raw pixel values to [0,1] (float inputs assumed scaled)."""
    if dt == np.uint8:
        return 255.0
    if dt == np.uint16:
        return 65535.0
    if np.issubdtype(dt, np.integer):
        return float(np.iinfo(dt).max)
    return 1.0


def load_channel_stack(paths: List[str], raw: bool = False) -> np.ndarray:
    """Stack N single-channel files into HWC (reference
    ``custom_datasets.py:166-190``).

    Default: float32 normalized to [0,1] by each plane's dtype max. (The
    reference feeds RAW 0-255/0-65535 floats into a jitter that clamps at 1.0
    — ``custom_transforms.py:344`` — which destroys raw-range data; [0,1] is
    the consistent convention this framework uses everywhere.)
    ``raw=True`` keeps the integer planes untouched (promoting mixed depths to
    uint16) for the raw-transfer on-device-normalization path."""
    chans = []
    scales = []
    for p in paths:
        arr = _imread(p)
        if arr.ndim == 3:  # an already-multichannel file contributes all planes
            for c in range(arr.shape[2]):
                chans.append(arr[:, :, c])
                scales.append(_dtype_scale(arr.dtype))
        else:
            chans.append(arr)
            scales.append(_dtype_scale(arr.dtype))
    if raw:
        if any(c.dtype == np.uint16 for c in chans):
            chans = [c.astype(np.uint16) * (257 if c.dtype == np.uint8 else 1)
                     for c in chans]
        return np.stack(chans, axis=-1)
    return np.stack([c.astype(np.float32) / s for c, s in zip(chans, scales)],
                    axis=-1)


class CsvManifestDataset:
    """Generic CSV-manifest dataset; subclasses set metadata."""

    img_channels: int = 1
    task: str = "classification"  # or "regression" / "pretrain"
    is_multiclass: bool = True
    int_to_labels: Dict[int, str] = {}
    labeled: bool = True

    def __init__(
        self,
        root_dir: str,
        train: bool = True,
        transform: Optional[Callable] = None,
        shuffle: bool = False,
        sample_ratio: float = 1.0,
        raw: bool = False,
        subset_seed: Optional[int] = None,
    ):
        self.root_dir = root_dir
        self.train = train
        self.transform = transform
        self.sample_ratio = sample_ratio
        # raw=True: keep integer planes (uint8/uint16) for the raw-transfer
        # on-device-normalization path (device_augmentations)
        self.raw = raw
        self.file_list = self._load_manifest()

        # low-data regime with cached lists, training split only
        if train and sample_ratio is not None and sample_ratio != 1.0:
            if not 0 < sample_ratio <= 1:
                raise ValueError("sample_ratio must be in (0, 1]")
            cache = os.path.join(root_dir, f"train_{type(self).__name__}_{sample_ratio}.txt")
            if os.path.isfile(cache):
                with open(cache) as f:
                    keep = {line.strip() for line in f if line.strip()}
                self.file_list = [r for r in self.file_list if str(r[0]) in keep]
            else:
                k = int(len(self.file_list) * sample_ratio)
                # draw from a LOCAL RNG when the caller passes its seed, so the
                # subset is provably identical to tools/regen_idr10k_subset.py's
                # canonical random.Random(seed) draw regardless of what else
                # consumed the global RNG before dataset construction
                rng = random if subset_seed is None else random.Random(subset_seed)
                self.file_list = rng.sample(self.file_list, k)
                try:
                    with open(cache, "w") as f:
                        f.writelines(f"{r[0]}\n" for r in self.file_list)
                except OSError:
                    pass  # read-only data dir: subset is still used, just not cached

        if shuffle:
            random.shuffle(self.file_list)

    # -- manifest ------------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.root_dir, "train.csv" if self.train else "test.csv")

    def _image_dir(self) -> str:
        return self.root_dir

    def _load_manifest(self) -> List[Tuple]:
        rows = []
        with open(self._manifest_path()) as f:
            for row in csv.reader(f):
                if not row:
                    continue
                if self.labeled:
                    image_id, target, paths = row[0], row[1], row[2]
                else:
                    image_id, target, paths = row[0], -1, row[1]
                try:
                    paths = ast.literal_eval(paths)
                except (ValueError, SyntaxError):
                    paths = [paths]
                paths = [os.path.join(self._image_dir(), p) for p in paths]
                rows.append((image_id, target, paths))
        return rows

    # -- access --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.file_list)

    def channel_count(self, index: int) -> int:
        """Channel count from the manifest alone (no decode) — drives
        channel-count bucketing in the loader."""
        return len(self.file_list[index][2])

    def _target(self, raw) -> float:
        return float(raw) if self.task == "regression" else int(raw)

    def __getitem__(self, index: int):
        return self.get(index)

    def get(self, index: int, rng=None):
        _, target, paths = self.file_list[index]
        img = load_channel_stack(paths, raw=getattr(self, "raw", False))
        if self.transform is not None:
            img = self.transform(img, rng)
        return img, self._target(target)


# ---------------------------------------------------------------------------
# SSL pretraining sets (unlabeled; reference custom_datasets.py:153-497)
class IDRCell100K(CsvManifestDataset):
    """104k multiplexed microscopy images, 1-10 channels (README.md:51,63)."""

    labeled = False
    task = "pretrain"

    def _image_dir(self):
        return os.path.join(self.root_dir, "images")


class IDRCell100K_3Channels(IDRCell100K):
    """First-3-channels baseline variant (reference ``custom_datasets.py:223``)."""

    img_channels = 3

    def get(self, index: int, rng=None):
        _, target, paths = self.file_list[index]
        img = load_channel_stack(paths, raw=getattr(self, "raw", False))[:, :, :3]
        if self.transform is not None:
            img = self.transform(img, rng)
        return img, self._target(target)


class Bray(CsvManifestDataset):
    """Bray et al. Cell Painting compound dataset (reference ``custom_datasets.py:302``)."""

    labeled = False
    task = "pretrain"
    img_channels = 5


class BBBC021xBray(CsvManifestDataset):
    """Joint BBBC021+Bray set for the common-compound UMAP; the manifest's
    label column carries ``(dataset_idx << 10) | compound`` (reference
    ``custom_datasets.py:435``; decoded in ``main_umap.py``)."""

    img_channels = 3

    def _target(self, raw) -> int:
        return int(raw)


# ---------------------------------------------------------------------------
# classification sets
class BloodMNIST(CsvManifestDataset):
    img_channels = 3
    int_to_labels = {
        0: "basophil", 1: "eosinophil", 2: "erythroblast",
        3: "immature granulocytes(myelocytes, metamyelocytes and promyelocytes)",
        4: "lymphocyte", 5: "monocyte", 6: "neutrophil", 7: "platelet",
    }


class BBBC021(CsvManifestDataset):
    img_channels = 3
    int_to_labels = {i: f"moa_{i}" for i in range(14)}  # 14 mechanisms of action


class BBBC048(CsvManifestDataset):
    img_channels = 3
    int_to_labels = {
        0: "Anaphase", 1: "Metaphase", 2: "Prophase", 3: "Telophase",
        4: "G1", 5: "G2", 6: "S",
    }


class CyclOPS(CsvManifestDataset):
    img_channels = 2
    int_to_labels = {
        0: "ACTIN", 1: "BUDNECK", 2: "BUDTIP", 3: "CELLPERIPHERY", 4: "CYTOPLASM",
        5: "ENDOSOME", 6: "ER", 7: "GOLGI", 8: "MITOCHONDRIA", 9: "NUCLEARPERIPHERY",
        10: "NUCLEI", 11: "NUCLEOLUS", 12: "PEROXISOME", 13: "SPINDLE",
        14: "SPINDLEPOLE", 15: "VACUOLARMEMBRANE", 16: "VACUOLE",
    }


class TissueMNIST(CsvManifestDataset):
    img_channels = 1
    int_to_labels = {
        0: "Collecting Duct, Connecting Tubule", 1: "Distal Convoluted Tubule",
        2: "Glomerular endothelial cells", 3: "Interstitial endothelial cells",
        4: "Leukocytes", 5: "Podocytes", 6: "Proximal Tubule Segments",
        7: "Thick Ascending Limb",
    }


# ---------------------------------------------------------------------------
# regression sets (targets are float ratios from the manifest;
# reference custom_datasets.py:1254-1264)
class Transloc(CsvManifestDataset):
    img_channels = 3
    task = "regression"


class MTBenchReg(CsvManifestDataset):
    img_channels = 3
    task = "regression"


# ---------------------------------------------------------------------------
class ImageFolderDataset:
    """Class-per-subdirectory image dataset (the ``format: image_folder`` path
    the reference delegates to torchvision for imagenet/cifar-style data,
    reference ``classification_dataloader.py:318+``). Images decode to HWC
    float32; RGB files contribute 3 channels."""

    task = "classification"

    def __init__(self, root_dir: str, train: bool = True,
                 transform: Optional[Callable] = None, shuffle: bool = False,
                 sample_ratio: float = 1.0, split_dirs=("train", "val"),
                 subset_seed: Optional[int] = None):
        split = split_dirs[0] if train else split_dirs[1]
        base = os.path.join(root_dir, split)
        if not os.path.isdir(base):
            base = root_dir  # flat layout
        classes = sorted(d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.int_to_labels = {i: c for c, i in self.class_to_idx.items()}
        self.samples = []
        for c in classes:
            cdir = os.path.join(base, c)
            for f in sorted(os.listdir(cdir)):
                if os.path.splitext(f)[1].lower() in (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".npy"):
                    self.samples.append((os.path.join(cdir, f), self.class_to_idx[c]))
        if train and sample_ratio < 1.0:
            rng = random if subset_seed is None else random.Random(subset_seed)
            self.samples = rng.sample(self.samples, int(len(self.samples) * sample_ratio))
        if shuffle:
            random.shuffle(self.samples)
        self.transform = transform
        # reference-compatible manifest view (for NativeEvalLoader)
        self.file_list = [(p, t, [p]) for p, t in self.samples]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int):
        return self.get(index)

    def get(self, index: int, rng=None):
        path, target = self.samples[index]
        # PIL here (not the native single-plane decoder): RGB files must keep
        # all three channels for the RGB/one_channel baselines
        if os.path.splitext(path)[1].lower() == ".npy":
            arr = np.load(path)
        else:
            from PIL import Image

            arr = np.array(Image.open(path))
        if arr.ndim == 2:
            arr = arr[:, :, None]
        img = arr.astype(np.float32)
        if self.transform is not None:
            img = self.transform(img, rng)
        return img, int(target)


class H5Dataset:
    """HDF5-backed dataset supporting BOTH layouts:

    - the reference layout (``custom_datasets.py:39-152``): one group per
      class, each member an ENCODED image (PNG/JPEG bytes); class index =
      position in the sorted class-name list, labels derived from groups;
    - a dense layout: ``images`` (N, H, W[, C]) + optional ``labels`` arrays.

    Files are opened lazily per worker (h5py handles are not fork/thread
    safe across loader workers, as in the reference)."""

    def __init__(self, h5_path: str, transform: Optional[Callable] = None):
        import h5py

        self.h5_path = h5_path
        self.transform = transform
        self._h5: Optional[object] = None
        with h5py.File(h5_path, "r") as f:
            if "images" in f:
                self.layout = "dense"
                self._len = len(f["images"])
                self.has_labels = "labels" in f
            else:
                self.layout = "grouped"
                self.classes = sorted(f.keys())
                self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
                self._data = [(c, name, self.class_to_idx[c])
                              for c in self.classes for name in sorted(f[c].keys())]
                self._len = len(self._data)
                self.has_labels = True

    def __len__(self):
        return self._len

    def __getitem__(self, index: int):
        return self.get(index)

    def get(self, index: int, rng=None):
        import h5py

        if self._h5 is None:  # open lazily per worker
            self._h5 = h5py.File(self.h5_path, "r")
        if self.layout == "dense":
            img = np.asarray(self._h5["images"][index], np.float32)
            label = int(self._h5["labels"][index]) if self.has_labels else -1
        else:
            import io

            from PIL import Image

            cls, name, label = self._data[index]
            raw = np.asarray(self._h5[cls][name])
            img = np.asarray(Image.open(io.BytesIO(raw.tobytes())).convert("RGB"),
                             np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        if self.transform is not None:
            img = self.transform(img, rng)
        return img, label


class SyntheticChannels:
    """Random mixed-channel dataset for tests and benchmarks. ``dtype=uint8``
    mimics raw 8-bit microscopy planes (values 0..255)."""

    task = "pretrain"
    # default label space; the config parser reads this so the two can't drift
    NUM_CLASSES = 7

    def __init__(self, n: int = 256, img_size: int = 224, min_channels: int = 1,
                 max_channels: int = 10, num_classes: int = NUM_CLASSES,
                 transform: Optional[Callable] = None, seed: int = 0,
                 dtype=np.float32):
        self.n, self.img_size = n, img_size
        self.min_channels, self.max_channels = min_channels, max_channels
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed
        self.dtype = np.dtype(dtype)

    def __len__(self):
        return self.n

    def channel_count(self, index: int) -> int:
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        return int(rng.integers(self.min_channels, self.max_channels + 1))

    def __getitem__(self, index: int):
        return self.get(index)

    def get(self, index: int, aug_rng=None):
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        c = int(rng.integers(self.min_channels, self.max_channels + 1))
        if self.dtype == np.uint8:
            img = rng.integers(0, 256, (self.img_size, self.img_size, c)).astype(np.uint8)
        else:
            img = rng.random((self.img_size, self.img_size, c), dtype=np.float32)
        label = int(rng.integers(0, self.num_classes))
        if self.transform is not None:
            img = self.transform(img, aug_rng)
        return img, label


DATASETS = {
    # generic image-folder datasets (torchvision-style class subdirs)
    "imagenet": ImageFolderDataset,
    "imagenet100": ImageFolderDataset,
    "cifar10": ImageFolderDataset,
    "cifar100": ImageFolderDataset,
    "stl10": ImageFolderDataset,
    "custom": ImageFolderDataset,
    "idrcell100k": IDRCell100K,
    "idrcell100k_3channels": IDRCell100K_3Channels,
    "bray": Bray,
    "bbbc021xbray": BBBC021xBray,
    "bloodmnist": BloodMNIST,
    "bbbc021": BBBC021,
    "bbbc048": BBBC048,
    "cyclops": CyclOPS,
    "tissuemnist": TissueMNIST,
    "mtbenchreg": MTBenchReg,
    "transloc": Transloc,
    "synthetic": SyntheticChannels,
    "synthetic_structured": SyntheticStructured,
}


class DatasetWithIndex:
    """Yields (index, *sample) (reference ``pretrain_dataloader.py:52-67``)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def channel_count(self, index: int) -> int:
        return self.dataset.channel_count(index)

    def __getitem__(self, index: int):
        return self.get(index)

    def get(self, index: int, rng=None):
        out = self.dataset.get(index, rng)
        return (index, *out) if isinstance(out, tuple) else (index, out)


def dataset_with_index(dataset_class):
    def make(*args, **kwargs):
        return DatasetWithIndex(dataset_class(*args, **kwargs))

    return make


def prepare_datasets(dataset: str, transform: Optional[Callable] = None,
                     train_path: Optional[str] = None, with_index: bool = False,
                     train: bool = True, sample_ratio: float = 1.0,
                     subset_seed: Optional[int] = None, **kwargs):
    """Dataset dispatch (reference ``pretrain_dataloader.py:403-498``).

    ``subset_seed``: seed for the low-data ``sample_ratio`` subset draw
    (local RNG, independent of global-RNG history); None keeps the legacy
    global-``random`` draw."""
    cls = DATASETS[dataset]
    if dataset in ("synthetic", "synthetic_structured"):
        if dataset == "synthetic_structured":
            kwargs.setdefault("train", train)
        ds = cls(transform=transform, **kwargs)
    else:
        ds = cls(root_dir=train_path, train=train, transform=transform,
                 sample_ratio=sample_ratio, subset_seed=subset_seed, **kwargs)
    return DatasetWithIndex(ds) if with_index else ds
