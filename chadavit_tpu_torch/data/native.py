"""ctypes binding for the port's native C++ decoder
(``chadavit_tpu_torch/native/chadaloader.cpp``).

Counterpart of ``chadavit_tpu/data/native.py`` (``decode_plane`` :116,
``decode_plane_raw`` :134, ``load_dense_batch`` :155,
``load_dense_batch_raw`` :182, ``DecodedPlaneCache`` :223,
``make_dense_batch_fn`` :257, ``NativeEvalLoader`` :307). The library is
built with ``g++`` at first use, never at import, into
``chadavit_tpu_torch/_build/native-<hash>/`` (git-ignored), keyed by a hash
of the source, the flags and the codecs found.

Each codec is compiled in only where its header is found: inflate from
libdeflate or else zlib (the grayscale 8/16-bit PNG planes that microscopy
datasets hold), libpng for every other PNG, libjpeg, libtiff. A file whose
codec was not built raises an error that names the missing header; it is
never decoded another way. Where the library cannot be built at all,
:func:`is_available` is false and callers use the PIL path, as in JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "chadaloader.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
# (name, header, macro, link flag, bit in chada_codecs); inflate is libdeflate
# where found, else zlib: one of the two
CODECS = (
    ("deflate", "libdeflate.h", "CHADA_HAVE_DEFLATE", "-ldeflate", 1),
    ("zlib", "zlib.h", "CHADA_HAVE_ZLIB", "-lz", 1),
    ("png", "png.h", "CHADA_HAVE_PNG", "-lpng", 2),
    ("jpeg", "jpeglib.h", "CHADA_HAVE_JPEG", "-ljpeg", 4),
    ("tiff", "tiffio.h", "CHADA_HAVE_TIFF", "-ltiff", 8),
)
# each bit of chada_codecs: its name, and what a file of it needs built
_BITS = {1: ("png-gray", "grayscale PNG: libdeflate.h or zlib.h"),
         2: ("png", "this PNG: png.h"), 4: ("jpeg", "JPEG: jpeglib.h"),
         8: ("tiff", "TIFF: tiffio.h")}


class MissingCodecError(RuntimeError):
    """A file whose codec the library was built without (its header was not
    found): it is not decoded another way."""


_lock = threading.Lock()
_loaded: dict = {}  # frozenset(without) -> (lib or None, error or None)


def _has_header(header: str) -> bool:
    try:
        proc = subprocess.run(["g++", "-xc++", "-E", "-o", os.devnull, "-"],
                              input=f"#include <{header}>\n", capture_output=True,
                              text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def found_codecs(without: Iterable[str] = ()) -> List[str]:
    """The codecs whose headers g++ finds, less ``without``; zlib only where
    libdeflate is missing."""
    names = [name for name, header, *_ in CODECS
             if name not in without and _has_header(header)]
    if "deflate" in names and "zlib" in names:
        names.remove("zlib")
    return names


def build(without: Iterable[str] = ()) -> Path:
    """Compile the library with every codec found but those ``without``
    names, unless that build exists; returns its path. Raises with the
    compiler's output when ``g++`` fails."""
    names = found_codecs(without)
    spec = {name: (macro, lib) for name, _, macro, lib, _ in CODECS}
    flags = CXX_FLAGS + [f"-D{spec[n][0]}" for n in names]
    libs = [spec[n][1] for n in names] + ["-lpthread"]
    h = hashlib.sha256(" ".join(flags + libs).encode())
    h.update(SRC.read_bytes())
    out_dir = BUILD_DIR / f"native-{h.hexdigest()[:16]}"
    lib_path = out_dir / "libchadaloader.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libchadaloader.{os.getpid()}.{threading.get_ident()}.so"
    proc = subprocess.run(["g++", *flags, str(SRC), "-o", str(tmp), *libs],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr[-2000:]}")
    os.replace(tmp, lib_path)  # two processes that build at once load a whole library
    return lib_path


def _bind(lib) -> None:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.chada_codecs.argtypes = []
    lib.chada_codecs.restype = ctypes.c_int
    lib.chada_decode_plane.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long, c_int_p, c_int_p]
    lib.chada_decode_plane.restype = ctypes.c_int
    lib.chada_load_dense_batch_v2.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), c_int_p, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.chada_load_dense_batch_v2.restype = ctypes.c_int
    lib.chada_decode_plane_raw.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        c_int_p, c_int_p, c_int_p]
    lib.chada_decode_plane_raw.restype = ctypes.c_int
    lib.chada_load_dense_batch_raw.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), c_int_p, ctypes.c_int, ctypes.c_int]
    lib.chada_load_dense_batch_raw.restype = ctypes.c_int


def library(without: Iterable[str] = ()):
    """The loaded library (built at first use), or None where it cannot be
    built or loaded (:func:`build_error` says why)."""
    key = frozenset(without)
    with _lock:
        if key not in _loaded:
            try:
                lib = ctypes.CDLL(str(build(key)))
                _bind(lib)
                _loaded[key] = (lib, None)
            except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
                _loaded[key] = (None, str(e))
        return _loaded[key][0]


def is_available() -> bool:
    return library() is not None


def build_error() -> Optional[str]:
    library()
    return _loaded[frozenset()][1]


def codecs(lib=None) -> List[str]:
    """What the loaded library decodes."""
    lib = lib or _lib()
    bits = lib.chada_codecs()
    return [name for bit, (name, _) in _BITS.items() if bits & bit]


def describe() -> str:
    """Which decoder a loader over image files uses, and why: ``native
    (its codecs)`` or ``pil (why the native one cannot be built)``."""
    if not is_available():
        return f"pil (the native decoder cannot be built: {build_error()[:200]})"
    return "native (" + ", ".join(codecs()) + ")"


def _lib():
    lib = library()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {build_error()}")
    return lib


def _failure(rc: int, path: str, what: str = "decode") -> RuntimeError:
    if rc <= -16:
        needs = _BITS.get(-rc - 16, ("", "this file"))[1]
        return MissingCodecError(f"{path}: the native decoder was built without the codec "
                                 f"of {needs} (the header was not found)")
    return RuntimeError(f"{what} failed ({rc}): {path}")


def decode_plane(path: str, max_pixels: int = 64 * 1024 * 1024, lib=None) -> np.ndarray:
    """Decode one single-channel image file at native resolution (float32 HW)."""
    lib = lib or _lib()
    buf = np.empty(max_pixels, np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.chada_decode_plane(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                buf.size, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise _failure(rc, path)
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


def decode_plane_raw(path: str, max_pixels: int = 64 * 1024 * 1024, lib=None) -> np.ndarray:
    """Decode one plane keeping the source integer dtype (uint8 or uint16
    HW): the raw-transfer path, 1-2 bytes a pixel to the device."""
    lib = lib or _lib()
    buf = np.empty(max_pixels * 2, np.uint8)
    w, h, d = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.chada_decode_plane_raw(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                    buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(d))
    if rc != 0:
        raise _failure(rc, path, "raw decode")
    n = w.value * h.value
    if d.value == 16:
        return buf[: n * 2].view(np.uint16).reshape(h.value, w.value).copy()
    return buf[:n].reshape(h.value, w.value).copy()


def _flat_paths(channel_paths: Sequence[Sequence[str]]):
    flat: List[bytes] = []
    offsets = np.zeros(len(channel_paths) + 1, np.int64)
    for i, paths in enumerate(channel_paths):
        flat.extend(p.encode() for p in paths)
        offsets[i + 1] = len(flat)
    return (ctypes.c_char_p * len(flat))(*flat), offsets


def _raise_first_failure(failures: int, channel_paths, max_channels: int) -> None:
    """Name the first plane that fails on its own (a missing codec names its
    header); the batch call only counts them."""
    for paths in channel_paths:
        for p in paths[:max_channels]:
            try:
                decode_plane_raw(p)
            except RuntimeError as e:
                raise type(e)(f"{failures} plane(s) failed to decode; first: {e}") from None
    raise RuntimeError(f"{failures} plane(s) failed to decode")


def load_dense_batch(channel_paths: Sequence[Sequence[str]], max_channels: int, height: int,
                     width: int, num_threads: int = 8, scale: float = 1.0,
                     resize_mode: int = 0, resize_size: int = 0,
                     normalize: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Decode and resize a batch of multi-channel images into the dense
    ``(B, C_max, H, W)`` float32 layout; returns (batch, channel_counts).

    ``resize_mode``: 0 square resize to (H, W); 1 square resize to
    ``resize_size`` then centre crop; 2 shorter side to ``resize_size`` then
    centre crop. ``normalize`` divides by the source dtype's max."""
    lib = _lib()
    c_paths, offsets = _flat_paths(channel_paths)
    out = np.zeros((len(channel_paths), max_channels, height, width), np.float32)
    counts = np.zeros(len(channel_paths), np.int32)
    failures = lib.chada_load_dense_batch_v2(
        c_paths, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        len(channel_paths), max_channels, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        num_threads, scale, int(resize_mode), int(resize_size), int(normalize))
    if failures:
        _raise_first_failure(failures, channel_paths, max_channels)
    return out, counts


def load_dense_batch_raw(channel_paths: Sequence[Sequence[str]], max_channels: int,
                         height: int, width: int, num_threads: int = 4,
                         out_depth: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a batch into the dense raw integer ``(B, C_max, H, W)`` layout
    (uint8 when ``out_depth`` is 8, uint16 when 16): the pretrain transfer
    path. Planes of the target size and depth are copies of the decoder's
    bytes; others are resized bilinearly, and 8 <-> 16-bit sources rescale
    to ``out_depth``. Returns (batch, channel_counts)."""
    lib = _lib()
    c_paths, offsets = _flat_paths(channel_paths)
    dtype = np.uint16 if out_depth == 16 else np.uint8
    out = np.zeros((len(channel_paths), max_channels, height, width), dtype)
    counts = np.zeros(len(channel_paths), np.int32)
    failures = lib.chada_load_dense_batch_raw(
        c_paths, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        len(channel_paths), max_channels, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads, int(out_depth))
    if failures:
        _raise_first_failure(failures, channel_paths, max_channels)
    return out, counts


class DecodedPlaneCache:
    """Decoded raw planes kept in memory by file path, so that every epoch
    after the first decodes nothing. Bounded by ``max_bytes``: insertions
    stop at the cap, and planes already in keep serving.

    Safe under the loader's worker threads: dict get and set are atomic under
    the interpreter lock and an entry never changes once in; a lost race
    costs one decode twice, never a wrong plane."""

    def __init__(self, max_bytes: Optional[int] = None):
        self.store: dict = {}
        self.max_bytes = max_bytes
        self.bytes = 0

    def __contains__(self, path: str) -> bool:
        return path in self.store

    def get(self, path: str):
        return self.store.get(path)

    def put(self, path: str, plane: np.ndarray) -> None:
        if path in self.store:
            return
        if self.max_bytes is not None and self.bytes + plane.nbytes > self.max_bytes:
            return
        self.store[path] = plane
        self.bytes += plane.nbytes


def make_dense_batch_fn(dataset, size: int, num_threads: int = 4, out_depth: int = 8,
                        regression: bool = False, cache: Optional[DecodedPlaneCache] = None):
    """``HostLoader(native_batch_fn=...)``'s whole-batch path over a manifest
    dataset (``dataset.file_list`` rows ``(name, target, plane_paths)``): the
    batch decoded in the C++ thread pool straight into the dense raw layout,
    no Python per plane. Missing targets (unlabeled manifests) become -1.
    With ``cache``, only the images with a plane not cached are decoded."""
    dtype = np.uint16 if out_depth == 16 else np.uint8

    def batch_fn(idxs, width):
        rows = [dataset.file_list[int(i)] for i in idxs]
        if cache is None:
            images, counts = load_dense_batch_raw([r[2] for r in rows], width, size, size,
                                                  num_threads=num_threads, out_depth=out_depth)
        else:
            images = np.zeros((len(rows), width, size, size), dtype)
            counts = np.asarray([min(len(r[2]), width) for r in rows], np.int32)
            missing = [i for i, r in enumerate(rows) if any(p not in cache for p in r[2][:width])]
            if missing:
                dec, _ = load_dense_batch_raw([rows[i][2] for i in missing], width, size, size,
                                              num_threads=num_threads, out_depth=out_depth)
                for k, i in enumerate(missing):
                    images[i] = dec[k]
                    for j, p in enumerate(rows[i][2][:width]):
                        cache.put(p, dec[k, j].copy())  # exact bytes, no pad planes
            missing_set = set(missing)
            for i, r in enumerate(rows):
                if i not in missing_set:
                    for j, p in enumerate(r[2][:width]):
                        images[i, j] = cache.get(p)
        if regression:
            labels = np.asarray([float(r[1]) for r in rows], np.float32)
        else:
            labels = np.asarray([int(r[1]) if r[1] is not None else -1 for r in rows], np.int32)
        return {"images": images, "channel_counts": counts, "labels": labels}

    return batch_fn


class NativeEvalLoader:
    """The evaluation loaders' batches with the whole decode, resize, centre
    crop and [0, 1] normalisation in the C++ thread pool: the fast path of
    the online kNN, ``main_knn`` and ``main_umap``'s feature extraction.

    Over ``dataset.file_list`` rows ``(name, target, plane_paths)`` in file
    order, each batch padded to ``max_channels`` as the JAX loader pads it;
    batches are ``{"images": (B, max_channels, size, size) float32,
    "channel_counts", "labels"}``, labels float where ``dataset.task`` is
    ``"regression"``, else int. ``resize_mode``/``resize_size`` as
    :func:`load_dense_batch`."""

    NUM_THREADS = 8

    def __init__(self, dataset, batch_size: int, max_channels: int, size: int,
                 resize_mode: int = 0, resize_size: int = 0):
        self.dataset = dataset
        self.rows = list(dataset.file_list)
        self.task = getattr(dataset, "task", "classification")
        self.batch_size = batch_size
        self.max_channels = max_channels
        self.size = size
        self.resize_mode = resize_mode
        self.resize_size = resize_size

    def __len__(self) -> int:
        return -(-len(self.rows) // self.batch_size)

    def __iter__(self):
        cast = float if self.task == "regression" else int
        for s in range(0, len(self.rows), self.batch_size):
            rows = self.rows[s:s + self.batch_size]
            images, counts = load_dense_batch(
                [r[2] for r in rows], self.max_channels, self.size, self.size,
                self.NUM_THREADS, resize_mode=self.resize_mode,
                resize_size=self.resize_size, normalize=True)
            yield {"images": images, "channel_counts": counts,
                   "labels": np.asarray([cast(r[1]) for r in rows])}
