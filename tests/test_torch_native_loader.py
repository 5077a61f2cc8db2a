"""The port's native decoder (``chadavit_tpu_torch/data/native.py`` over
``chadavit_tpu_torch/native/chadaloader.cpp``), its disk generator
(``data/disk_dataset.py``) and the raw loader of the on-device augmentation
path, against the JAX package's on the CPU.

- Decoded planes and raw dense batches equal the JAX decoder's bit for
  bit, on 8- and 16-bit PNG, JPEG and TIFF, where both libraries load (else
  skipped with the reason); the float batches of the evaluation resize to
  1e-6 relative.
- A build without a codec (as on a machine without its header) raises an
  error that names the header for that format, and decodes the rest as the
  full build does: a zlib-only build reads the grayscale PNG planes.
- The raw ``HostLoader`` (``channels_last``, ``dtype``, ``native_batch_fn``)
  gives the JAX loader's batches bit for bit: on ``SyntheticChannels(uint8)``
  and on a manifest written by the port's generator, through
  ``build_pretrain_loader`` on ``scripts/pretrain/dino_idr10k.yaml``.
- The port's generator writes the JAX tool's images and manifest.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from chadavit_tpu.data import native as jax_native
from chadavit_tpu.data.datasets import SyntheticChannels as JaxSyntheticChannels
from chadavit_tpu.data.pipeline import HostLoader as JaxHostLoader
from chadavit_tpu_torch.data import native
from chadavit_tpu_torch.data.datasets import SyntheticChannels, load_channel_stack
from chadavit_tpu_torch.data.disk_dataset import generate, write_png
from chadavit_tpu_torch.data.pipeline import HostLoader

ROOT = Path(__file__).resolve().parent.parent
IDR10K = ROOT / "scripts" / "pretrain" / "dino_idr10k.yaml"


@pytest.fixture(scope="module")
def libs():
    if not native.is_available():
        pytest.skip(f"the port's native decoder does not build here: {native.build_error()}")
    if not jax_native.is_available():
        pytest.skip(f"the JAX package's native decoder does not load: {jax_native.build_error()}")
    return native, jax_native


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("planes")
    rng = np.random.default_rng(0)
    files = {
        "gray8.png": (rng.random((30, 40)) * 255).astype(np.uint8),
        "gray16.png": (rng.random((25, 35)) * 65535).astype(np.uint16),
        "gray.jpg": (rng.random((32, 32)) * 255).astype(np.uint8),
        "gray16.tif": (rng.random((28, 36)) * 65535).astype(np.uint16),
        "gray8.tif": (rng.random((20, 24)) * 255).astype(np.uint8),
    }
    for name, a in files.items():
        Image.fromarray(a).save(d / name, **({"quality": 95} if name.endswith("jpg") else {}))
    rgb = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(d / "rgb.png")
    write_png(str(d / "zlib8.png"), files["gray8.png"])
    write_png(str(d / "zlib16.png"), files["gray16.png"])
    return d, files


@pytest.mark.parametrize("name", ["gray8.png", "gray16.png", "gray.jpg", "gray16.tif",
                                  "gray8.tif", "rgb.png", "zlib8.png", "zlib16.png"])
def test_decoded_planes_equal_the_jax_decoders(libs, planes, name):
    d, files = planes
    path = str(d / name)
    got, want = native.decode_plane_raw(path), jax_native.decode_plane_raw(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.decode_plane(path), jax_native.decode_plane(path))
    if name in files and not name.endswith("jpg"):  # lossless formats: the pixels
        np.testing.assert_array_equal(got, files[name])


def test_our_png_writer_round_trips(libs, planes):
    d, files = planes
    for name, src in (("zlib8.png", "gray8.png"), ("zlib16.png", "gray16.png")):
        np.testing.assert_array_equal(native.decode_plane_raw(str(d / name)), files[src])


@pytest.mark.parametrize("out_depth", [8, 16])
def test_dense_raw_batches_equal_the_jax_decoders(libs, planes, out_depth):
    d, _ = planes
    paths = [[str(d / "gray8.png")], [str(d / "gray16.tif"), str(d / "gray8.png")],
             [str(d / "gray.jpg"), str(d / "zlib16.png"), str(d / "gray8.tif")]]
    got = native.load_dense_batch_raw(paths, 3, 16, 16, num_threads=2, out_depth=out_depth)
    want = jax_native.load_dense_batch_raw(paths, 3, 16, 16, num_threads=2,
                                           out_depth=out_depth)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode, size, normalize", [(0, 0, False), (1, 24, True), (2, 24, True)])
def test_dense_float_batches_equal_the_jax_decoders(libs, planes, mode, size, normalize):
    d, _ = planes
    paths = [[str(d / "gray16.tif")], [str(d / "gray8.png"), str(d / "gray.jpg")]]
    kw = dict(resize_mode=mode, resize_size=size, normalize=normalize)
    got = native.load_dense_batch(paths, 2, 16, 16, **kw)
    want = jax_native.load_dense_batch(paths, 2, 16, 16, **kw)
    # the float resize: the JAX library is built with -march=native, whose
    # fused multiply-adds round otherwise (read: 1 ulp, 6e-8 on [0, 1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6 if normalize else 1e-4)
    np.testing.assert_array_equal(got[1], want[1])


def test_batch_fn_and_its_cache_equal_the_jax_ones(libs, planes):
    d, _ = planes
    p8, p16 = str(d / "gray8.png"), str(d / "zlib8.png")

    class DS:
        file_list = [("a", 3, [p8]), ("b", None, [p8, p16]), ("c", "1", [p16])]

    for cache in (False, True):
        fn = native.make_dense_batch_fn(DS(), 8, num_threads=1,
                                        cache=native.DecodedPlaneCache() if cache else None)
        jfn = jax_native.make_dense_batch_fn(DS(), 8, num_threads=1,
                                             cache=jax_native.DecodedPlaneCache() if cache
                                             else None)
        for _ in range(2):  # with the cache, the second call decodes nothing
            got, want = fn([0, 1, 2], 2), jfn([0, 1, 2], 2)
            assert set(got) == set(want)
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_cache_stops_at_its_cap_and_keeps_serving(libs, planes):
    d, files = planes
    p = str(d / "gray8.png")

    class DS:
        file_list = [("a", 0, [p]), ("b", 1, [str(d / "zlib16.png")])]

    cache = native.DecodedPlaneCache(max_bytes=8 * 8)
    fn = native.make_dense_batch_fn(DS(), 8, num_threads=1, cache=cache)
    first, again = fn([0, 1], 1), fn([0, 1], 1)
    assert len(cache.store) == 1 and cache.bytes == 8 * 8
    np.testing.assert_array_equal(first["images"], again["images"])


def test_a_codec_left_out_raises_naming_its_header(libs, planes):
    """A build without libtiff (as where tiffio.h is missing) refuses a TIFF
    and names the header; one with zlib alone (a machine with no other codec
    header) reads the
    grayscale PNGs as the full build does, and names png.h and jpeglib.h for
    an RGB PNG and a JPEG."""
    d, _ = planes
    no_tiff = native.library(without=("tiff",))
    assert no_tiff is not None and "tiff" not in native.codecs(no_tiff)
    with pytest.raises(native.MissingCodecError, match="tiffio.h"):
        native.decode_plane_raw(str(d / "gray16.tif"), lib=no_tiff)
    zlib_only = native.library(without=("deflate", "png", "jpeg", "tiff"))
    if zlib_only is None:
        pytest.skip("no zlib.h here")
    assert native.codecs(zlib_only) == ["png-gray"]
    for name in ("gray8.png", "gray16.png", "zlib8.png", "zlib16.png"):
        np.testing.assert_array_equal(native.decode_plane_raw(str(d / name), lib=zlib_only),
                                      native.decode_plane_raw(str(d / name)))
    with pytest.raises(native.MissingCodecError, match="png.h"):
        native.decode_plane_raw(str(d / "rgb.png"), lib=zlib_only)
    with pytest.raises(native.MissingCodecError, match="jpeglib.h"):
        native.decode_plane(str(d / "gray.jpg"), lib=zlib_only)


def test_a_corrupt_png_fails_cleanly(libs, tmp_path):
    rng = np.random.default_rng(1)
    src = tmp_path / "ok.png"
    write_png(str(src), rng.integers(0, 256, (31, 37), dtype=np.uint8))
    data = src.read_bytes()
    for i, k in enumerate(range(8, len(data), 97)):
        p = tmp_path / f"cut{i}.png"
        p.write_bytes(data[:k])
        with pytest.raises(RuntimeError):
            native.decode_plane_raw(str(p))


def test_the_dataset_reads_planes_through_the_native_decoder(libs, planes, monkeypatch):
    """load_channel_stack(raw=True) takes the native branch of _imread (PIL
    is never asked), and equals the JAX package's stack."""
    from chadavit_tpu.data.datasets import load_channel_stack as jax_stack

    d, _ = planes
    paths = [str(d / "gray8.png"), str(d / "zlib8.png")]
    want = jax_stack(paths, raw=True)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = load_channel_stack(paths, raw=True)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# ---- the generator ---------------------------------------------------------------
def test_the_generator_writes_the_jax_tools_images_and_manifest(libs, tmp_path):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import generate_disk_dataset as jax_tool
    finally:
        sys.path.remove(str(ROOT / "tools"))
    port_dir = generate(str(tmp_path / "port"), 6, img_size=32, num_classes=7, seed=2,
                        workers=1, image_subdir="")
    jdir = tmp_path / "jax"
    jdir.mkdir()
    for i in range(6):
        idx, label, names = jax_tool._make_one((i, 2 * 1_000_003 + i, 32, 1, 10, 8, "png", 7,
                                                str(jdir)))
        row = (Path(port_dir) / "train.csv").read_text().splitlines()[i]
        assert row.startswith(f"img{idx:06d},{label},")
        for name in names:
            np.testing.assert_array_equal(native.decode_plane_raw(str(Path(port_dir) / name)),
                                          native.decode_plane_raw(str(jdir / name)))


# ---- the raw loader ----------------------------------------------------------------
@pytest.mark.parametrize("bucket", [False, True])
def test_raw_loader_equals_the_jax_loader_on_synthetic_uint8(bucket):
    kw = dict(n=40, img_size=16, min_channels=1, max_channels=6, seed=3, dtype=np.uint8)
    lkw = dict(batch_size=8, max_channels=6, num_workers=3, seed=1, channels_last=True,
               bucket_by_channels=bucket, bucket_round=1, dtype=np.uint8)
    port = HostLoader(SyntheticChannels(**kw), **lkw)
    ref = JaxHostLoader(JaxSyntheticChannels(**kw), **lkw)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in g:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture(scope="module")
def idr_manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("idr")
    return generate(str(d), 24, img_size=32, num_classes=7, seed=5, workers=1, image_subdir="")


@pytest.mark.parametrize("native_loader", [True, False])
def test_idr10k_raw_loader_equals_the_jax_loader(libs, idr_manifest, native_loader, capsys):
    """build_pretrain_loader on dino_idr10k.yaml (device_augmentations:
    true) over the port's generated manifest: the same batches as JAX's
    loader, through the batch decoder and one sample at a time."""
    from chadavit_tpu.config import load_yaml as jax_load_yaml
    from chadavit_tpu.config import parse_pretrain_cfg as jax_parse
    from chadavit_tpu.train.loop import build_pretrain_loader as jax_build_loader
    from chadavit_tpu_torch.cli import apply_overrides
    from chadavit_tpu_torch.config import load_yaml, parse_pretrain_cfg
    from chadavit_tpu_torch.train.loop import build_pretrain_loader

    over = [f"data.train_path={idr_manifest}", "data.sample_ratio=1.0",
            "optimizer.batch_size=8", f"data.native_loader={native_loader}",
            "data.cache_decoded=false"]
    port_cfg = parse_pretrain_cfg(apply_overrides(load_yaml(str(IDR10K)), over))
    jax_cfg = jax_parse(apply_overrides(jax_load_yaml(str(IDR10K)), over))
    for cfg in (port_cfg, jax_cfg):
        for aug in cfg["augmentations"]:
            aug["crop_size"] = 32
    port, ref = build_pretrain_loader(port_cfg, seed=5), jax_build_loader(jax_cfg, seed=5)
    assert ("whole batches" in capsys.readouterr().out) == native_loader
    assert (port.native_batch_fn is None) == (ref.native_batch_fn is None) == (not native_loader)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("images", "channel_counts", "labels"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["images"].dtype == np.uint8
