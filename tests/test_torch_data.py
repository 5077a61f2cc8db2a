"""The port's host multicrop loader (``train/loop.py::build_pretrain_loader``
over ``data/``) held against the JAX package's data pieces on the CPU.

The JAX loader draws every sample's augmentation from the one generator of
its pipeline, consumed in whatever order its worker threads reach the
samples, so its crops change from run to run under several workers (and a
resumed run starts the generator afresh). The port gives each sample its own
generator, ``sample_rng(seed, epoch, index)``. So the reference here is the
JAX package's own pieces driven the port's way: its dataset
(``prepare_datasets``), its batch order (``HostLoader._batches`` and
``_bucket_width``), its augmentation pipelines (``build_transform_pipeline``,
``NCropAugmentation``, ``FullTransformPipeline``) called with each sample's
generator, and its ``dense_collate``. Batches must be equal bit for bit, for
``scripts/smoke/dino_synthetic.yaml`` and for the canonical asymmetric
augmentations (``scripts/pretrain/augmentations/asymmetric.yaml``) at crop
32, loader seeds 0 and 1, epochs 0 and 1.

Also: the port's batches do not depend on the number of worker threads, and
``iter_from(skip)`` yields exactly the tail of the full epoch.
"""

from pathlib import Path

import numpy as np
import pytest

from chadavit_tpu.config import load_yaml as jax_load_yaml
from chadavit_tpu.config import parse_pretrain_cfg as jax_parse
from chadavit_tpu.data.datasets import prepare_datasets as jax_prepare_datasets
from chadavit_tpu.data.pipeline import HostLoader as JaxHostLoader
from chadavit_tpu.data.pipeline import dense_collate as jax_dense_collate
from chadavit_tpu.data.transforms import FullTransformPipeline as JaxFull
from chadavit_tpu.data.transforms import NCropAugmentation as JaxNCrop
from chadavit_tpu.data.transforms import build_transform_pipeline as jax_build_pipeline
from chadavit_tpu_torch.cli import apply_overrides
from chadavit_tpu_torch.config import load_yaml, parse_pretrain_cfg
from chadavit_tpu_torch.data.pipeline import sample_rng
from chadavit_tpu_torch.train.loop import build_pretrain_loader

ROOT = Path(__file__).resolve().parent.parent
SMOKE = ROOT / "scripts" / "smoke" / "dino_synthetic.yaml"
CANONICAL = ROOT / "scripts" / "pretrain" / "dino_chada_vit_moyen.yaml"
CONFIGS = {
    "smoke": (SMOKE, ["data.size=48"]),
    "asymmetric-crop32": (CANONICAL, ["data.dataset=synthetic", "data.size=24",
                                      "optimizer.batch_size=8", "data.num_workers=3"]),
}


def _cfgs(which):
    path, overrides = CONFIGS[which]
    port = parse_pretrain_cfg(apply_overrides(load_yaml(str(path)), overrides))
    ref = jax_parse(apply_overrides(jax_load_yaml(str(path)), overrides))
    for cfg in (port, ref):
        for aug in cfg["augmentations"]:
            aug["crop_size"] = 32
    return port, ref


def _jax_batches(cfg, seed, epoch):
    """The JAX pieces, each sample augmented with its own generator."""
    transform = JaxFull([JaxNCrop(jax_build_pipeline(cfg.data.dataset, aug, seed=seed + i),
                                  aug.get("num_crops", 1))
                         for i, aug in enumerate(cfg["augmentations"])])
    raw = jax_prepare_datasets(cfg.data.dataset, transform=None, train=True,
                               n=cfg.data.get("size", 256), img_size=32,
                               max_channels=cfg.data.get("max_img_channels", 10))
    max_channels = (cfg.backbone.get("kwargs", {}).get("max_number_channels")
                    or cfg.data.get("max_img_channels", 10))
    order = JaxHostLoader(raw, batch_size=cfg.optimizer.batch_size, max_channels=max_channels,
                          seed=seed, bucket_by_channels=cfg.get("bucket_by_channels", False),
                          bucket_round=int(cfg.get("bucket_round", 1)))
    order.set_epoch(epoch)
    out = []
    for idxs in order._batches():
        samples = []
        for i in idxs:
            img, label = raw[int(i)]
            rng = np.random.default_rng([seed, epoch, int(i)])  # the port's rule
            samples.append((transform(img, rng), label))
        width = order._bucket_width(idxs) if order.bucket_by_channels else max_channels
        out.append(jax_dense_collate(samples, width))
    return out


def _assert_same(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_batches_equal_the_jax_pieces_bit_for_bit(which, seed, epoch):
    port_cfg, jax_cfg = _cfgs(which)
    loader = build_pretrain_loader(port_cfg, seed=seed)
    loader.set_epoch(epoch)
    got = list(loader)
    _assert_same(got, _jax_batches(jax_cfg, seed, epoch))
    assert got[0]["crops"].shape[0] == port_cfg.data.num_large_crops


def test_each_epoch_augments_anew():
    # the same samples in another epoch get other crops, and the generator is
    # the documented one
    port_cfg, _ = _cfgs("smoke")
    loader = build_pretrain_loader(port_cfg, seed=5)
    by_epoch = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        by_epoch.append({int(i): c for b, idxs in zip(loader, loader._batches())
                         for i, c in zip(idxs, b["crops"][0])})
    assert not any(np.array_equal(by_epoch[0][i], by_epoch[1][i]) for i in by_epoch[0])
    a, b = sample_rng(5, 1, 7), np.random.default_rng([5, 1, 7])
    assert a.random() == b.random()


def test_batches_do_not_depend_on_the_worker_threads():
    port_cfg, _ = _cfgs("asymmetric-crop32")
    runs = []
    for workers in (1, 4, 4):
        port_cfg.data.num_workers = workers
        loader = build_pretrain_loader(port_cfg, seed=5)
        runs.append(list(loader))
    _assert_same(runs[1], runs[0])
    _assert_same(runs[2], runs[0])


@pytest.mark.parametrize("skip", [1, 2])
def test_iter_from_yields_the_tail_of_the_epoch(skip):
    port_cfg, _ = _cfgs("smoke")
    loader = build_pretrain_loader(port_cfg, seed=5)
    loader.set_epoch(1)
    full = list(loader)
    loader.set_epoch(1)
    _assert_same(list(loader.iter_from(skip)), full[skip:])
