"""The port's validation during pretraining (``train/loop.py::Validation``)
and its C++ eval loader (``data/native.py::NativeEvalLoader``) against the
JAX package on the CPU, at the smoke YAML's width (D 64, depth 2, 32 px
crops), over a manifest of 32 train and 16 test PNG images of 1-4 channels
written by the port's generator (the bbbc048 dataset class reads it).

- ``prepare_data(native_loader=True)`` of both packages: the same batches,
  counts and labels equal, images within 1e-6 (each package builds the one
  C++ source with its own flags); and the port's native batches within
  1e-2 of its host eval loader's on the same images (the resize of
  ``tests/test_native_loader.py``).
- The online kNN of one state in both packages (the port's seeded weights
  carried into JAX params): ``val_knn_top1`` / ``val_knn_top5`` equal JAX's
  ``extract_features`` + ``knn_classify`` on the same parameters over the
  JAX loop's loaders.
- ``make_dino_eval_loss`` on fixed views against JAX's, relative 1e-5.
- ``dino_loss_val``: the same views for the same epoch, other views for
  another.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.cli import apply_overrides as jax_apply
from chadavit_tpu.config import load_yaml as jax_load_yaml
from chadavit_tpu.config import parse_pretrain_cfg as jax_parse
from chadavit_tpu.data.classification import prepare_data as jax_prepare_data
from chadavit_tpu.eval.features import extract_features as jax_extract
from chadavit_tpu.eval.knn import knn_classify as jax_knn
from chadavit_tpu.models import get_backbone
from chadavit_tpu.models.dino_head import DINOHead as JaxHead
from chadavit_tpu.models.import_torch import (
    chada_vit_params_from_torch,
    dino_head_params_from_torch,
)
from chadavit_tpu.train.dino_step import DinoStepConfig as JaxStepConfig
from chadavit_tpu.train.dino_step import make_dino_eval_loss as jax_eval_loss
from chadavit_tpu.train.loop import spec_from_cfg as jax_spec_from_cfg
from chadavit_tpu.train.state import DinoState as JaxDinoState
from chadavit_tpu_torch.cli import apply_overrides
from chadavit_tpu_torch.config import load_yaml, parse_pretrain_cfg
from chadavit_tpu_torch.data import native
from chadavit_tpu_torch.data.classification import prepare_data, prepare_transforms
from chadavit_tpu_torch.data.datasets import prepare_datasets
from chadavit_tpu_torch.data.disk_dataset import generate
from chadavit_tpu_torch.data.pipeline import HostLoader
from chadavit_tpu_torch.train import loop
from chadavit_tpu_torch.train.dino_step import DinoStepConfig, make_dino_eval_loss
from chadavit_tpu_torch.train.pretrain import build_dino

SMOKE = Path(__file__).resolve().parent.parent / "scripts" / "smoke" / "dino_synthetic.yaml"
N_TRAIN, N_TEST, C_MAX, CROP = 32, 16, 4, 32
LOSS_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: at these sizes eight are slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    if not native.is_available():
        pytest.skip(f"the port's native decoder does not build here: {native.build_error()}")
    root = tmp_path_factory.mktemp("manifest")
    # 40 px planes, so that the eval protocol's resize and crop do work
    generate(str(root), N_TRAIN + N_TEST, img_size=40, max_channels=C_MAX, num_classes=7,
             val_fraction=N_TEST / (N_TRAIN + N_TEST), seed=4, workers=1, image_subdir="")
    return root


def _overrides(root):
    return ["data.dataset=bbbc048", f"data.train_path={root}", f"data.val_path={root}",
            "knn_eval.enabled=true", "knn_eval.k=5", "ssl_val_loss=true", "seed=3"]


def _loaders(prep, root, native_loader):
    return prep("bbbc048", train_path=str(root), val_path=str(root), batch_size=16,
                max_channels=C_MAX, crop_size=CROP, val_transform_for_train=True,
                native_loader=native_loader, subset_seed=3)


def test_native_eval_loader_matches_jax(manifest, capsys):
    from chadavit_tpu.data import native as jax_native

    if not jax_native.is_available():
        pytest.skip(f"the JAX package's native decoder does not load: {jax_native.build_error()}")
    port = _loaders(prepare_data, manifest, True)
    assert "NativeEvalLoader" in capsys.readouterr().out
    ref = _loaders(jax_prepare_data, manifest, True)
    assert [type(ld).__name__ for ld in port + ref] == ["NativeEvalLoader"] * 4
    for got_loader, want_loader in zip(port, ref):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(got_loader) == len(want_loader)
        for g, w in zip(got, want):
            assert g["images"].shape == w["images"].shape == (len(w["labels"]), C_MAX, CROP, CROP)
            np.testing.assert_array_equal(g["channel_counts"], w["channel_counts"])
            np.testing.assert_array_equal(g["labels"], w["labels"])
            assert g["labels"].dtype == w["labels"].dtype
            np.testing.assert_allclose(g["images"], w["images"], rtol=0, atol=1e-6)


def test_native_eval_batches_are_the_host_path_s(manifest):
    bank, _ = _loaders(prepare_data, manifest, True)
    _, t_val = prepare_transforms("bbbc048", CROP)
    host = HostLoader(prepare_datasets("bbbc048", transform=t_val, train_path=str(manifest)),
                      batch_size=16, max_channels=C_MAX, num_workers=1, shuffle=False,
                      drop_last=False, bucket_by_channels=False)
    for nb, hb in zip(bank, host, strict=True):
        np.testing.assert_array_equal(nb["channel_counts"], hb["channel_counts"])
        np.testing.assert_array_equal(nb["labels"], hb["labels"])
        np.testing.assert_allclose(nb["images"], hb["images"], rtol=0, atol=1e-2)


@pytest.fixture(scope="module")
def states(manifest, tmp_path_factory):
    """The port's seeded state at the smoke width (a random center, step 6)
    and the JAX state, backbone and head carried across from it."""
    over = _overrides(manifest)
    jcfg = jax_parse(jax_apply(jax_load_yaml(str(SMOKE)), over))
    cfg = parse_pretrain_cfg(apply_overrides(load_yaml(str(SMOKE)), over))
    spec = loop.spec_from_cfg(cfg, 2)
    state, _, _, _ = build_dino(spec, device="cpu", seed=3)
    state.center = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, spec.num_prototypes)).astype(np.float32) * 0.1)
    state.step = 6

    jspec = jax_spec_from_cfg(jcfg, 2)
    jmodel = get_backbone(jspec.backbone, **{**jspec.backbone_kwargs,
                                             "img_size": jspec.img_size, "dtype": jspec.dtype})
    jhead = JaxHead(in_dim=jspec.backbone_kwargs["embed_dim"],
                    num_prototypes=jspec.num_prototypes, hidden_dim=jspec.proj_hidden_dim,
                    bottleneck_dim=jspec.proj_output_dim, dtype=jspec.dtype)

    def jax_side(side):
        sd = {part: {k: v.numpy() for k, v in side[part].state_dict().items()}
              for part in ("backbone", "head")}
        return jax.tree_util.tree_map(jnp.asarray, {
            "backbone": chada_vit_params_from_torch(sd["backbone"],
                                                    depth=len(side["backbone"].blocks)),
            "head": dino_head_params_from_torch(sd["head"])})

    jstate = JaxDinoState(step=jnp.asarray(6, jnp.int32), student=jax_side(state.student),
                          teacher=jax_side(state.teacher), opt_state=None,
                          center=jnp.asarray(state.center.numpy()))
    out = tmp_path_factory.mktemp("val")
    return cfg, spec, state, jcfg, jspec, jstate, jmodel, jhead, out


def test_online_knn_matches_jax(states):
    cfg, spec, state, jcfg, jspec, jstate, jmodel, _, out = states
    val = loop.Validation(cfg, spec, 2, "cpu", 3, str(out))
    got = val(state, epoch=0)

    knn = jcfg.knn_eval
    bank, queries = jax_prepare_data(
        jcfg.data.dataset, train_path=jcfg.data.train_path, val_path=jcfg.data.val_path,
        batch_size=jcfg.optimizer.batch_size, max_channels=C_MAX, crop_size=CROP,
        val_transform_for_train=True, native_loader=True,
        sample_ratio=float(knn.get("train_sample_ratio", jcfg.data.get("sample_ratio", 1.0))),
        subset_seed=3)

    def feature_fn(p, images, counts):
        return jmodel.apply({"params": p}, images.astype(jspec.dtype), counts)

    params = jax.device_get(jstate.student["backbone"])
    te_f, te_t = jax_extract(queries, feature_fn, params)
    tr_f, tr_t = jax_extract(bank, feature_fn, params)
    want = jax_knn(tr_f, tr_t, te_f, te_t, k=int(knn.get("k", 20)),
                   distance_fx=knn.get("distance_func", "cosine"))
    assert (got["val_knn_top1"], got["val_knn_top5"]) == want
    assert np.isfinite(got["dino_loss_val"])
    # the same views for the same epoch: the loss repeats bit for bit
    assert val.ssl_loss(state, 0) == got["dino_loss_val"]
    assert val.ssl_loss(state, 1) != got["dino_loss_val"]


def test_eval_loss_matches_jax(states):
    _, spec, state, _, jspec, jstate, jmodel, jhead, _ = states
    rng = np.random.default_rng(8)
    crops = rng.random((2, 6, C_MAX, CROP, CROP)).astype(np.float32)
    counts = np.asarray([1, 4, 2, 3, 4, 1], np.int32)
    for i, c in enumerate(counts):
        crops[:, i, c:] = 0.0
    kw = dict(num_large_crops=2, student_temp=spec.student_temperature,
              warmup_teacher_temp=spec.warmup_teacher_temperature,
              teacher_temp=spec.teacher_temperature,
              warmup_teacher_temp_epochs=spec.warmup_teacher_temperature_epochs,
              steps_per_epoch=4, total_steps=spec.total_steps)
    want = jax.jit(jax_eval_loss(lambda p, x, c: jmodel.apply({"params": p}, x, c),
                                 lambda p, f: jhead.apply({"params": p}, f),
                                 JaxStepConfig(**kw)))(
        jstate, {"crops": jnp.asarray(crops), "channel_counts": jnp.asarray(counts)})
    got = make_dino_eval_loss(lambda m, x, c: m(x, c), lambda h, f: h(f), DinoStepConfig(**kw))(
        state, {"crops": torch.from_numpy(crops), "channel_counts": torch.from_numpy(counts)})
    assert abs(float(got) / float(want) - 1) <= LOSS_REL
