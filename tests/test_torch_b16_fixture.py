"""The committed ChAdaViT-B/16 JAX fixtures that ``chip_smoke.py`` holds the
card to (``tests/goldens/torch_port_{cls,dino}_b16{,_bf16}_depth2.npz``,
``tests/torch_port_fixture.py``: D 768, 12 heads of 64, FFN 2048, depth 2,
224 px; the CLS of four images of 10, 7, 3 and 1 channels and three DINO
steps on two images of 10 and 4 channels with a 65 536-prototype head, each
batch padded to 2048 rows, where the JAX layer, and the port's, take the
unfused route): the CLS files are still what the JAX package computes, and
the port's plain path on the CPU matches all four.

Tolerances. The CLS recompute runs the same JAX program: 1e-5 absolute in
float32, one bfloat16 step in bfloat16. The port against the float32 files:
the bounds of ``tests/test_torch_fixture.py`` (CLS cosine >= 1 - 1e-5 per
row and 1e-4 absolute; over the DINO steps 1e-4 relative on the metrics,
1e-5 on the parameter norms, 1e-3 on the norms of the student's changes).
Against the bfloat16 files: the CLS cosine >= 1 - 1e-4 per row and max abs
within 4 bfloat16 steps at the CLS's largest entry, a few times the port's
reading on the CPU (1 - 1.8e-5; 6.25e-2, two steps at |x| 4.59: the B/16 CLS
reaches past 4, where moyen's bound of 5e-2 is less than two steps); the
DINO steps at the bounds of ``tests/test_torch_fixture_bf16.py`` (5e-3,
1e-3, 5e-2).
"""

import numpy as np
import pytest
import torch

from chadavit_tpu_torch.hub import collate_images, random_images
from chadavit_tpu_torch.models.chada_vit import chada_vit
from chadavit_tpu_torch.ops import fused_block
from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, build_dino, synthetic_dino_batch
from tests import torch_port_fixture as fixture

D, HEADS, FFN = 768, 12, 2048


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b16_cls_fixture_is_what_jax_computes(dtype):
    d = _load(fixture.B16_PATH if dtype == "float32" else fixture.B16_BF16_PATH)
    assert (int(d["embed_dim"]), int(d["num_heads"])) == (D, HEADS)
    assert tuple(d["counts"]) == fixture.COUNTS and int(d["depth"]) == fixture.DEPTH
    ref = fixture.jax_cls(dtype, "b16")
    if dtype == "float32":
        np.testing.assert_allclose(ref, d["cls"], rtol=0, atol=1e-5)
    else:
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(d["cls"]), 2.0 ** -126))) - 7)
        assert (np.abs(ref - d["cls"]) <= step).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_on_cpu_matches_the_b16_cls_fixture(dtype):
    d = _load(fixture.B16_PATH if dtype == "float32" else fixture.B16_BF16_PATH)
    model = chada_vit(depth=int(d["depth"]), return_all_tokens=False,
                      img_size=int(d["img_size"]), embed_dim=int(d["embed_dim"]),
                      num_heads=int(d["num_heads"]), dtype=getattr(torch, dtype))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in fixture.port_state_dict("b16").items()})
    x, cc = collate_images(random_images(d["counts"].tolist(), int(d["img_size"]),
                                         int(d["image_seed"])))
    assert not fused_block.jax_layer_fused(1 + 196 * 10 + 87, D, FFN, HEADS, model.dtype)
    with torch.no_grad():
        out = model.eval()(x, cc).float().numpy()
    ref = d["cls"]
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    if dtype == "float32":
        assert cos.min() >= 1 - 1e-5, cos
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    else:
        top = np.abs(ref).max()
        assert cos.min() >= 1 - 1e-4, cos
        assert np.abs(out - ref).max() <= 4 * 2.0 ** (np.floor(np.log2(top)) - 7)


# (metric, parameter norm, norm of the student's change) relative bounds:
# tests/test_torch_fixture.py's in float32, tests/test_torch_fixture_bf16.py's
# in bfloat16
DINO_BOUNDS = {"float32": (1e-4, 1e-5, 1e-3), "bfloat16": (5e-3, 1e-3, 5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_on_cpu_matches_the_b16_dino_fixture(dtype):
    d = _load(fixture.B16_DINO_PATH if dtype == "float32" else fixture.B16_DINO_BF16_PATH)
    assert (int(d["embed_dim"]), int(d["num_heads"]), int(d["num_prototypes"])) == (
        D, HEADS, fixture.B16_PROTOTYPES)
    metric_rel, norm_rel, delta_rel = DINO_BOUNDS[dtype]
    spec = DinoPretrainSpec(**fixture.B16_DINO_SPEC, dtype=getattr(torch, dtype))
    state, step, _, _ = build_dino(spec, device="cpu", seed=int(d["weight_seed"]))
    batch = synthetic_dino_batch(spec, len(d["counts"]), int(d["batch_seed"]),
                                 d["counts"].tolist(), device="cpu")
    assert batch["crops"].shape[2] == 10  # S 2048: the unfused route
    before = {n: p.detach().clone() for n, p in state.trainable()}
    for i in range(int(d["steps"])):
        state, m = step(state, batch)
        for k in fixture.DINO_METRICS:
            np.testing.assert_allclose(float(m[k]), d[k][i], rtol=metric_rel, err_msg=k)
    names = [str(n) for n in d["names"]]
    for side in ("student", "teacher"):
        sd = {f"{part}.{k}": v for part in ("backbone", "head")
              for k, v in getattr(state, side)[part].state_dict().items()}
        assert sorted(sd) == names
        norms = [sd[n].double().norm().item() for n in names]
        np.testing.assert_allclose(norms, d[f"{side}_norms"], rtol=norm_rel, err_msg=side)
        if side == "student":
            for i, n in enumerate(names):
                if n in before and d["student_delta_norms"][i] > 0:
                    delta = (sd[n] - before[n]).double().norm().item()
                    np.testing.assert_allclose(delta, d["student_delta_norms"][i],
                                               rtol=delta_rel, err_msg=n)


# ---- B/16 where the JAX gate takes its fused layer kernel ---------------------------
# The narrow fixtures (tests/torch_port_fixture.py, MODELS["b16_narrow"]): the
# CLS of images of 3, 2 and 1 channels and three DINO steps on crops of 3
# planes, 640 rows, where the JAX layer and the port's take the fused route
# (the port's layer chain, its D 768 instances on the card), computed by JAX
# through its fused Pallas layer kernel (block_impl="fused", interpret mode).
# The recompute here takes JAX's XLA route, held to the fused kernel's file at
# 2e-5 absolute in float32 (read: 2.4e-6) and in bfloat16 at a cosine of
# 1 - 1e-4 per row and 4 bfloat16 steps at the CLS's largest entry (read:
# 1 - 2.0e-5 and 2 steps at |x| 4.6); the port's plain path on the CPU is
# held at the bounds above.
NARROW_CLS = {"float32": fixture.B16_NARROW_PATH, "bfloat16": fixture.B16_NARROW_BF16_PATH}
NARROW_DINO = {"float32": fixture.B16_NARROW_DINO_PATH,
               "bfloat16": fixture.B16_NARROW_DINO_BF16_PATH}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b16_narrow_cls_fixture_is_what_jax_computes(dtype):
    d = _load(NARROW_CLS[dtype])
    assert (int(d["embed_dim"]), int(d["num_heads"])) == (D, HEADS)
    assert tuple(d["counts"]) == fixture.NARROW_COUNTS and str(d["block_impl"]) == "fused"
    ref = fixture.jax_cls(dtype, "b16_narrow", block_impl="xla")
    if dtype == "float32":
        np.testing.assert_allclose(ref, d["cls"], rtol=0, atol=2e-5)
    else:
        g = d["cls"]
        cos = (ref * g).sum(-1) / (np.linalg.norm(ref, axis=-1) * np.linalg.norm(g, axis=-1))
        assert cos.min() >= 1 - 1e-4, cos
        assert np.abs(ref - g).max() <= 4 * 2.0 ** (np.floor(np.log2(np.abs(g).max())) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_on_cpu_matches_the_b16_narrow_cls_fixture(dtype):
    d = _load(NARROW_CLS[dtype])
    model = chada_vit(depth=int(d["depth"]), return_all_tokens=False,
                      img_size=int(d["img_size"]), embed_dim=int(d["embed_dim"]),
                      num_heads=int(d["num_heads"]), dtype=getattr(torch, dtype))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in fixture.port_state_dict("b16_narrow").items()})
    width = int(d["counts"].max())
    x, cc = collate_images(random_images(d["counts"].tolist(), int(d["img_size"]),
                                         int(d["image_seed"])), width)
    assert fused_block.jax_layer_fused(-(-(1 + 196 * width) // 128) * 128, D, FFN, HEADS,
                                       model.dtype)
    with torch.no_grad():
        out = model.eval()(x, cc).float().numpy()
    ref = d["cls"]
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    if dtype == "float32":
        assert cos.min() >= 1 - 1e-5, cos
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    else:
        top = np.abs(ref).max()
        assert cos.min() >= 1 - 1e-4, cos
        assert np.abs(out - ref).max() <= 4 * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_on_cpu_matches_the_b16_narrow_dino_fixture(dtype):
    d = _load(NARROW_DINO[dtype])
    assert (int(d["embed_dim"]), int(d["num_heads"]), int(d["num_prototypes"]),
            int(d["max_channels"]), str(d["block_impl"])) == (
        D, HEADS, fixture.B16_PROTOTYPES, 3, "fused")
    metric_rel, norm_rel, delta_rel = DINO_BOUNDS[dtype]
    spec = DinoPretrainSpec(**fixture.B16_NARROW_DINO_SPEC, dtype=getattr(torch, dtype))
    state, step, _, _ = build_dino(spec, device="cpu", seed=int(d["weight_seed"]))
    batch = synthetic_dino_batch(spec, len(d["counts"]), int(d["batch_seed"]),
                                 d["counts"].tolist(), device="cpu")
    assert batch["crops"].shape[2] == 3  # 640 rows: the fused route
    before = {n: p.detach().clone() for n, p in state.trainable()}
    for i in range(int(d["steps"])):
        state, m = step(state, batch)
        for k in fixture.DINO_METRICS:
            np.testing.assert_allclose(float(m[k]), d[k][i], rtol=metric_rel, err_msg=k)
    names = [str(n) for n in d["names"]]
    for side in ("student", "teacher"):
        sd = {f"{part}.{k}": v for part in ("backbone", "head")
              for k, v in getattr(state, side)[part].state_dict().items()}
        assert sorted(sd) == names
        norms = [sd[n].double().norm().item() for n in names]
        np.testing.assert_allclose(norms, d[f"{side}_norms"], rtol=norm_rel, err_msg=side)
        if side == "student":
            for i, n in enumerate(names):
                if n in before and d["student_delta_norms"][i] > 0:
                    delta = (sd[n] - before[n]).double().norm().item()
                    np.testing.assert_allclose(delta, d["student_delta_norms"][i],
                                               rtol=delta_rel, err_msg=n)
