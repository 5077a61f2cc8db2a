"""The port's DINO pieces held against their JAX functions on the same numpy
values, on the CPU: the head (chadavit_tpu_torch/models/dino_head.py) and its
weight bridge, the loss and center (losses/dino.py), the schedules
(train/schedules.py), one LARS update with clip_lr, weight decay, the 1-D
exclusion, the nonzero guard and momentum (train/optim.py), the backbone
clip (train/dino_step.py), and the options that are not ported and raise.

Tolerance: float32 on both sides. Head and loss 1e-5 relative and absolute;
the schedules compute the same float32 arithmetic, 1e-7 relative; LARS 1e-6
relative on parameters of scale 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chadavit_tpu.losses.dino import dino_loss_and_center as jax_loss
from chadavit_tpu.losses.dino import teacher_temp_schedule as jax_teacher_temp
from chadavit_tpu.models.dino_head import DINOHead as JaxHead
from chadavit_tpu.models.import_torch import dino_head_params_from_torch
from chadavit_tpu.train import schedules as jax_sched
from chadavit_tpu.train.dino_step import _clip_backbone_grads as jax_clip
from chadavit_tpu.train.optim import build_group_tx as jax_group_tx
from chadavit_tpu.train.optim import wd_mask as jax_wd_mask
from chadavit_tpu_torch.losses.dino import dino_loss_and_center, teacher_temp_schedule
from chadavit_tpu_torch.models.chada_vit import ChAdaViT, EncoderLayer
from chadavit_tpu_torch.models.dino_head import DINOHead, random_head_state_dict
from chadavit_tpu_torch.models.import_torch import head_state_dict_from_jax_params
from chadavit_tpu_torch.train import schedules
from chadavit_tpu_torch.train.dino_step import (
    DinoStepConfig,
    _clip_backbone_grads,
    make_dino_eval_loss,
    make_dino_train_step,
)
from chadavit_tpu_torch.train.optim import build_group_tx, wd_mask
from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, build_dino, synthetic_dino_batch

TOL = dict(rtol=1e-5, atol=1e-5)
IN, HID, BOT, P = 24, 64, 16, 48


@pytest.mark.parametrize("num_layers", [1, 3])
def test_head_matches_jax(num_layers):
    head = DINOHead(IN, P, num_layers=num_layers, hidden_dim=HID, bottleneck_dim=BOT)
    sd = random_head_state_dict(head, seed=3)
    head.load_state_dict(sd)
    x = np.random.default_rng(4).standard_normal((5, IN)).astype(np.float32)
    params = dino_head_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                         num_layers=num_layers)
    ref = JaxHead(in_dim=IN, num_prototypes=P, num_layers=num_layers, hidden_dim=HID,
                  bottleneck_dim=BOT).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    # the bridge back from the JAX params is the identity on the state dict
    back = head_state_dict_from_jax_params(params)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy())


def test_head_prototype_scale_gets_no_gradient_under_norm_last_layer():
    head = DINOHead(IN, P, hidden_dim=HID, bottleneck_dim=BOT)
    assert head.last_layer.weight_g.shape == (P, 1)
    assert not head.last_layer.weight_g.requires_grad
    head(torch.randn(3, IN)).sum().backward()
    assert head.last_layer.weight_g.grad is None
    assert head.last_layer.weight_v.grad is not None
    free = DINOHead(IN, P, norm_last_layer=False, hidden_dim=HID, bottleneck_dim=BOT)
    free(torch.randn(3, IN)).sum().backward()
    assert free.last_layer.weight_g.grad is not None


@pytest.mark.parametrize("num_large_crops", [2, 3])
def test_loss_and_center_match_jax(num_large_crops):
    rng = np.random.default_rng(5)
    b = 4
    s = rng.standard_normal((num_large_crops * b, P)).astype(np.float32)
    t = rng.standard_normal((2 * b, P)).astype(np.float32)
    c = (0.1 * rng.standard_normal((1, P))).astype(np.float32)
    temp = 0.05
    ref_loss, ref_center = jax_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(c), temp,
                                    num_large_crops=num_large_crops)
    ref_grad = jax.grad(lambda s_: jax_loss(s_, jnp.asarray(t), jnp.asarray(c), temp,
                                            num_large_crops=num_large_crops)[0])(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_(True)
    loss, center = dino_loss_and_center(st, torch.from_numpy(t), torch.from_numpy(c), temp,
                                        num_large_crops=num_large_crops)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **TOL)
    np.testing.assert_allclose(center.numpy(), np.asarray(ref_center), **TOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(ref_grad), **TOL)


def test_schedules_match_jax():
    for e in range(6):
        for n in (0, 1, 4):
            assert teacher_temp_schedule(e, 0.04, 0.07, n) == pytest.approx(
                float(jax_teacher_temp(e, 0.04, 0.07, n)), rel=1e-7)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 140):
        for warm in (0, 1, 10):
            assert schedules.warmup_cosine_lr(step, 0.3, 100, warm, 3e-5, 1e-4) == \
                pytest.approx(float(jax_sched.warmup_cosine_lr(step, 0.3, 100, warm, 3e-5, 1e-4)),
                              rel=1e-7)
        assert schedules.cosine_tau(step, 100, 0.9995, 1.0) == pytest.approx(
            float(jax_sched.cosine_tau(step, 100, 0.9995, 1.0)), rel=1e-7)
        assert schedules.multistep_lr(step, 0.1, (10, 50), 0.5) == pytest.approx(
            float(jax_sched.multistep_lr(step, 0.1, (10, 50), 0.5)), rel=1e-7)
        assert schedules.exponential_lr(step, 0.1, 0.97) == pytest.approx(
            float(jax_sched.exponential_lr(step, 0.1, 0.97)), rel=1e-6)
    for name in ("warmup_cosine", "step", "exponential", "none", "reduce"):
        ours = schedules.make_lr_schedule(name, 0.2, 100, 10, 1e-3, 0.0, (30,), 0.5)
        theirs = jax_sched.make_lr_schedule(name, 0.2, 100, 10, 1e-3, 0.0, (30,), 0.5)
        for step in (0, 7, 30, 80):
            assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6)
    with pytest.raises(ValueError):
        schedules.make_lr_schedule("cyclic", 0.1, 10)


def test_plateau_scale_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8]
    ours = schedules.PlateauScale(patience=2, cooldown=1)
    theirs = jax_sched.PlateauScale(patience=2, cooldown=1)
    assert [ours.step(m) for m in metrics] == [theirs.step(m) for m in metrics]


def _lars_inputs():
    rng = np.random.default_rng(6)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32),
              "frozen": rng.standard_normal((4, 3)).astype(np.float32)}
    grads = [{"w": (0.01 * rng.standard_normal((6, 5))).astype(np.float32),
              "b": (0.1 * rng.standard_normal((5,))).astype(np.float32),
              "frozen": np.zeros((4, 3), np.float32)} for _ in range(2)]
    return params, grads


@pytest.mark.parametrize("clip_lr", [True, False])
def test_lars_two_updates_match_optax(clip_lr):
    params, grads = _lars_inputs()

    def sched(step):
        return 0.1 + 0.05 * step

    kw = dict(eta=0.02, momentum=0.9, clip_lr=clip_lr, exclude_bias_n_norm=True)
    jtx = jax_group_tx("lars", lambda c: 0.1 + 0.05 * c, 1e-2, kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tx = build_group_tx("lars", sched, 1e-2, kw)
    names = list(params)
    tp = [torch.from_numpy(params[n].copy()) for n in names]
    state = tx.init(tp)
    for g in grads:
        jup, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, jup)
        up, state = tx.update([torch.from_numpy(g[n]) for n in names], state, tp)
        for p, u in zip(tp, up):
            p.add_(u)
    for n, p in zip(names, tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-7,
                                   err_msg=n)
    np.testing.assert_array_equal(tp[2].numpy(), params["frozen"])  # the nonzero guard


def test_wd_mask_matches_jax():
    params, _ = _lars_inputs()
    names = list(params)
    ref = jax_wd_mask(params)
    assert wd_mask([torch.from_numpy(params[n]) for n in names]) == [ref[n] for n in names]
    assert wd_mask([torch.zeros(4, 1)], one_d=[True]) == [False]


def test_backbone_clip_matches_jax():
    rng = np.random.default_rng(7)
    grads = {"a": (5 * rng.standard_normal((4, 4))).astype(np.float32),
             "b": (0.1 * rng.standard_normal(7)).astype(np.float32)}
    ref = jax_clip(jax.tree_util.tree_map(jnp.asarray, grads), 3.0)
    out = _clip_backbone_grads([torch.from_numpy(grads[k]) for k in "ab"], 3.0)
    for k, o in zip("ab", out):
        np.testing.assert_allclose(o.numpy(), np.asarray(ref[k]), **TOL)


# ---- what is not ported raises -------------------------------------------------
@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_other_optimizers_raise(name):
    with pytest.raises(NotImplementedError):
        build_group_tx(name, lambda s: 0.1, 0.0)


@pytest.mark.parametrize("kwargs", [dict(mesh=object()), dict(fsdp=True)])
def test_build_dino_options_of_later_slices_raise(kwargs):
    with pytest.raises(NotImplementedError):
        build_dino(DinoPretrainSpec(), device="cpu", **kwargs)


@pytest.mark.parametrize("cfg", [DinoStepConfig(num_classes=10), DinoStepConfig(accumulate=2)])
def test_step_options_not_ported_raise(cfg):
    with pytest.raises(NotImplementedError):
        make_dino_train_step(None, None, None, cfg)
    with pytest.raises(NotImplementedError):
        make_dino_eval_loss(None, None, cfg)


def test_dropout_raises():
    with pytest.raises(NotImplementedError, match="dropout"):
        EncoderLayer(32, 2, 64, dropout_rate=0.1)
    with pytest.raises(NotImplementedError, match="dropout"):
        ChAdaViT(img_size=32, embed_dim=32, depth=2, drop_path_rate=0.1)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_dino(DinoPretrainSpec())
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_dino_batch(DinoPretrainSpec(img_size=32), 2)


def test_eval_loss_does_not_move_the_state():
    spec = DinoPretrainSpec(
        backbone_kwargs=dict(embed_dim=32, patch_size=16, return_all_tokens=False,
                             max_number_channels=2, depth=1, num_heads=2),
        img_size=32, max_channels=2, proj_hidden_dim=16, proj_output_dim=8,
        num_prototypes=16)
    state, _, model, head = build_dino(spec, device="cpu")
    cfg = DinoStepConfig(steps_per_epoch=1)
    loss = make_dino_eval_loss(lambda m, x, c: m(x, c), lambda h, f: h(f), cfg)(
        state, synthetic_dino_batch(spec, 3, device="cpu"))
    assert torch.isfinite(loss) and state.step == 0 and not state.center.any()
