"""The port's on-device augmentation (``chadavit_tpu_torch/data/device_augment.py``)
against the JAX module on the CPU.

JAX draws from a key tree; the port from a ``torch.Generator``, or from
``draws`` it is handed. ``jax_draws`` rebuilds JAX's variates from the same
tree (``split(rng, n_views)`` in ``make_multicrop_fn``, ``split(key, 7)`` in
``DeviceAugmentPipeline.__call__``, and each op's own splits) and hands them
to the port, so both sides compute the same views from the same numbers.

Tolerance: float32 on both sides, the same products summed in other orders
(XLA's dot against torch's bmm) and ``exp``/``sqrt`` of other libraries, so a
crop box can move by an ulp: ``ATOL`` 2e-5 on [0, 1] images (readings up to
5.1e-6 over three seeds of each recipe), over the smallest std where a view
is normalized (every_op: 0.2, read 2.3e-5). Equalize, flip, solarize and the
[0, 1] conversion are exact.

Also the properties ``tests/test_device_augment.py`` holds for JAX: padded
planes stay exactly zero, the flip is exact, equalize equals the host op;
the port's own: one generator seed gives the same bits, and
``device=None`` refuses a machine without CUDA.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chadavit_tpu.data import device_augment as jda
from chadavit_tpu.data.transforms import Equalization as JaxEqualization
from chadavit_tpu_torch.data import device_augment as tda

ATOL = 2e-5
ASYMMETRIC_AUGS = [  # the root bench.py's recipe
    {"crop_size": 24, "num_crops": 1,
     "rrc": {"enabled": True, "crop_min_scale": 0.08, "crop_max_scale": 1.0},
     "color_jitter": {"prob": 0.8}, "grayscale": {"prob": 0.2},
     "gaussian_blur": {"prob": 1.0}, "solarization": {"prob": 0.0},
     "horizontal_flip": {"prob": 0.5}},
    {"crop_size": 24, "num_crops": 1,
     "rrc": {"enabled": True, "crop_min_scale": 0.08, "crop_max_scale": 1.0},
     "color_jitter": {"prob": 0.8}, "grayscale": {"prob": 0.2},
     "gaussian_blur": {"prob": 0.1}, "solarization": {"prob": 0.2},
     "horizontal_flip": {"prob": 0.5}},
]
# scripts/pretrain/dino_idr10k.yaml's augmentations
IDR10K_AUGS = [
    {"rrc": {"enabled": True, "crop_min_scale": 0.3, "crop_max_scale": 1.0},
     "color_jitter": {"prob": 0.8}, "grayscale": {"prob": 0.2},
     "gaussian_blur": {"prob": 1.0}, "horizontal_flip": {"prob": 0.5},
     "crop_size": 24, "num_crops": 1},
    {"rrc": {"enabled": True, "crop_min_scale": 0.3, "crop_max_scale": 1.0},
     "color_jitter": {"prob": 0.8}, "grayscale": {"prob": 0.2},
     "gaussian_blur": {"prob": 0.1}, "solarization": {"prob": 0.2},
     "horizontal_flip": {"prob": 0.5}, "crop_size": 24, "num_crops": 1},
]
# every op but equalize at once, a small view and the resize path (no RRC)
EVERY_OP = [
    {"crop_size": 24, "num_crops": 2,
     "rrc": {"enabled": True, "crop_min_scale": 0.3, "crop_max_scale": 1.0},
     "color_jitter": {"prob": 0.8}, "grayscale": {"prob": 0.5},
     "gaussian_blur": {"prob": 0.5}, "solarization": {"prob": 0.5},
     "horizontal_flip": {"prob": 0.5},
     "normalize": {"mean": [0.5, 0.4], "std": [0.2, 0.25]}},
    {"crop_size": 12, "num_crops": 1, "color_jitter": {"prob": 1.0},
     "gaussian_blur": {"prob": 1.0}},
]
# equalize looks its CDF up at floor(v * 255), a step function of its input:
# after a product an ulp moves a value across a bin edge (read: 4 of 34560
# entries one CDF step apart), so it is held in a view whose input is exact
EQUALIZE_VIEW = [
    {"crop_size": 32, "num_crops": 2, "equalization": {"prob": 0.5},
     "solarization": {"prob": 0.5}, "horizontal_flip": {"prob": 0.5},
     "normalize": {"mean": [0.5], "std": [0.25]}},
]
COUNTS = (1, 3, 5, 2, 4, 5)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_view_draws(pipe: jda.DeviceAugmentPipeline, key, b: int, c: int) -> dict:
    """JAX's variates of one view, in the port's ``draws`` layout."""
    keys = jax.random.split(key, 7)
    bern = lambda k, p: _t(jax.random.bernoulli(k, p, (b, 1, 1, 1)).reshape(b))  # noqa: E731
    out = {}
    if pipe.rrc_enabled:
        r_area, r_ratio, r_y, r_x = jax.random.split(keys[0], 4)
        s0, s1 = pipe.rrc_scale
        out["rrc"] = {
            "scale": _t(jax.random.uniform(r_area, (b,), minval=s0, maxval=s1)),
            "log_ratio": _t(jax.random.uniform(r_ratio, (b,), minval=jnp.log(3 / 4),
                                               maxval=jnp.log(4 / 3))),
            "u_y": _t(jax.random.uniform(r_y, (b,))), "u_x": _t(jax.random.uniform(r_x, (b,)))}
    if pipe.cj:
        r_apply, r_shift, r_gamma = jax.random.split(keys[1], 3)
        out["color_jitter"] = {
            "apply": bern(r_apply, pipe.cj),
            "shift": _t(jax.random.uniform(r_shift, (b, c, 1, 1), minval=-0.3,
                                           maxval=0.3).reshape(b, c)),
            "gamma": _t(jax.random.uniform(r_gamma, (b, c, 1, 1), minval=0.5,
                                           maxval=1.5).reshape(b, c))}
    if pipe.gray:
        out["grayscale"] = {"apply": bern(keys[2], pipe.gray)}
    if pipe.blur:
        r_apply, r_sigma = jax.random.split(keys[3])
        out["gaussian_blur"] = {"apply": bern(r_apply, pipe.blur),
                                "sigma": _t(jax.random.uniform(r_sigma, (b,), minval=0.1,
                                                               maxval=2.0))}
    if pipe.sol:
        out["solarization"] = {"apply": bern(keys[4], pipe.sol)}
    if pipe.eq:
        out["equalization"] = {"apply": bern(keys[6], pipe.eq)}
    if pipe.flip:
        out["horizontal_flip"] = {"apply": bern(keys[5], pipe.flip)}
    return out


def jax_draws(aug_cfgs, rng, b: int, c: int) -> list:
    """The draws of every view of JAX ``make_multicrop_fn(aug_cfgs)(rng, ...)``."""
    pipes = []
    for cfg in aug_cfgs:
        pipes.extend([jda.DeviceAugmentPipeline(cfg)] * cfg.get("num_crops", 1))
    keys = jax.random.split(rng, len(pipes))
    return [jax_view_draws(p, k, b, c) for p, k in zip(pipes, keys)]


def _raw_batch(seed, dtype=np.uint8, counts=COUNTS, c=5, hw=(32, 40)):
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    imgs = rng.integers(0, top + 1, (len(counts), c) + hw).astype(dtype)
    counts = np.asarray(counts, np.int32)
    for i, k in enumerate(counts):
        imgs[i, k:] = 0
    return imgs, counts


def _unit_batch(seed, counts=COUNTS, c=5, hw=(32, 32)):
    rng = np.random.default_rng(seed)
    imgs = rng.random((len(counts), c) + hw).astype(np.float32)
    counts = np.asarray(counts, np.int32)
    for i, k in enumerate(counts):
        imgs[i, k:] = 0.0
    return imgs, counts


def _draws_of(op, key, b, c, **cfg):
    """JAX's draws of one op, for a pipeline that runs that op alone."""
    pipe = jda.DeviceAugmentPipeline({"crop_size": 16, op: cfg})
    return jax_view_draws(pipe, key, b, c)[op]


# ---- op by op ----------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_random_resized_crop_matches_jax(seed):
    imgs, _ = _unit_batch(seed)
    key = jax.random.PRNGKey(seed)
    want = jda.random_resized_crop(jax.random.split(key, 7)[0], jnp.asarray(imgs), 16,
                                   scale=(0.3, 1.0))
    d = _draws_of("rrc", key, len(imgs), imgs.shape[1], enabled=True, crop_min_scale=0.3,
                  crop_max_scale=1.0)
    got = tda.random_resized_crop(_t(imgs), 16, d)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw, size", [((32, 40), 16), ((12, 20), 24), ((24, 24), 24)])
def test_resize_matches_jax_image_resize(hw, size):
    """Down (antialiased), up and identity, on a non-square input."""
    imgs, _ = _unit_batch(2, hw=hw)
    want = jda.resize(jnp.asarray(imgs), size)
    got = tda.resize(_t(imgs), size)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)


def test_color_jitter_matches_jax():
    imgs, cc = _unit_batch(3)
    key = jax.random.PRNGKey(3)
    want = jda.color_jitter(jax.random.split(key, 7)[1], jnp.asarray(imgs), p=0.8,
                            channel_counts=jnp.asarray(cc))
    d = _draws_of("color_jitter", key, len(imgs), imgs.shape[1], prob=0.8)
    got = tda.color_jitter(_t(imgs), d, _t(cc))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    for i, k in enumerate(cc):
        assert (got[i, k:] == 0).all()


def test_to_gray_matches_jax():
    imgs, cc = _unit_batch(4)
    key = jax.random.PRNGKey(4)
    want = jda.to_gray(jax.random.split(key, 7)[2], jnp.asarray(imgs), jnp.asarray(cc), p=0.5)
    d = _draws_of("grayscale", key, len(imgs), imgs.shape[1], prob=0.5)
    got = tda.to_gray(_t(imgs), d, _t(cc))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [5, 6])
def test_gaussian_blur_matches_jax(seed):
    imgs, _ = _unit_batch(seed, hw=(20, 28))
    key = jax.random.PRNGKey(seed)
    want = jda.gaussian_blur(jax.random.split(key, 7)[3], jnp.asarray(imgs), p=0.7)
    d = _draws_of("gaussian_blur", key, len(imgs), imgs.shape[1], prob=0.7)
    got = tda.gaussian_blur(_t(imgs), d)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)


def test_solarize_flip_equalize_match_jax_exactly():
    imgs, cc = _unit_batch(7)
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, 7)
    b, c = imgs.shape[:2]
    pairs = [
        (jda.solarize(keys[4], jnp.asarray(imgs), p=0.5),
         tda.solarize(_t(imgs), _draws_of("solarization", key, b, c, prob=0.5))),
        (jda.horizontal_flip(keys[5], jnp.asarray(imgs), p=0.5),
         tda.horizontal_flip(_t(imgs), _draws_of("horizontal_flip", key, b, c, prob=0.5))),
        (jda.equalize(keys[6], jnp.asarray(imgs), jnp.asarray(cc), p=0.5),
         tda.equalize(_t(imgs), _draws_of("equalization", key, b, c, prob=0.5), _t(cc))),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), _np(want))


def test_normalize_matches_jax():
    imgs, _ = _unit_batch(8)
    want = jda.normalize(jnp.asarray(imgs), [0.5, 0.4], [0.2, 0.25])
    got = tda.normalize(_t(imgs), [0.5, 0.4], [0.2, 0.25])
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=0)


# ---- the whole multicrop -------------------------------------------------------
@pytest.mark.parametrize("recipe", ["idr10k", "asymmetric", "every_op"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_multicrop_matches_jax(recipe, dtype):
    """make_multicrop_fn on a raw integer batch, real probabilities, JAX's
    draws: the views, the small views and the counts."""
    augs = {"idr10k": IDR10K_AUGS, "asymmetric": ASYMMETRIC_AUGS, "every_op": EVERY_OP}[recipe]
    imgs, cc = _raw_batch(9, dtype)
    rng = jax.random.PRNGKey(11)
    want = jda.make_multicrop_fn(augs)(rng, jnp.asarray(imgs), jnp.asarray(cc))
    draws = jax_draws(augs, rng, *imgs.shape[:2])
    got = tda.make_multicrop_fn(augs, device="cpu")(_t(imgs), _t(cc), draws=draws)
    tol = ATOL / 0.2 if recipe == "every_op" else ATOL
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), atol=tol, rtol=0, err_msg=k)
    if recipe != "every_op":  # normalize moves zero planes to -mean / std
        for i, k in enumerate(cc):  # padded planes exactly zero in every view
            assert (got["crops"][:, i, k:] == 0).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_multicrop_equalize_matches_jax(dtype):
    imgs, cc = _raw_batch(19, dtype, hw=(32, 32))
    rng = jax.random.PRNGKey(5)
    want = jda.make_multicrop_fn(EQUALIZE_VIEW)(rng, jnp.asarray(imgs), jnp.asarray(cc))
    draws = jax_draws(EQUALIZE_VIEW, rng, *imgs.shape[:2])
    assert any(bool(v["equalization"]["apply"].any()) for v in draws)
    got = tda.make_multicrop_fn(EQUALIZE_VIEW, device="cpu")(_t(imgs), _t(cc), draws=draws)
    np.testing.assert_allclose(got["crops"].numpy(), _np(want["crops"]), atol=1e-6, rtol=0)


def test_uint8_and_uint16_convert_on_the_device_side():
    imgs8, cc = _raw_batch(10, np.uint8)
    imgs16, _ = _raw_batch(10, np.uint16)
    for imgs, top in ((imgs8, 255.0), (imgs16, 65535.0)):
        got = tda.to_unit(_t(imgs), torch.float32)
        want = jnp.asarray(imgs).astype(jnp.float32) * (1.0 / top)
        np.testing.assert_array_equal(got.numpy(), _np(want))


# ---- properties ------------------------------------------------------------------
def test_padding_stays_exactly_zero_under_the_generator():
    imgs, cc = _raw_batch(12)
    every = {k: v for k, v in EVERY_OP[0].items() if k != "normalize"}
    fn = tda.make_multicrop_fn([dict(every, equalization={"prob": 0.5})], device="cpu")
    out = fn(_t(imgs), _t(cc), generator=torch.Generator().manual_seed(3))
    for i, k in enumerate(cc):
        assert (out["crops"][:, i, k:] == 0).all(), i


def test_flip_is_exact():
    imgs, _ = _unit_batch(13)
    d = {"apply": torch.ones(len(imgs), dtype=torch.bool)}
    np.testing.assert_array_equal(tda.horizontal_flip(_t(imgs), d).numpy(), imgs[..., ::-1])


def test_equalize_matches_the_host_op():
    """Device equalization equals JAX's host transforms.Equalization on the
    real channels, zero on padded planes (as tests/test_device_augment.py)."""
    imgs, cc = _unit_batch(14)
    d = {"apply": torch.ones(len(imgs), dtype=torch.bool)}
    out = tda.equalize(_t(imgs), d, _t(cc)).numpy()

    class _Always:
        def random(self):
            return 0.0

    host = JaxEqualization(p=1.0)
    for i, k in enumerate(cc):
        want = np.moveaxis(host(np.moveaxis(imgs[i, :k], 0, -1), _Always()), -1, 0)
        np.testing.assert_allclose(out[i, :k], want, atol=1e-6)
        assert (out[i, k:] == 0).all()


def test_one_seed_gives_the_same_bits_and_another_seed_other_views():
    imgs, cc = _raw_batch(15)
    fn = tda.make_multicrop_fn(ASYMMETRIC_AUGS, device="cpu")
    a, b, c = (fn(_t(imgs), _t(cc), generator=tda.aug_generator(1, step, "cpu"))["crops"]
               for step in (7, 7, 8))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])  # the two views draw independently


def test_bf16_views_stay_near_float32():
    imgs, cc = _raw_batch(16)
    draws = jax_draws(IDR10K_AUGS, jax.random.PRNGKey(2), *imgs.shape[:2])
    f32 = tda.make_multicrop_fn(IDR10K_AUGS, device="cpu")(_t(imgs), _t(cc), draws=draws)
    b16 = tda.make_multicrop_fn(IDR10K_AUGS, torch.bfloat16, device="cpu")(
        _t(imgs), _t(cc), draws=draws)
    assert b16["crops"].dtype == torch.bfloat16
    # a view of [0, 1] values through two bf16 products: a few bf16 steps at 1
    assert (b16["crops"].float() - f32["crops"]).abs().max() <= 4 * 2.0 ** -8


def test_exactly_one_source_of_randomness_and_no_card_raises(monkeypatch):
    imgs, cc = _raw_batch(17)
    fn = tda.make_multicrop_fn(ASYMMETRIC_AUGS, device="cpu")
    with pytest.raises(ValueError):
        fn(_t(imgs), _t(cc))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tda.make_multicrop_fn(ASYMMETRIC_AUGS)


# ---- the fused step --------------------------------------------------------------
TINY_AUGS = [dict(a, crop_size=32) for a in IDR10K_AUGS]
FUSED_STEPS = 2
METRICS = ("dino_loss", "lr", "tau", "teacher_temp", "teacher_entropy", "center_norm",
           "epoch")


def _tiny_raw_batch(seed):
    return _raw_batch(seed, counts=(1, 4, 2, 3, 4, 1, 2, 3), c=4, hw=(40, 40))


def test_fused_step_equals_the_plain_step_fed_the_same_crops():
    """build_dino(device_augmentations=...) on a raw batch: bit for bit the
    plain step on make_multicrop_fn's crops of the same draws."""
    from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, build_dino
    from tests.test_train_step import TINY

    spec = DinoPretrainSpec(**TINY)
    fstate, fused, _, _ = build_dino(spec, device="cpu", device_augmentations=TINY_AUGS)
    pstate, plain, _, _ = build_dino(spec, device="cpu")
    aug = tda.make_multicrop_fn(TINY_AUGS, device="cpu")
    for step in range(FUSED_STEPS):
        imgs, cc = _tiny_raw_batch(20 + step)
        draws = jax_draws(TINY_AUGS, jax.random.PRNGKey(step), *imgs.shape[:2])
        fstate, fm = fused(fstate, {"images": _t(imgs), "channel_counts": _t(cc),
                                    "draws": draws})
        crops = aug(_t(imgs), _t(cc), draws=draws)
        pstate, pm = plain(pstate, {"crops": crops["crops"],
                                    "channel_counts": crops["channel_counts"]})
        assert {k: float(v) for k, v in fm.items()} == {k: float(v) for k, v in pm.items()}
    for (n, a), (_, b) in zip(fstate.trainable(), pstate.trainable()):
        assert torch.equal(a, b), n


def test_fused_step_matches_the_jax_fused_step():
    """The slice as a whole: the port's fused step fed JAX's draws against
    JAX ``build_dino(device_augmentations=...)`` on the same raw batches,
    from JAX's initial parameters; the tolerance of
    tests/test_torch_train_step.py (relative 1e-4 on every metric)."""
    from chadavit_tpu.parallel.mesh import make_mesh
    from chadavit_tpu.train.pretrain import DinoPretrainSpec as JaxSpec
    from chadavit_tpu.train.pretrain import build_dino as jax_build_dino
    from chadavit_tpu_torch.models.import_torch import (
        head_state_dict_from_jax_params,
        state_dict_from_jax_params,
    )
    from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, build_dino
    from tests.test_train_step import TINY

    mesh = make_mesh(n_model=1, devices=jax.devices()[:1])
    jstate, jstep, _, _ = jax_build_dino(JaxSpec(**TINY), mesh=mesh, rng=jax.random.PRNGKey(0),
                                         device_augmentations=TINY_AUGS)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate.student))
    initial = {"backbone": state_dict_from_jax_params(params["backbone"]),
               "head": head_state_dict_from_jax_params(params["head"])}
    state, step, _, _ = build_dino(DinoPretrainSpec(**TINY), device="cpu",
                                   device_augmentations=TINY_AUGS)
    for part in ("backbone", "head"):
        state.student[part].load_state_dict(initial[part])
        state.teacher[part].load_state_dict(initial[part])
    for i in range(FUSED_STEPS):
        imgs, cc = _tiny_raw_batch(30 + i)
        rng = jax.random.PRNGKey(100 + i)
        jstate, jm = jstep(jstate, {"images": jnp.asarray(imgs), "channel_counts": jnp.asarray(cc),
                                    "rng": rng})
        state, m = step(state, {"images": _t(imgs), "channel_counts": _t(cc),
                                "draws": jax_draws(TINY_AUGS, rng, *imgs.shape[:2])})
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i + 1} {k}")
