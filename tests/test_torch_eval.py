"""The port's offline evaluation (``chadavit_tpu_torch/eval``,
``data/classification.py``, the eval halves of ``config.py`` and ``cli.py``,
``train/optim.py``'s sgd/adam/adamw and parameter groups, ``ProbeState``)
held against the JAX package on the CPU, on inputs drawn with numpy.

- ``knn_classify``: top-1 and top-5 equal to JAX's, cosine and euclidean,
  several k and T, chunks smaller than the test set, and tied similarities
  and tied class scores (both rank as JAX's stable sorts).
- Features: ``make_feature_fn`` on a small ChAdaViT (D 32, depth 2, 32 px)
  whose JAX init is carried by ``state_dict_from_jax_params``, the CLS and the
  dense ``return_all_tokens`` paths; and a few images of 1-3 channels through
  the full-width study backbone (``studies/collapse_scale/checkpoints``),
  loaded by both packages' ``load_backbone_for_eval``. Bounds: phase 3's
  fixture bounds, per-row cosine >= 1 - 1e-5 and max abs 5e-4.
- The metric suites on the same logits; the config parsers on every kNN,
  linear and regression YAML, key by key.
- ``adam``, ``adamw`` and ``sgd`` for 3 steps against the optax chains on the
  same gradients (rel 1e-6); layer-decay scales and their scaling.
- 3 probe train steps against JAX's ``build_probe`` from the same backbone
  and classifier: classification with label smoothing, regression, finetune
  with layer decay (loss and classifier rel 1e-5, backbone update cosines
  >= 1 - 1e-5); in frozen mode the port's backbone is bit-equal after the
  steps while JAX's decays by 1 - lr*wd a step (the JAX behaviour recorded).
- ``mixup_cutmix`` fed JAX's draws, and ``cross_entropy``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chadavit_tpu.cli import load_backbone_for_eval as jax_load_backbone
from chadavit_tpu.config import Config as JaxConfig
from chadavit_tpu.config import load_yaml as jax_load_yaml
from chadavit_tpu.config import parse_knn_cfg as jax_parse_knn
from chadavit_tpu.config import parse_linear_cfg as jax_parse_linear
from chadavit_tpu.config import parse_regression_cfg as jax_parse_regression
from chadavit_tpu.eval import features as jax_features
from chadavit_tpu.eval import metrics as jax_metrics
from chadavit_tpu.eval import probe as jax_probe
from chadavit_tpu.eval.knn import knn_classify as jax_knn
from chadavit_tpu.train.optim import build_group_tx as jax_group_tx
from chadavit_tpu.train.optim import scale_updates_by_path as jax_scale_by_path
from chadavit_tpu_torch import config as port_config
from chadavit_tpu_torch.cli import load_backbone_for_eval
from chadavit_tpu_torch.eval import features, metrics, probe
from chadavit_tpu_torch.eval.knn import WeightedKNNClassifier, knn_classify
from chadavit_tpu_torch.main_linear import build_probe
from chadavit_tpu_torch.models.import_torch import (linear_state_dict_from_jax_params,
                                                    state_dict_from_jax_params)
from chadavit_tpu_torch.train.optim import (build_group_tx, chain, grouped_optimizer,
                                            label_params, scale_updates_by_path)

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # the JAX package's root entry points
    sys.path.insert(0, str(ROOT))
import main_linear as jax_main_linear  # noqa: E402

SMOKE = ROOT / "scripts" / "smoke"
STUDY_NPZ = ROOT / "studies" / "collapse_scale" / "checkpoints" / "idr10k_tau994_lrquarter_ep6.npz"
FIXTURE_COS = 1 - 1e-5
FIXTURE_TOL = 5e-4
OPT_REL = 1e-6
PROBE_REL = 1e-5
UPDATE_COS = 1 - 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: at these sizes eight are slower, alone and more so
    beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- kNN -------------------------------------------------------------------------
def _knn_inputs(seed=0, n_train=120, n_test=50, dim=16, classes=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_train, dim)).astype(np.float32),
            rng.integers(0, classes, n_train).astype(np.int32),
            rng.standard_normal((n_test, dim)).astype(np.float32),
            rng.integers(0, classes, n_test).astype(np.int32))


@pytest.mark.parametrize("distance,k,T", [("cosine", 1, 0.07), ("cosine", 5, 0.07),
                                          ("cosine", 20, 0.5), ("euclidean", 1, 0.07),
                                          ("euclidean", 10, 0.07)])
def test_knn_matches_jax(distance, k, T):
    tr_f, tr_t, te_f, te_t = _knn_inputs()
    # 1000 // 120 = 8 test rows a chunk: several chunks and a short last one
    kw = dict(k=k, T=T, distance_fx=distance, max_distance_matrix_size=1000)
    ref = jax_knn(tr_f, tr_t, te_f, te_t, **kw)
    assert knn_classify(tr_f, tr_t, te_f, te_t, device="cpu", **kw) == ref


@pytest.mark.parametrize("k", [1, 2, 3])
def test_knn_ties_rank_as_jax(k):
    """Each train vector three times, with three labels: equal similarities
    (the lower train index first) and equal class scores (the lower class
    first); one class (9) only among the queries widens the vote space."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((10, 8)).astype(np.float32)
    tr_f = np.repeat(base, 3, axis=0)
    tr_t = np.asarray([(i // 3 + 2 * (i % 3)) % 7 for i in range(30)], np.int32)
    te_f = base[[0, 3, 5, 7, 9]].copy()
    te_t = np.asarray([6, 4, 9, 0, 3], np.int32)
    for distance in ("cosine", "euclidean"):
        kw = dict(k=k, T=0.07, distance_fx=distance)
        ref = jax_knn(tr_f, tr_t, te_f, te_t, **kw)
        assert knn_classify(tr_f, tr_t, te_f, te_t, device="cpu", **kw) == ref, distance


def test_weighted_knn_classifier_accumulates():
    tr_f, tr_t, te_f, te_t = _knn_inputs(seed=1)
    clf = WeightedKNNClassifier(k=5, device="cpu")
    clf(train_features=torch.from_numpy(tr_f[:60]), train_targets=tr_t[:60])
    clf(train_features=tr_f[60:], train_targets=tr_t[60:], test_features=te_f,
        test_targets=te_t)
    assert clf.compute() == knn_classify(tr_f, tr_t, te_f, te_t, k=5, device="cpu")
    assert clf.compute() == (-1.0, -1.0)  # reset after compute


def test_knn_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        knn_classify(*_knn_inputs())


# ---- features -------------------------------------------------------------------
SMALL_BK = dict(embed_dim=32, patch_size=16, depth=2, num_heads=2, img_size=32,
                max_number_channels=4, return_all_tokens=False)


def _eval_cfgs(bk, ckpt="random-weights", img_channels=4):
    raw = {"backbone": {"name": "vit_channels", "kwargs": dict(bk)},
           "data": {"dataset": "synthetic", "img_channels": img_channels},
           "pretrained_feature_extractor": ckpt}
    return JaxConfig(raw), port_config._wrap(raw)


def _small_models(return_all_tokens=False):
    bk = dict(SMALL_BK, return_all_tokens=return_all_tokens)
    jcfg, pcfg = _eval_cfgs(bk)
    jmodel, jparams = jax_load_backbone(jcfg)
    pmodel = load_backbone_for_eval(pcfg, "cpu")
    pmodel.load_state_dict(state_dict_from_jax_params(jax.device_get(jparams)))
    return jmodel, jparams, pmodel


def _assert_rows_close(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    cos = (out * ref).sum(1) / (np.linalg.norm(out, axis=1) * np.linalg.norm(ref, axis=1))
    assert cos.min() >= FIXTURE_COS and np.abs(out - ref).max() <= FIXTURE_TOL, (
        cos.min(), np.abs(out - ref).max())


@pytest.mark.parametrize("dense", [False, True])
def test_feature_fn_matches_jax(dense):
    jmodel, jparams, pmodel = _small_models(return_all_tokens=dense)
    rng = np.random.default_rng(4)
    x = rng.random((4, 4, 32, 32), dtype=np.float32)
    # the dense path takes a fixed channel count; the CLS path mixed ones
    counts = np.full(4, 3, np.int32) if dense else np.asarray([4, 1, 2, 3], np.int32)
    for i, c in enumerate(counts):
        x[i, c:] = 0.0
    kw = dict(return_all_tokens=dense, mixed_channels=not dense, img_channels=3)
    ref = jax_features.make_feature_fn(jmodel, "multi_channels", **kw)(
        jparams, jnp.asarray(x), jnp.asarray(counts))
    fn = features.make_feature_fn(pmodel, "multi_channels", **kw)
    with torch.inference_mode():
        out = fn(pmodel, torch.from_numpy(x), torch.from_numpy(counts))
    assert out.shape == ref.shape == (4, 3 * 4 * 32 if dense else 32)
    _assert_rows_close(out.numpy(), np.asarray(ref))
    assert features.features_dim("multi_channels", 32, 4, 3, dense) == out.shape[1]


def test_one_channel_strategy_is_not_ported():
    _, _, pmodel = _small_models()
    with pytest.raises(NotImplementedError, match="channels_strategy"):
        features.make_feature_fn(pmodel, "one_channel")


def test_extract_features_matches_the_feature_fn():
    _, _, pmodel = _small_models()
    rng = np.random.default_rng(5)
    batches = []
    for b in range(3):
        x = rng.random((5, 4, 32, 32), dtype=np.float32)
        batches.append({"images": x, "channel_counts": np.full(5, 1 + b, np.int32),
                        "labels": np.arange(5, dtype=np.int32) + b})
    fn = features.make_feature_fn(pmodel, "multi_channels")
    feats, targets = features.extract_features(batches, fn, pmodel)
    with torch.inference_mode():
        ref = torch.cat([fn(pmodel, torch.from_numpy(b["images"]),
                            torch.from_numpy(b["channel_counts"])) for b in batches])
    np.testing.assert_array_equal(feats, ref.numpy())
    np.testing.assert_array_equal(targets, np.concatenate([b["labels"] for b in batches]))


def test_study_backbone_features_match_jax():
    """The full-width ChAdaViT-moyen of the collapse study (D 192, depth 12),
    its .npz loaded by both packages, on images of 1-3 channels."""
    bk = dict(embed_dim=192, patch_size=16, return_all_tokens=False, max_number_channels=10)
    jcfg, pcfg = _eval_cfgs(bk, ckpt=str(STUDY_NPZ), img_channels=10)
    jmodel, jparams = jax_load_backbone(jcfg)
    pmodel = load_backbone_for_eval(pcfg, "cpu")
    assert len(pmodel.blocks) == 12 and pmodel.embed_dim == 192
    counts = np.asarray([1, 3, 2], np.int32)
    x = np.random.default_rng(6).random((3, 3, 224, 224), dtype=np.float32)
    for i, c in enumerate(counts):
        x[i, c:] = 0.0
    ref = jmodel.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(counts))
    with torch.inference_mode():
        out = pmodel(torch.from_numpy(x), torch.from_numpy(counts))
    _assert_rows_close(out.numpy(), np.asarray(ref))


# ---- metrics and configs ---------------------------------------------------------
def test_metric_suites_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((40, 7)).astype(np.float32)
    targets = rng.integers(0, 6, 40)  # class 6 absent
    assert metrics.classification_suite(logits, targets, 7) == \
        jax_metrics.classification_suite(logits, targets, 7)
    np.testing.assert_array_equal(metrics.confusion_matrix(logits.argmax(1), targets, 7),
                                  jax_metrics.confusion_matrix(logits.argmax(1), targets, 7))
    preds, y = rng.standard_normal(40), rng.standard_normal(40)
    assert metrics.regression_suite(preds, y) == jax_metrics.regression_suite(preds, y)
    assert metrics.accuracy_at_k(logits, targets, (1, 3)) == \
        jax_metrics.accuracy_at_k(logits, targets, (1, 3))


EVAL_YAMLS = (sorted((ROOT / "scripts").glob("knn/*/*.yaml"))
              + sorted((ROOT / "scripts").glob("linear/*/*.yaml"))
              + sorted((ROOT / "scripts").glob("regression/*/*.yaml"))
              + [SMOKE / "knn_synthetic.yaml", SMOKE / "linear_synthetic.yaml"])
PARSERS = {"knn": (jax_parse_knn, port_config.parse_knn_cfg),
           "linear": (jax_parse_linear, port_config.parse_linear_cfg),
           "regression": (jax_parse_regression, port_config.parse_regression_cfg)}


def _kind(path: Path) -> str:
    return path.parent.parent.name if path.parent.name != "smoke" else path.stem.split("_")[0]


@pytest.mark.parametrize("path", EVAL_YAMLS, ids=lambda p: str(p.relative_to(ROOT)))
def test_eval_configs_parse_as_jax(path):
    jax_parse, port_parse = PARSERS[_kind(path)]
    ref = jax_parse(jax_load_yaml(str(path))).to_dict()
    out = port_parse(port_config.load_yaml(str(path))).to_dict()
    assert out == ref
    if _kind(path) == "linear":  # the regression skeleton on the linear YAMLs too
        ref = jax_parse_regression(jax_load_yaml(str(path))).to_dict()
        assert port_config.parse_regression_cfg(port_config.load_yaml(str(path))).to_dict() == ref


# ---- optimizers -------------------------------------------------------------------
def _opt_inputs(seed=8):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "v": rng.standard_normal((3, 4, 2)).astype(np.float32)}
    grads = [{k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


def _run_both(jtx, tx, params, grads, names=None):
    names = names or list(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tp = [torch.from_numpy(params[n].copy()) for n in names]
    state = tx.init(tp)
    for g in grads:
        jup, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, jup)
        up, state = tx.update([torch.from_numpy(g[n]) for n in names], state, tp)
        for p, u in zip(tp, up):
            p.add_(u)
    for n, p in zip(names, tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[n]), rtol=OPT_REL, atol=1e-7,
                                   err_msg=n)


def _sched(c):
    return 0.05 + 0.01 * c


@pytest.mark.parametrize("name,kw,wd,exclude", [
    ("adam", {}, 0.0, False), ("adam", {"betas": [0.8, 0.99]}, 0.05, False),
    ("adamw", {"betas": [0.9, 0.999]}, 0.1, False), ("adamw", {"eps": 1e-6}, 0.1, True),
    ("sgd", {"momentum": 0.9}, 0.01, False),
    ("sgd", {"momentum": 0.9, "nesterov": True}, 0.01, True),
    ("sgd", {}, 0.0, False)])
def test_optimizers_match_optax(name, kw, wd, exclude):
    params, grads = _opt_inputs()
    _run_both(jax_group_tx(name, _sched, wd, kw, exclude),
              build_group_tx(name, _sched, wd, kw, exclude), params, grads)


def test_layer_decay_scales_match_jax_by_name():
    """The port's backbone names against the JAX top-level keys they map to."""
    _, jparams, pmodel = _small_models()
    ref = jax_probe.layer_decay_scales(jparams, 0.75, 2)
    names = [n for n, _ in pmodel.named_parameters()]
    out = probe.layer_decay_scales(names, 0.75, 2)

    def jax_key(name):
        top, *rest = name.split(".")
        if top == "blocks":
            return f"blocks_{rest[0]}"
        return "patch_embed" if top == "token_learner" else top

    assert set(ref) == {jax_key(n) for n in names}
    assert out == {n: ref[jax_key(n)] for n in names}


def test_grouped_scaled_adamw_matches_optax():
    """Two groups, the backbone's chained with the layer-decay scaling, as the
    probes build them (``multi_transform`` over labels)."""
    params, grads = _opt_inputs(seed=9)
    scales = {"w": 0.5, "v": 0.25}
    jtx = optax.multi_transform(
        {"backbone": optax.chain(jax_group_tx("adamw", _sched, 0.1, {}),
                                 jax_scale_by_path(scales)),
         "classifier": jax_group_tx("adamw", lambda c: 0.2, 0.0, {})},
        {"w": "backbone", "v": "backbone", "b": "classifier"})
    names = ["w", "v", "b"]
    tx = grouped_optimizer(
        {"backbone": chain(build_group_tx("adamw", _sched, 0.1, {}),
                           scale_updates_by_path(scales, ["w", "v"])),
         "classifier": build_group_tx("adamw", lambda c: 0.2, 0.0, {})},
        label_params(names, {"b": "classifier"}))
    _run_both(jtx, tx, params, grads, names)


# ---- probe steps ------------------------------------------------------------------
def _probe_cfgs(overrides):
    from chadavit_tpu.cli import apply_overrides as jax_apply
    from chadavit_tpu_torch.cli import apply_overrides

    path = str(SMOKE / "linear_synthetic.yaml")
    base = ["backbone.kwargs.embed_dim=32", "max_epochs=3", *overrides]
    return (jax_parse_linear(jax_apply(jax_load_yaml(path), base)),
            port_config.parse_linear_cfg(apply_overrides(port_config.load_yaml(path), base)))


def _probe_batches(task, seed=10, n=3, b=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.random((b, 4, 32, 32), dtype=np.float32)
        counts = rng.integers(1, 5, b).astype(np.int32)
        for i, c in enumerate(counts):
            x[i, c:] = 0.0
        labels = (rng.random(b).astype(np.float32) * 3 if task == "regression"
                  else rng.integers(0, 7, b).astype(np.int32))
        out.append({"images": x, "channel_counts": counts, "labels": labels})
    return out


def _run_probes(overrides, task="classification"):
    """3 steps of both packages' build_probe from one backbone and
    classifier: (JAX params and losses per step, port state and losses)."""
    jcfg, pcfg = _probe_cfgs(overrides)
    jmodel, jparams = jax_load_backbone(jcfg)
    jstate, jstep, _ = jax_main_linear.build_probe(jcfg, jmodel, jparams, 4, task)
    pmodel = load_backbone_for_eval(pcfg, "cpu")
    pmodel.load_state_dict(state_dict_from_jax_params(jax.device_get(jparams)))
    pstate, pstep, _ = build_probe(pcfg, pmodel, 4, task)
    pstate.classifier.load_state_dict(
        linear_state_dict_from_jax_params(jax.device_get(jstate.classifier)))
    before = {n: p.detach().clone() for n, p in pstate.backbone.named_parameters()}
    jlosses, plosses = [], []
    rng = jax.random.PRNGKey(0)
    for batch in _probe_batches(task):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        pstate, pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        jlosses.append(float(jm["loss"]))
        plosses.append(float(pm["loss"]))
    return jax.device_get(jstate), jlosses, pstate, plosses, before, jparams


def _assert_classifier_close(jstate, pstate):
    ref = linear_state_dict_from_jax_params(jstate.classifier)
    for k, v in pstate.classifier.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=PROBE_REL, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("task,overrides", [
    ("classification", ["label_smoothing=0.1"]),
    ("regression", []),
])
def test_frozen_probe_steps_match_jax(task, overrides):
    jstate, jl, pstate, pl, before, _ = _run_probes(overrides, task)
    np.testing.assert_allclose(pl, jl, rtol=PROBE_REL)
    _assert_classifier_close(jstate, pstate)
    for n, p in pstate.backbone.named_parameters():
        assert torch.equal(p, before[n]), n


def _update_pieces(name, du, dr):
    """(piece name, port update, JAX update) of a parameter. The key third of
    ``in_proj_bias`` is left out: adding a constant to every key of a row
    leaves its softmax as it was, so that bias's gradient is zero in exact
    arithmetic and rounding noise in float32, which Adam's normalisation
    turns into updates of random sign on either side."""
    if not name.endswith("in_proj_bias"):
        return [(name, du, dr)]
    d = du.shape[0] // 3
    return [(name + "[q]", du[:d], dr[:d]), (name + "[v]", du[2 * d:], dr[2 * d:])]


def test_finetune_probe_with_layer_decay_matches_jax():
    jstate, jl, pstate, pl, before, jparams0 = _run_probes(
        ["finetune=true", "layer_decay=0.75", "optimizer.lr=0.05"])
    np.testing.assert_allclose(pl, jl, rtol=PROBE_REL)
    _assert_classifier_close(jstate, pstate)
    ref_after = state_dict_from_jax_params(jstate.backbone)
    ref_before = state_dict_from_jax_params(jax.device_get(jparams0))
    for n, p in pstate.backbone.named_parameters():
        du = (p.detach() - before[n]).double().flatten()
        dr = (ref_after[n] - ref_before[n]).double().flatten()
        for piece, u, r in _update_pieces(n, du, dr):
            assert u.any() and r.any(), piece  # a zero update fails
            cos = torch.nn.functional.cosine_similarity(u, r, 0).item()
            assert cos >= UPDATE_COS, (piece, cos)


def test_frozen_adamw_keeps_the_backbone_where_jax_decays_it():
    """The JAX probe puts the frozen backbone in the optimizer with zero
    gradients, so adamw's decay scales it by 1 - lr*wd a step; the port keeps
    it out of the optimizer (the reference's contract)."""
    lr, wd = 0.1, 0.1
    # the lr scaling rule: lr * batch_size / 256 with batch 16
    jstate, jl, pstate, pl, before, jparams0 = _run_probes(
        ["scheduler.name=none", f"optimizer.lr={lr * 256 / 16}", f"optimizer.weight_decay={wd}"])
    for n, p in pstate.backbone.named_parameters():
        assert torch.equal(p, before[n]), n
    ref0 = jax.tree_util.tree_leaves(jax.device_get(jparams0))
    ref3 = jax.tree_util.tree_leaves(jstate.backbone)
    for a, b in zip(ref0, ref3):
        np.testing.assert_allclose(b, a * (1 - lr * wd) ** 3, rtol=1e-6, atol=1e-9)
    assert abs(pl[0] / jl[0] - 1) <= PROBE_REL  # step 1: the same backbone on both sides


# ---- mixup and the loss -----------------------------------------------------------
def _jax_draws(rng, b, h, w, mixup_alpha, cutmix_alpha):
    """The draws of JAX's ``mixup_cutmix`` for ``rng``, as it takes them."""
    r_perm, r_lam, r_choice, r_box = jax.random.split(rng, 4)
    perm = np.asarray(jax.random.permutation(r_perm, b))
    use_cutmix = bool(cutmix_alpha > 0 and (mixup_alpha <= 0
                                            or bool(jax.random.bernoulli(r_choice, 0.5))))
    alpha = max(cutmix_alpha, 1e-8) if use_cutmix else max(mixup_alpha, 1e-8)
    lam = float(jax.random.beta(r_lam, alpha, alpha))
    cy = int(jax.random.randint(r_box, (), 0, h))
    cx = int(jax.random.randint(r_box, (), 0, w))
    return probe.MixupDraws(torch.from_numpy(perm.astype(np.int64)), use_cutmix, lam, cy, cx)


@pytest.mark.parametrize("mixup_alpha,cutmix_alpha,seed", [
    (0.8, 0.0, 0), (0.0, 1.0, 1), (0.8, 1.0, 2), (0.8, 1.0, 3)])
def test_mixup_cutmix_matches_jax_on_its_draws(mixup_alpha, cutmix_alpha, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((6, 3, 16, 16), dtype=np.float32)
    y = rng.integers(0, 5, 6).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    ref_x, ref_y = jax_probe.mixup_cutmix(key, jnp.asarray(x), jnp.asarray(y), 5,
                                          mixup_alpha, cutmix_alpha)
    draws = _jax_draws(key, 6, 16, 16, mixup_alpha, cutmix_alpha)
    out_x, out_y = probe.mixup_cutmix(torch.from_numpy(x), torch.from_numpy(y), 5, draws)
    np.testing.assert_allclose(out_x.numpy(), np.asarray(ref_x), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out_y.numpy(), np.asarray(ref_y), rtol=1e-6, atol=1e-7)


def test_mixup_draws_come_from_the_generator():
    a = probe.mixup_draws(torch.Generator().manual_seed(4), 8, 16, 16, 0.8, 1.0)
    b = probe.mixup_draws(torch.Generator().manual_seed(4), 8, 16, 16, 0.8, 1.0)
    assert torch.equal(a.perm, b.perm) and a[1:] == b[1:]
    assert sorted(a.perm.tolist()) == list(range(8)) and 0.0 <= a.lam <= 1.0


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((8, 5)).astype(np.float32)
    targets = rng.integers(-1, 5, 8).astype(np.int32)  # -1: ignored
    soft = rng.random((8, 5)).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    for t in (targets, soft):
        ref = jax_probe.cross_entropy(jnp.asarray(logits), jnp.asarray(t), smoothing, 5)
        out = probe.cross_entropy(torch.from_numpy(logits), torch.from_numpy(t), smoothing, 5)
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def _assert_same(a, b, where="state"):
    """Two :func:`checkpoint.state_to_dict` trees hold the same bits."""
    assert type(a) is type(b), where
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, (dict, list)):
        keys = list(a) if isinstance(a, dict) else range(len(a))
        assert len(a) == len(b) and (not isinstance(a, dict) or list(a) == list(b)), where
        for k in keys:
            _assert_same(a[k], b[k], f"{where}.{k}")
    else:
        assert a == b, where


def _stepped_probe(pcfg):
    state, step, _ = build_probe(pcfg, load_backbone_for_eval(pcfg, "cpu"), 4)
    batch = {k: torch.from_numpy(v) for k, v in _probe_batches("classification")[0].items()}
    return step(state, batch)[0]


def test_probe_checkpoint_round_trip(tmp_path):
    """A probe state's optimizer counts and moments survive save and load,
    in the layout the DINO state uses, and the loop's numbers ride along."""
    from chadavit_tpu_torch.utils import checkpoint

    _, pcfg = _probe_cfgs(["finetune=true", "layer_decay=0.75"])
    state = _stepped_probe(pcfg)
    checkpoint.save_state(str(tmp_path / "c"), state, {"lr_scale": 0.5, "epoch": 0})
    fresh, _, _ = build_probe(pcfg, load_backbone_for_eval(pcfg, "cpu"), 4)
    checkpoint.restore_state(str(tmp_path / "c"), fresh)
    a, b = checkpoint.state_to_dict(state), checkpoint.state_to_dict(fresh)
    assert a["step"] == b["step"] == 1
    assert set(a["opt_state"]) == {"backbone", "classifier"}
    assert set(a["opt_state"]["classifier"]) == {"count", "mu", "nu", "decay"}
    _assert_same(a, b)
    assert checkpoint.load_payload(str(tmp_path / "c"))["extra"] == {"lr_scale": 0.5,
                                                                    "epoch": 0}


@pytest.mark.parametrize("overrides", [["finetune=true"],  # other trained tensors
                                       ["optimizer.name=sgd"],  # other optimizer fields
                                       ["backbone.kwargs.depth=1"]])  # other shapes
def test_probe_checkpoint_of_another_config_is_refused(tmp_path, overrides):
    from chadavit_tpu_torch.utils import checkpoint

    _, pcfg = _probe_cfgs([])
    checkpoint.save_state(str(tmp_path / "c"), _stepped_probe(pcfg))
    _, other = _probe_cfgs(overrides)
    fresh, _, _ = build_probe(other, load_backbone_for_eval(other, "cpu"), 4)
    with pytest.raises(ValueError, match="not match this run"):
        checkpoint.restore_state(str(tmp_path / "c"), fresh)


def test_missing_checkpoint_path_raises():
    """Only ``random-weights`` (or no value) gives random weights: a path
    that does not exist is refused."""
    _, pcfg = _eval_cfgs(SMALL_BK, ckpt="/nonexistent/backbone.npz")
    with pytest.raises(FileNotFoundError, match="nonexistent"):
        load_backbone_for_eval(pcfg, "cpu")
    for ckpt in ("random-weights", None):
        _, pcfg = _eval_cfgs(SMALL_BK, ckpt=ckpt)
        assert load_backbone_for_eval(pcfg, "cpu").embed_dim == 32
