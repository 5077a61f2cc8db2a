"""The port's projections and attention maps (``utils/auto_umap.py``,
``python -m chadavit_tpu_torch.main_umap`` and ``main_attn``) on the CPU,
against sklearn's t-SNE internals and the JAX package.

- The t-SNE: P within 1e-6 of sklearn's ``_joint_probabilities_nn`` on the
  same neighbours; the KL and its gradient at one embedding within 1e-5
  (relative to the gradient's largest entry) of ``_kl_divergence`` on that
  P; the final embedding of 120 points in 5 clusters scores a
  trustworthiness (k 5) within 0.02 of JAX's ``project_2d`` (sklearn's
  Barnes-Hut t-SNE), and the port's trustworthiness equals sklearn's.
- ``parse_umap_cfg`` / ``parse_attn_cfg`` give JAX's configs.
- ``main_attn`` from one ``.npz`` of JAX params (the port's seeded weights
  carried across): the head maps within 1e-5 of the JAX model's, the
  top-mass masks equal JAX's, the same files as the root ``main_attn.py``.
- ``main_umap --device cpu`` over 24 images of a manifest, through the C++
  eval loader, writes ``{name}_umap.png`` and ``.pdf`` where matplotlib
  imports; without ``--device`` and CUDA both entry points refuse to run.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chadavit_tpu.cli import load_backbone_for_eval as jax_load_backbone
from chadavit_tpu.config import load_yaml as jax_load_yaml
from chadavit_tpu.config import parse_attn_cfg as jax_parse_attn
from chadavit_tpu.config import parse_umap_cfg as jax_parse_umap
from chadavit_tpu.models.import_torch import chada_vit_params_from_torch
from chadavit_tpu.utils.auto_umap import project_2d as jax_project_2d
from chadavit_tpu_torch import main_attn, main_umap
from chadavit_tpu_torch.config import load_yaml, parse_attn_cfg, parse_umap_cfg
from chadavit_tpu_torch.models.chada_vit import chada_vit, random_state_dict
from chadavit_tpu_torch.utils import auto_umap

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # the JAX package's root entry points
    sys.path.insert(0, str(ROOT))
import main_attn as jax_main_attn  # noqa: E402

KNN_SMOKE = ROOT / "scripts" / "smoke" / "knn_synthetic.yaml"
N, DIM = 120, 32
ATTN_SIZE = 64  # a 4 x 4 patch grid
sklearn_tsne = pytest.importorskip("sklearn.manifold._t_sne")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: at these sizes eight are slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((5, DIM)) * 3
    return (centers[rng.integers(0, 5, N)] + rng.standard_normal((N, DIM))).astype(np.float32)


def test_tsne_p_matches_sklearn(points):
    from sklearn.neighbors import NearestNeighbors

    perplexity = auto_umap.perplexity_for(N)
    k = min(N - 1, int(3.0 * perplexity + 1))
    dist = NearestNeighbors(n_neighbors=k).fit(points).kneighbors_graph(mode="distance")
    dist.data **= 2
    want = sklearn_tsne._joint_probabilities_nn(dist, perplexity, 0).toarray()
    idx, val = auto_umap.joint_probabilities_nn(torch.from_numpy(points), perplexity)
    got = np.zeros((N, N))
    got[idx[0].numpy(), idx[1].numpy()] = val.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert abs(got.sum() - 1) < 1e-12


def test_tsne_kl_and_gradient_match_sklearn(points):
    from scipy.spatial.distance import squareform

    idx, val = auto_umap.joint_probabilities_nn(torch.from_numpy(points),
                                                auto_umap.perplexity_for(N))
    p = np.zeros((N, N))
    p[idx[0].numpy(), idx[1].numpy()] = val.numpy()
    y = np.random.default_rng(1).standard_normal((N, 2)).astype(np.float32)
    want_kl, want_grad = sklearn_tsne._kl_divergence(y.ravel(), squareform(p, checks=False),
                                                     1, N, 2)
    kl, grad = auto_umap.kl_divergence(torch.from_numpy(y), idx, val)
    assert abs(kl - want_kl) <= 1e-5 * abs(want_kl)
    np.testing.assert_allclose(grad.numpy().ravel(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())


def test_tsne_trustworthiness_is_jax_s(points):
    from sklearn.manifold import trustworthiness

    emb = auto_umap.tsne(points, device="cpu")
    assert emb.shape == (N, 2) and np.isfinite(emb).all()
    got = auto_umap.trustworthiness(points, emb, 5)
    assert got == pytest.approx(trustworthiness(points, emb, n_neighbors=5), abs=1e-12)
    want = trustworthiness(points, jax_project_2d(points, seed=5), n_neighbors=5)
    assert abs(got - want) <= 0.02, (got, want)


@pytest.mark.parametrize("parse, jax_parse", [(parse_umap_cfg, jax_parse_umap),
                                              (parse_attn_cfg, jax_parse_attn)])
def test_umap_and_attn_configs_match_jax(parse, jax_parse):
    got = parse(load_yaml(str(KNN_SMOKE)))
    want = jax_parse(jax_load_yaml(str(KNN_SMOKE)))
    assert got.to_dict() == want.to_dict()


@pytest.fixture(scope="module")
def attn_inputs(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("attn")
    img = d / "cell.png"
    Image.fromarray((np.random.default_rng(2).random((80, 72)) * 255).astype(np.uint8)).save(img)
    cfg = load_yaml(str(KNN_SMOKE))
    model = chada_vit(**{**cfg.backbone.kwargs, "img_size": ATTN_SIZE})
    sd = {k: v.numpy() for k, v in random_state_dict(model, 4).items()}
    flat = {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(
                chada_vit_params_from_torch(sd, depth=len(model.blocks)))[0]}
    npz = d / "backbone.npz"
    np.savez(npz, **flat)
    return d, img, npz


def test_main_attn_matches_jax(attn_inputs, tmp_path, monkeypatch):
    _, img, npz = attn_inputs
    monkeypatch.chdir(tmp_path)
    over = [f"image_path={img}", f"pretrained_feature_extractor={npz}", "threshold=0.6",
            f"image_size={ATTN_SIZE}", f"backbone.kwargs.img_size={ATTN_SIZE}"]
    argv = ["--config-path", str(KNN_SMOKE.parent), "--config-name", KNN_SMOKE.name]
    got = main_attn.main(argv + over + ["output_dir=port", "--device", "cpu"])
    jax_main_attn.main(argv + over + ["output_dir=jax"])
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert {Path(f).name for f in got["files"]} == {p.name for p in (tmp_path / "jax").iterdir()}

    # the JAX model's maps on the image as the root entry point prepares it
    cfg = jax_parse_attn(jax_load_yaml(str(KNN_SMOKE)))
    from chadavit_tpu.cli import apply_overrides as jax_apply

    jax_apply(cfg, over)
    model, params = jax_load_backbone(cfg)
    x = main_attn.load_image(str(img), ATTN_SIZE, 16)
    attn = np.asarray(jax.jit(lambda p, v: model.apply(
        {"params": p}, v, method="get_last_selfattention"))(
            params, jax.numpy.asarray(x)[None, None]))
    nh, g = attn.shape[1], ATTN_SIZE // 16
    cls_attn = attn[0, :, 0, 1:].reshape(nh, g, g)
    np.testing.assert_allclose(got["attention"], attn, rtol=0, atol=1e-5)
    for j in range(nh):
        np.testing.assert_allclose(got["maps"][j], np.kron(cls_attn[j], np.ones((16, 16))),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(
            got["masks"][j], np.kron(jax_main_attn._threshold_mask(cls_attn[j], 0.6),
                                     np.ones((16, 16))))


def test_main_umap_writes_its_files(tmp_path, monkeypatch):
    from chadavit_tpu_torch.data.disk_dataset import generate

    generate(str(tmp_path / "data"), 24, img_size=32, max_channels=4, num_classes=3, seed=1,
             workers=1, image_subdir="")
    monkeypatch.chdir(tmp_path)
    out = main_umap.main(["--config-path", str(KNN_SMOKE.parent), "--config-name",
                          KNN_SMOKE.name, "name=umap-smoke", "data.dataset=bbbc048",
                          f"data.train_path={tmp_path / 'data'}", "native_loader=true",
                          "--device", "cpu"])
    assert out["embedding"].shape == (24, 2) and np.isfinite(out["embedding"]).all()
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert out["written"] == []
        return
    assert out["written"] == ["umap-smoke_umap.png/.pdf"]
    assert all((tmp_path / f"umap-smoke_umap.{ext}").exists() for ext in ("png", "pdf"))


def test_entry_points_refuse_a_machine_without_cuda(monkeypatch, attn_inputs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--config-path", str(KNN_SMOKE.parent), "--config-name", KNN_SMOKE.name]
    for entry, extra in ((main_umap, []), (main_attn, [f"image_path={attn_inputs[1]}"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry.main(argv + extra)
