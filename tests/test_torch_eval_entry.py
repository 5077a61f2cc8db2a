"""The port's evaluation entry points (``python -m chadavit_tpu_torch.main_knn``,
``main_linear``, ``main_regression``) on the CPU (``--device cpu``), on the
smoke YAMLs' model (D 64, depth 2, 32 px crops) over a CSV manifest of 32
train and 16 test PNG images of 1-4 channels written by the port's
generator (the bbbc048 / transloc dataset classes read it).

- ``main_knn`` of both packages from one ``.npz`` written from the JAX init
  (the JAX package's compact export format): the same CSV header and rows,
  each accuracy within one test image of JAX's.
- ``main_knn`` from a checkpoint of the port's pretrain loop: the run's
  ``args.json`` rebuilds the architecture over a wrong eval YAML, and the
  backbone is the student's.
- ``main_linear`` with epoch checkpoints and auto-resume: 2 steps (epoch 0),
  then a resumed run through epoch 1, ends in the straight run's probe state
  bit for bit (mixup and cutmix on, so the step's draws must repeat too).
- ``main_regression`` runs and reports its suite; without ``--device`` the
  entry points refuse a machine without CUDA.
"""

import csv
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chadavit_tpu.cli import load_backbone_for_eval as jax_load_backbone
from chadavit_tpu.config import load_yaml as jax_load_yaml
from chadavit_tpu.config import parse_knn_cfg as jax_parse_knn
from chadavit_tpu_torch import main_knn, main_linear, main_pretrain, main_regression
from chadavit_tpu_torch.data.disk_dataset import generate
from chadavit_tpu_torch.utils import checkpoint

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # the JAX package's root entry points
    sys.path.insert(0, str(ROOT))
import main_knn as jax_main_knn  # noqa: E402

SMOKE = ROOT / "scripts" / "smoke"
N_TRAIN, N_TEST = 32, 16


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: at these sizes eight are slower, alone and more so
    beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    root = tmp_path_factory.mktemp("manifest")
    generate(str(root), N_TRAIN + N_TEST, img_size=32, max_channels=4, num_classes=7,
             val_fraction=N_TEST / (N_TRAIN + N_TEST), seed=3, workers=1, image_subdir="")
    return root


def _data(root, dataset="bbbc048"):
    return [f"data.dataset={dataset}", f"data.train_path={root}", f"data.val_path={root}"]


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_main_knn_matches_jax_from_one_npz(tmp_path, monkeypatch, manifest):
    monkeypatch.chdir(tmp_path)
    cfg = jax_parse_knn(jax_load_yaml(str(SMOKE / "knn_synthetic.yaml")))
    _, params = jax_load_backbone(cfg)
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]}
    npz = tmp_path / "backbone.npz"
    np.savez(npz, **flat)
    argv = ["--config-path", str(SMOKE), "--config-name", "knn_synthetic",
            f"pretrained_feature_extractor={npz}", *_data(manifest)]
    jax_main_knn.main(argv + ["name=jax"])
    out = main_knn.main(argv + ["--device", "cpu", "name=port"])
    ref, mine = _csv(tmp_path / "jax_knn_offline_eval.csv"), _csv(out["csv"])
    assert mine[0] == ref[0] == main_knn.CSV_HEADER
    assert len(mine) == len(ref) == 3  # k in {1, 5}, cosine, one T
    assert [len(t) for t in out["targets"]] == [N_TRAIN, N_TEST]
    for r, m in zip(ref[1:], mine[1:]):
        assert m[:4] == r[:4]
        for a, b in zip(m[4:], r[4:]):
            assert abs(float(a) - float(b)) <= 100.0 / N_TEST + 1e-9, (m, r)
            assert 0.0 <= float(a) <= 100.0


def test_main_knn_rebuilds_the_model_from_a_port_checkpoint(tmp_path, monkeypatch, manifest):
    monkeypatch.chdir(tmp_path)
    main_pretrain.main(["--config-path", str(SMOKE), "--config-name", "dino_synthetic",
                        "--device", "cpu", "checkpoint.enabled=true",
                        f"checkpoint.dir={tmp_path}/ck", "data.size=32", "max_epochs=1",
                        "max_steps=2"])
    run_dir = next((tmp_path / "ck" / "dino").iterdir())
    ckpt = next(p for p in run_dir.iterdir() if "-ep=" in p.name)
    # a WRONG embed_dim in the eval YAML: the training run's args.json wins
    out = main_knn.main(["--config-path", str(SMOKE), "--config-name", "knn_synthetic",
                         "--device", "cpu", f"pretrained_feature_extractor={ckpt}",
                         "backbone.kwargs.embed_dim=999", "name=knn-args", *_data(manifest)])
    assert Path(out["csv"]).exists() and len(_csv(out["csv"])) == 3
    model = out["model"]
    assert model.embed_dim == 64 and not model.training
    saved = checkpoint.load_payload(str(ckpt))["student"]["backbone"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k


def _linear_argv(tmp_path, manifest, *extra):
    return ["--config-path", str(SMOKE), "--config-name", "linear_synthetic",
            "--device", "cpu", "checkpoint.enabled=true", "auto_resume.enabled=true",
            f"checkpoint.dir={tmp_path}/ckpts", "max_epochs=2", *_data(manifest),
            "mixup=0.8", "cutmix=1.0", "label_smoothing=0.1", *extra]


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


def _run_linear(argv):
    args = main_linear.parse_args(argv)
    cfg = main_linear.parse_linear_cfg(main_linear.load_cfg(args))
    return main_linear.run_probe(cfg, device=args.device)


def test_main_linear_resume_equals_the_straight_run(tmp_path, monkeypatch, capsys, manifest):
    monkeypatch.chdir(tmp_path)
    straight = _run_linear(_linear_argv(tmp_path / "a", manifest))
    assert straight.steps == 4 and all(np.isfinite(straight.losses))
    # 32 train images / 16 a batch: max_steps=2 ends exactly with epoch 0
    first = _run_linear(_linear_argv(tmp_path / "b", manifest, "max_steps=2"))
    assert first.steps == 2
    run_dir = next((tmp_path / "b" / "ckpts" / "linear").iterdir())
    assert any(p.name.endswith("-ep=0") for p in run_dir.iterdir())
    capsys.readouterr()
    resumed = _run_linear(_linear_argv(tmp_path / "b", manifest))
    assert "auto-resumed probe" in capsys.readouterr().out
    assert resumed.steps == 2 and resumed.losses == straight.losses[2:]
    a = checkpoint.state_to_dict(straight.state)
    b = checkpoint.state_to_dict(resumed.state)
    assert a["step"] == b["step"] == 4
    _assert_same(a, b)
    assert resumed.results == straight.results
    assert set(straight.results) >= {"acc1", "acc5", "precision", "recall", "f1"}
    assert (tmp_path / "linear-smoke_probe_logs.txt").exists()


def test_main_regression_runs(tmp_path, monkeypatch, manifest):
    monkeypatch.chdir(tmp_path)
    results = main_regression.main(["--config-path", str(SMOKE), "--config-name",
                                    "linear_synthetic", "--device", "cpu", "max_steps=2",
                                    "name=regression-smoke", *_data(manifest, "transloc")])
    assert set(results) == {"mse", "mae", "r2", "pearson"}
    assert all(np.isfinite(v) for v in results.values())
    assert (tmp_path / "regression-smoke_probe_logs.txt").exists()


@pytest.mark.parametrize("entry", [main_knn, main_linear, main_regression])
def test_entry_points_refuse_a_machine_without_cuda(entry, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    name = "knn_synthetic" if entry is main_knn else "linear_synthetic"
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.main(["--config-path", str(SMOKE), "--config-name", name])
