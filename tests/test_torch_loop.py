"""The port's pretrain entry point (``train/loop.py::run_dino_pretrain``,
``main_pretrain.py``) on the CPU, on ``scripts/smoke/dino_synthetic.yaml``.

- Exact-step resume: 2 steps with a mid-epoch checkpoint, then an
  auto-resumed run to step 4, log the same metrics for steps 3-4 and end in
  the same train state as 4 steps straight, bit for bit.
- ``args.json`` carries the 12 ``SHOULD_MATCH`` keys, as the JAX
  ``Checkpointer`` writes them.
- Each config key the port does not honour yet raises, naming the key; no
  device and no CUDA raises. The validation keys (``knn_eval``,
  ``auto_umap``) run: one epoch logs the online kNN, or writes the epoch's
  UMAP.
- The JAX loop fixture (``tests/torch_port_loop_fixture.py``): the port's
  loop, started from the JAX loop's initial state through its own checkpoint
  restore, logs the JAX loop's metrics for 3 steps, float32 on both sides, to
  a relative 1e-5 (read 1.8e-6, teacher_entropy: summation order only).
- The command line with ``--device cpu``, and the SIGUSR1 preemption hook.
"""

import json
import os
import signal
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from chadavit_tpu.utils.checkpoint import SHOULD_MATCH as JAX_SHOULD_MATCH
from chadavit_tpu_torch import main_pretrain
from chadavit_tpu_torch.cli import apply_overrides
from chadavit_tpu_torch.config import load_yaml, parse_pretrain_cfg
from chadavit_tpu_torch.train import loop
from chadavit_tpu_torch.train.pretrain import build_dino
from chadavit_tpu_torch.utils import checkpoint
from tests import torch_port_loop_fixture as fixture

SMOKE = Path(__file__).resolve().parent.parent / "scripts" / "smoke"
RESUME = ["data.size=64", "max_epochs=1", "log_every=1", "seed=3",
          "checkpoint.enabled=true", "auto_resume.enabled=true"]
FIXTURE_REL = 1e-5


def _cfg(overrides):
    return parse_pretrain_cfg(apply_overrides(load_yaml(str(SMOKE / "dino_synthetic.yaml")),
                                              overrides))


def _run_dir(base):
    (run,) = [p for p in (Path(base) / "dino").iterdir() if p.is_dir()]
    return run


def _logs(run_dir):
    with open(run_dir / "training_logs.txt") as f:
        return {r["step"]: r for r in map(json.loads, f)}


def _final_state(run_dir):
    (ckpt,) = [p for p in run_dir.iterdir() if p.is_dir()]
    return torch.load(ckpt / checkpoint.STATE_FILE, weights_only=True)


def _assert_states_equal(a, b, where="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_states_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_states_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_resume_equals_the_straight_run_bit_for_bit(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    straight = loop.run_dino_pretrain(_cfg(RESUME + [f"checkpoint.dir={tmp_path}/a"]),
                                      device="cpu")
    part = RESUME + [f"checkpoint.dir={tmp_path}/b", "checkpoint.step_frequency=1"]
    loop.run_dino_pretrain(_cfg(part), max_steps=2, device="cpu")
    capsys.readouterr()
    resumed = loop.run_dino_pretrain(_cfg(part), device="cpu")
    assert "auto-resumed" in capsys.readouterr().out
    assert resumed == straight
    a, b = _logs(_run_dir(tmp_path / "a")), _logs(_run_dir(tmp_path / "b"))
    assert sorted(a) == sorted(b) == [1, 2, 3, 4]
    for step in (3, 4):
        for k in fixture.METRICS:
            assert a[step][k] == b[step][k], (step, k)
    sa, sb = _final_state(_run_dir(tmp_path / "a")), _final_state(_run_dir(tmp_path / "b"))
    assert sa["step"] == sb["step"] == 4
    _assert_states_equal(sa, sb)


def test_device_augmentation_resume_equals_the_straight_run_bit_for_bit(tmp_path, monkeypatch,
                                                                       capsys):
    """device_augmentations: true, the raw loader and the views drawn in the
    step from the step's own generator: an exact-step resume draws the same
    views, so its metrics and final state equal the straight run's."""
    monkeypatch.chdir(tmp_path)
    dev_augs = RESUME + ["device_augmentations=true"]
    straight = loop.run_dino_pretrain(_cfg(dev_augs + [f"checkpoint.dir={tmp_path}/a"]),
                                      device="cpu")
    part = dev_augs + [f"checkpoint.dir={tmp_path}/b", "checkpoint.step_frequency=1"]
    loop.run_dino_pretrain(_cfg(part), max_steps=2, device="cpu")
    capsys.readouterr()
    resumed = loop.run_dino_pretrain(_cfg(part), device="cpu")
    assert "auto-resumed" in capsys.readouterr().out
    assert resumed == straight
    a, b = _logs(_run_dir(tmp_path / "a")), _logs(_run_dir(tmp_path / "b"))
    assert sorted(a) == sorted(b) == [1, 2, 3, 4]
    for step in (3, 4):
        for k in fixture.METRICS:
            assert a[step][k] == b[step][k], (step, k)
    sa, sb = _final_state(_run_dir(tmp_path / "a")), _final_state(_run_dir(tmp_path / "b"))
    assert sa["step"] == sb["step"] == 4
    _assert_states_equal(sa, sb)
    # and the views differ from the host multicrop run's: the step drew its own
    host = loop.run_dino_pretrain(_cfg(RESUME + [f"checkpoint.dir={tmp_path}/h"]), device="cpu")
    assert host["dino_loss"] != straight["dino_loss"]


def test_device_augmentation_step_feeds_raw_planes(tmp_path, monkeypatch):
    """The loop hands the step the loader's raw planes, unconverted, and a
    generator of the step's index."""
    monkeypatch.chdir(tmp_path)  # the metric log lands in the working directory
    seen = []
    real = loop.build_dino

    def spy_build(*args, **kwargs):
        state, step, model, head = real(*args, **kwargs)

        def spy(st, batch):
            seen.append((batch["images"].dtype, batch["generator"].initial_seed()))
            return step(st, batch)
        return state, spy, model, head

    monkeypatch.setattr(loop, "build_dino", spy_build)
    cfg = _cfg(["data.size=32", "device_augmentations=true", "seed=3"])
    loop.run_dino_pretrain(cfg, max_steps=2, device="cpu")
    from chadavit_tpu_torch.data.device_augment import aug_generator

    assert [s for _, s in seen] == [aug_generator(3 + 1, g, "cpu").initial_seed()
                                    for g in range(2)]
    assert all(dt == torch.float32 for dt, _ in seen)  # SyntheticChannels' float planes


def test_args_json_carries_the_should_match_keys(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from chadavit_tpu.config import load_yaml as jax_load_yaml
    from chadavit_tpu.config import parse_pretrain_cfg as jax_parse
    from chadavit_tpu.cli import apply_overrides as jax_apply
    from chadavit_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer

    overrides = RESUME + [f"checkpoint.dir={tmp_path}/p"]
    cfg = _cfg(overrides)
    loop.run_dino_pretrain(cfg, max_steps=1, device="cpu")
    with open(_run_dir(tmp_path / "p") / "args.json") as f:
        got = json.load(f)
    assert checkpoint.SHOULD_MATCH == JAX_SHOULD_MATCH and len(JAX_SHOULD_MATCH) == 12
    for key in checkpoint.SHOULD_MATCH:
        assert checkpoint._get_dotted(got, key) == checkpoint._get_dotted(cfg.to_dict(), key)
    jax_cfg = jax_parse(jax_apply(jax_load_yaml(str(SMOKE / "dino_synthetic.yaml")),
                                  RESUME + [f"checkpoint.dir={tmp_path}/j"]))
    ref = JaxCheckpointer(jax_cfg, base_dir=f"{tmp_path}/j")
    with open(ref.path / "args.json") as f:
        want = json.load(f)
    for d in (got, want):
        d.pop("wandb_run_id")
        d["checkpoint"].pop("dir")
    assert got == want


@pytest.mark.parametrize("override, key", [
    ("model_parallel=2", "model_parallel"),
    ("fsdp=true", "fsdp"),
    ("devices=[0,1]", "devices"),
    ("devices=2", "devices"),
    ("num_nodes=2", "num_nodes"),
])
def test_each_unported_key_raises(override, key):
    with pytest.raises(NotImplementedError, match=key):
        loop.run_dino_pretrain(_cfg([override]), device="cpu")


@pytest.mark.parametrize("override, key", [
    ("knn_eval={'enabled': True}", "knn_eval"),
    ("auto_umap.enabled=true", "auto_umap"),
])
def test_each_validation_key_runs(override, key, tmp_path):
    """The keys the port once refused: a one-epoch run logs the online kNN,
    or writes the epoch's UMAP where matplotlib is. Two torch threads: the
    t-SNE's small products are slower on eight, the more so beside other
    test processes."""
    cfg = _cfg([override, "data.size=32", "max_epochs=1", "log_every=1", "seed=3",
                "checkpoint.enabled=true", f"checkpoint.dir={tmp_path}"])
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        metrics = loop.run_dino_pretrain(cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    run = _run_dir(tmp_path)
    if key == "knn_eval":
        logs = _logs(run)
        assert 0.0 <= logs[2]["val_knn_top1"] <= logs[2]["val_knn_top5"] <= 100.0
        assert metrics["val_knn_top1"] == logs[2]["val_knn_top1"]
        return
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    assert (run / "umap_ep=0.png").is_file()


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.run_dino_pretrain(_cfg([]))


def test_port_loop_logs_the_jax_loop_metrics(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    init, want = fixture.load()
    cfg = _cfg(fixture.OVERRIDES)
    # the JAX loop's initial state, written as the port's checkpoint
    spec = loop.spec_from_cfg(cfg, len(loop.build_pretrain_loader(cfg, seed=3)))
    state, _, _, _ = build_dino(spec, device="cpu")
    for side in (state.student, state.teacher):
        for part, module in side.items():
            module.load_state_dict({k: torch.from_numpy(v) for k, v in init[part].items()})
    checkpoint.save_state(str(tmp_path / "init"), state)
    cfg = _cfg(fixture.OVERRIDES + ["checkpoint.enabled=true",
                                    f"checkpoint.dir={tmp_path}/ck",
                                    f"resume_from_checkpoint={tmp_path}/init"])
    loop.run_dino_pretrain(cfg, max_steps=fixture.STEPS, device="cpu")
    logs = _logs(_run_dir(tmp_path / "ck"))
    assert sorted(logs) == list(range(1, fixture.STEPS + 1))
    for k in fixture.METRICS:
        got = np.asarray([logs[s][k] for s in sorted(logs)])
        rel = np.abs(got - want[k]) / np.maximum(np.abs(want[k]), 1e-30)
        assert rel.max() <= FIXTURE_REL, (k, got, want[k])


def test_command_line_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    metrics = main_pretrain.main(["--config-path", str(SMOKE), "--config-name",
                                  "dino_synthetic", "--device", "cpu", "max_steps=2",
                                  "data.size=32", "backbone.kwargs.ln_impl=pallas"])
    assert np.isfinite(metrics["dino_loss"]) and "dino_loss" in capsys.readouterr().out


def test_sigusr1_checkpoints_at_the_step_and_returns(tmp_path, monkeypatch, capsys):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers are installed from the main thread only")
    monkeypatch.chdir(tmp_path)
    real = loop.build_dino

    def signalling_build(*args, **kwargs):
        state, step, model, head = real(*args, **kwargs)

        def step_then_signal(state, batch):
            out = step(state, batch)
            os.kill(os.getpid(), signal.SIGUSR1)
            return out
        return state, step_then_signal, model, head

    monkeypatch.setattr(loop, "build_dino", signalling_build)
    before = signal.getsignal(signal.SIGUSR1)
    loop.run_dino_pretrain(_cfg(RESUME + [f"checkpoint.dir={tmp_path}/s"]), device="cpu")
    assert "preemption signal: checkpointed at step 1" in capsys.readouterr().out
    assert [p.name.split("-")[-1] for p in _run_dir(tmp_path / "s").iterdir()
            if p.is_dir()] == ["step=1"]
    assert signal.getsignal(signal.SIGUSR1) == before
