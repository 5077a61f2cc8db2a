"""The JAX pretrain-loop fixture that ``tests/test_torch_loop.py`` holds the
port's loop against.

``torch_port_loop_smoke.npz``: three steps of the JAX package's
``run_dino_pretrain`` on ``scripts/smoke/dino_synthetic.yaml`` with
:data:`OVERRIDES` (2 steps an epoch, so step 3 opens epoch 1: the teacher
temperature leaves its warmup and the prototypes unfreeze). It holds the JAX
loop's initial student (its ``jax.random`` init, converted to the port's
names with the port's ``state_dict_from_jax_params`` and
``head_state_dict_from_jax_params``, under ``backbone.*`` and ``head.*``) and
the loop's logged metrics of each step (:data:`METRICS`).

The JAX loader draws its augmentations from one generator per pipeline,
shared by its worker threads, so its crops change from run to run; here its
dataset is wrapped to hand each sample the generator the port's loader gives
it, ``sample_rng(seed, epoch, index)`` (``data/pipeline.py``), so that both
loops see the same batches.

Regenerate with ``JAX_PLATFORMS=cpu python -m tests.torch_port_loop_fixture``.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PATH = ROOT / "tests" / "goldens" / "torch_port_loop_smoke.npz"
SMOKE = ROOT / "scripts" / "smoke" / "dino_synthetic.yaml"
OVERRIDES = ["data.size=32", "log_every=1", "seed=3", "checkpoint.enabled=false",
             "auto_resume.enabled=false"]
STEPS = 3
METRICS = ("dino_loss", "lr", "tau", "teacher_temp", "teacher_entropy", "center_norm",
           "epoch")


class _PerSampleGenerator:
    """A JAX dataset whose transform gets each sample's own generator, the
    port's ``sample_rng(seed, epoch, index)``; the epoch is the loader's."""

    def __init__(self, dataset, seed: int):
        self.dataset, self.seed, self.loader = dataset, seed, None
        self.transform, dataset.transform = dataset.transform, None

    def __len__(self):
        return len(self.dataset)

    def channel_count(self, index: int) -> int:
        return self.dataset.channel_count(index)

    def __getitem__(self, index: int):
        img, label = self.dataset[index]
        rng = np.random.default_rng([self.seed, self.loader.epoch, index])
        return self.transform(img, rng), label


def jax_loop() -> dict:
    """Run the JAX loop and return the fixture's arrays."""
    import jax

    import chadavit_tpu.train.loop as jax_loop_mod
    from chadavit_tpu.cli import apply_overrides
    from chadavit_tpu.config import load_yaml, parse_pretrain_cfg
    from chadavit_tpu_torch.models.import_torch import (
        head_state_dict_from_jax_params,
        state_dict_from_jax_params,
    )

    cfg = parse_pretrain_cfg(apply_overrides(load_yaml(str(SMOKE)), OVERRIDES))
    build_loader, build_dino = jax_loop_mod.build_pretrain_loader, jax_loop_mod.build_dino
    init = {}

    def per_sample_loader(cfg_, seed=0):
        loader = build_loader(cfg_, seed=seed)
        loader.dataset = _PerSampleGenerator(loader.dataset, seed)
        loader.dataset.loader = loader
        return loader

    def capture_init(*args, **kwargs):
        out = build_dino(*args, **kwargs)
        student = jax.tree_util.tree_map(np.asarray, jax.device_get(out[0].student))
        init.update({f"backbone.{k}": v.numpy() for k, v in
                     state_dict_from_jax_params(student["backbone"]).items()})
        init.update({f"head.{k}": v.numpy() for k, v in
                     head_state_dict_from_jax_params(student["head"]).items()})
        return out

    jax_loop_mod.build_pretrain_loader = per_sample_loader
    jax_loop_mod.build_dino = capture_init
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            jax_loop_mod.run_dino_pretrain(cfg, max_steps=STEPS)
            import json

            with open("training_logs.txt") as f:
                logs = [json.loads(line) for line in f]
    finally:
        os.chdir(cwd)
        jax_loop_mod.build_pretrain_loader, jax_loop_mod.build_dino = build_loader, build_dino
    assert [r["step"] for r in logs] == list(range(1, STEPS + 1)), logs
    return {**{f"init/{k}": v for k, v in init.items()},
            **{f"metric/{k}": np.asarray([r[k] for r in logs], np.float64) for k in METRICS}}


def write(path: Path = PATH) -> None:
    np.savez_compressed(path, **jax_loop(), overrides=np.asarray(OVERRIDES), steps=STEPS)


def load(path: Path = PATH):
    """``(initial student {"backbone": sd, "head": sd} as numpy, metrics
    {name: (STEPS,) array})``."""
    with np.load(path) as f:
        init = {"backbone": {}, "head": {}}
        metrics = {}
        for k in f.files:
            if k.startswith("init/"):
                part, name = k[len("init/"):].split(".", 1)
                init[part][name] = f[k]
            elif k.startswith("metric/"):
                metrics[k[len("metric/"):]] = f[k]
    return init, metrics


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write()
    print(f"wrote {PATH}")
