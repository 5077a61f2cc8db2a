"""The port's DINO train step (chadavit_tpu_torch/train/) against the JAX
``build_dino`` on one CPU device: the TINY config of tests/test_train_step.py
(clip 3.0, prototype freeze for epoch 0, steps_per_epoch 2, teacher-temp
warmup over 2 epochs), the same synthetic batch, and the JAX initial
parameters carried across with ``state_dict_from_jax_params`` and
``head_state_dict_from_jax_params``. Four steps cross the prototype unfreeze
and the end of the lr warmup.

Tolerance: float32 on both sides, summed in other orders through two layers,
the head, LARS and four updates: relative 1e-4 on every metric, and on every
student and teacher tensor relative 1e-4 of the tensor's largest entry (an
entry near zero in a tensor of scale 1 carries rounding of the tensor's
scale, not its own).
"""

import jax
import numpy as np
import pytest
import torch

from chadavit_tpu.parallel.mesh import make_mesh
from chadavit_tpu.train.pretrain import DinoPretrainSpec as JaxSpec
from chadavit_tpu.train.pretrain import build_dino as jax_build_dino
from chadavit_tpu_torch.models.import_torch import (
    head_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, build_dino, synthetic_dino_batch
from tests.test_train_step import TINY

STEPS = 4
METRICS = ("dino_loss", "lr", "tau", "teacher_temp", "teacher_entropy", "center_norm",
           "epoch")
TOL = dict(rtol=1e-4, atol=1e-6)
TENSOR_REL = 1e-4


def _port_state_dicts(tree):
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(tree))
    return {"backbone": state_dict_from_jax_params(tree["backbone"]),
            "head": head_state_dict_from_jax_params(tree["head"])}


@pytest.fixture(scope="module")
def runs():
    jspec = JaxSpec(**TINY)
    mesh = make_mesh(n_model=1, devices=jax.devices()[:1])
    jstate, jstep, _, _ = jax_build_dino(jspec, mesh=mesh, rng=jax.random.PRNGKey(0))
    initial = _port_state_dicts(jstate.student)

    spec = DinoPretrainSpec(**TINY)
    state, step, _, _ = build_dino(spec, device="cpu")
    for part in ("backbone", "head"):
        state.student[part].load_state_dict(initial[part])
        state.teacher[part].load_state_dict(initial[part])
    batch = synthetic_dino_batch(spec, batch_size=8, device="cpu")
    jbatch = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}

    hist, jhist = [], []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jbatch)
        jhist.append({k: float(v) for k, v in jm.items()})
        state, m = step(state, batch)
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist, jstate, jhist


@pytest.mark.parametrize("i", range(STEPS))
def test_metrics_match_jax(runs, i):
    _, hist, _, jhist = runs
    for k in METRICS:
        np.testing.assert_allclose(hist[i][k], jhist[i][k], err_msg=k, **TOL)


@pytest.mark.parametrize("side", ["student", "teacher"])
def test_parameters_match_jax_after_the_steps(runs, side):
    state, _, jstate, _ = runs
    ref = _port_state_dicts(getattr(jstate, side))
    for part in ("backbone", "head"):
        got = getattr(state, side)[part].state_dict()
        assert set(got) == set(ref[part])
        for name, t in got.items():
            want = ref[part][name].numpy()
            err = np.abs(t.numpy() - want).max()
            assert err <= TENSOR_REL * np.abs(want).max(), (side, part, name, err)


def test_the_steps_moved_the_student(runs):
    state, _, _, _ = runs
    assert state.step == STEPS
    assert torch.linalg.vector_norm(state.center) > 0
