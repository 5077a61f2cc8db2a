"""How far the port's bfloat16 forward sits from the float32 truth at a tiny
config, set against how far JAX's own bfloat16 forward sits from it: the
TINY config of tests/test_train_step.py (embed 64, 32 px, depth 2, a DINO
head of 64 prototypes), the JAX initial parameters carried across with
``state_dict_from_jax_params`` and ``head_state_dict_from_jax_params``, and
one synthetic batch (the port's ``synthetic_dino_batch``, its bfloat16 crops
for both bfloat16 runs). The forward is train step 1's teacher forward
(teacher = student at the start): the backbone's features of every crop and
the head's logits, on the CPU in JAX float32, JAX bfloat16 and the port's
bfloat16.

At this size the three DINO steps of the bfloat16 train path drift apart
between the two packages while float32 agrees: the teacher divides its
logits by a temperature of 0.04, so bfloat16 noise of a few 1e-2 in the
logits moves the softmax, and the loss, by a large share. This test holds
that noise to JAX's own: the port's bfloat16 max abs error over the largest
entry of the float32 reference, for the features and the logits, and the
worst row-cosine deficit of its logits, are each within GAP_FACTOR of JAX
bfloat16's (readings on the CPU: features 9.05e-3 against JAX's 1.05e-2,
logits 1.78e-2 against 1.78e-2, cosine deficit 4.8e-4 against 2.6e-4), and
the port's float32 forward equals JAX's to float32 rounding.
"""

import jax
import jax.numpy as jnp
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

GAP_FACTOR = 4.0
F32_REL = 1e-5  # the port's float32 against JAX's float32: summation order only


def _rel_err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _cos_deficit(got, ref):
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    cos = (got * ref).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(ref, axis=-1)
    return float(1 - cos.min())


@pytest.fixture(scope="module")
def forwards():
    """(features, logits) of the teacher's step-1 forward, numpy float32,
    keyed by run: "jax_f32", "jax_bf16", "port_f32", "port_bf16"."""
    mesh = make_mesh(n_model=1, devices=jax.devices()[:1])
    out = {}
    params = None
    for tag, jdt, tdt in (("f32", jnp.float32, torch.float32),
                          ("bf16", jnp.bfloat16, torch.bfloat16)):
        jstate, _, model, head = jax_build_dino(JaxSpec(**TINY, dtype=jdt), mesh=mesh,
                                                rng=jax.random.PRNGKey(0))
        if params is None:  # the float32 run's parameters for every run
            params = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate.teacher))
        spec = DinoPretrainSpec(**TINY, dtype=tdt)
        batch = synthetic_dino_batch(spec, batch_size=8, device="cpu")
        crops, cc = batch["crops"], batch["channel_counts"]
        flat = crops.reshape((-1,) + tuple(crops.shape[2:]))
        cc_rep = cc.repeat(crops.shape[0])

        jflat = jnp.asarray(flat.float().numpy()).astype(jdt)
        feats = model.apply({"params": params["backbone"]}, jflat, jnp.asarray(cc_rep.numpy()))
        logits = head.apply({"params": params["head"]}, feats)
        out["jax_" + tag] = tuple(np.asarray(t, np.float32) for t in (feats, logits))

        state, _, backbone, dino_head = build_dino(spec, device="cpu")
        backbone.load_state_dict(state_dict_from_jax_params(params["backbone"]))
        dino_head.load_state_dict(head_state_dict_from_jax_params(params["head"]))
        with torch.no_grad():
            feats = backbone(flat, cc_rep)
            logits = dino_head(feats)
        out["port_" + tag] = tuple(t.float().numpy() for t in (feats, logits))
    return out


def test_float32_forwards_agree(forwards):
    for i in range(2):
        assert _rel_err(forwards["port_f32"][i], forwards["jax_f32"][i]) <= F32_REL


@pytest.mark.parametrize("what", ["features", "logits"])
def test_port_bf16_error_is_jax_bf16_noise(forwards, what):
    i = ["features", "logits"].index(what)
    ref = forwards["jax_f32"][i]
    port, jax_own = (_rel_err(forwards[k][i], ref) for k in ("port_bf16", "jax_bf16"))
    assert 0 < jax_own and port <= GAP_FACTOR * jax_own, (port, jax_own)


def test_port_bf16_logit_cosine_is_jax_bf16_noise(forwards):
    ref = forwards["jax_f32"][1]
    port, jax_own = (_cos_deficit(forwards[k][1], ref) for k in ("port_bf16", "jax_bf16"))
    assert 0 < jax_own and port <= GAP_FACTOR * jax_own, (port, jax_own)
