"""Three DINO train steps of ChAdaViT-B/16 in the port against the JAX
``build_dino`` on one CPU device: depth 2 at 32 px (D 768, 12 heads of 64,
FFN 2048) with the root bench's B/16 head (``bench.py:552-561``: 65 536
prototypes), clip 3.0, the prototype freeze for epoch 0, ``steps_per_epoch``
2 (the third step unfreezes the prototypes), the same synthetic batch (4
images of 10, 4, 1 and 7 channels), and the JAX initial parameters carried
across with ``state_dict_from_jax_params`` and
``head_state_dict_from_jax_params`` (the packed ``in_proj`` of 12 heads, the
65 536-prototype last layer). At 32 px the sequences fit the JAX layer's
fused kernel, so the port runs its layer chain's plain versions; the unfused
route at full width is held by ``tests/test_torch_b16.py`` (the CLS
fixture) and on the card by ``chip_smoke.py``.

Tolerance: float32 on both sides as ``tests/test_torch_train_step.py``: 1e-4
relative on the metrics, and after the steps every student tensor within
1e-4 of its largest entry. bfloat16 as ``tests/test_torch_fixture_bf16.py``:
5e-3 relative on the metrics.
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
from tests import torch_port_fixture as fixture

D, HEADS = 768, 12

DINO = dict(
    backbone_kwargs=dict(embed_dim=D, num_heads=HEADS, patch_size=16, return_all_tokens=False,
                         max_number_channels=10, depth=2),
    img_size=32, max_channels=10, num_prototypes=fixture.B16_PROTOTYPES, steps_per_epoch=2,
    max_epochs=4, warmup_epochs=1, clip_grad=3.0, freeze_last_layer=1,
    warmup_teacher_temperature_epochs=2)
DINO_METRICS = ("dino_loss", "lr", "tau", "teacher_temp", "center_norm")


def _port_state_dicts(tree):
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(tree))
    return {"backbone": state_dict_from_jax_params(tree["backbone"]),
            "head": head_state_dict_from_jax_params(tree["head"])}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_dino_steps_with_the_b16_head_match_jax(dtype):
    jspec = JaxSpec(**DINO, dtype=getattr(jnp, dtype))
    mesh = make_mesh(n_model=1, devices=jax.devices()[:1])
    jstate, jstep, _, _ = jax_build_dino(jspec, mesh=mesh, rng=jax.random.PRNGKey(0))
    initial = _port_state_dicts(jstate.student)
    spec = DinoPretrainSpec(**DINO, dtype=getattr(torch, dtype))
    state, step, _, _ = build_dino(spec, device="cpu")
    for part in ("backbone", "head"):
        state.student[part].load_state_dict(initial[part])
        state.teacher[part].load_state_dict(initial[part])
    batch = synthetic_dino_batch(spec, 4, 2, [10, 4, 1, 7], device="cpu")
    jbatch = {k: jnp.asarray(v.float().numpy()) for k, v in batch.items()}
    jbatch["crops"] = jbatch["crops"].astype(getattr(jnp, dtype))
    jbatch["channel_counts"] = jbatch["channel_counts"].astype(jnp.int32)
    rel = 1e-4 if dtype == "float32" else 5e-3
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        for k in DINO_METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rel, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    if dtype == "float32":
        ref = _port_state_dicts(jstate.student)
        for part in ("backbone", "head"):
            got = state.student[part].state_dict()
            for k, want in ref[part].items():
                err = (got[k] - want).abs().max().item()
                assert err <= 1e-4 * max(want.abs().max().item(), 1e-6), (part, k, err)


