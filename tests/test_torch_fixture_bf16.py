"""The committed bfloat16 JAX fixtures (tests/goldens/torch_port_cls_bf16_depth2.npz
and tests/goldens/torch_port_dino_bf16_depth2.npz) that ``chip_smoke.py`` holds
the port's bfloat16 path against on the card: they must still be what the JAX
package computes, and the port on the CPU must agree with them. This is where
the port's bfloat16 model is held against the JAX one end to end: the depth-2,
full-width ChAdaViT's CLS embeddings (JAX ``chada_vit(dtype=jnp.bfloat16)``
against the port's ``chada_vit(dtype=torch.bfloat16)`` on the same float32
weights) and three DINO steps (JAX ``build_dino`` with
``DinoPretrainSpec(dtype=jnp.bfloat16)`` against the port's ``build_dino`` in
bfloat16, from the port's seeded init).

Tolerances. The recompute runs the same JAX program: within one bfloat16 step
on the CLS, 1e-4 relative on the DINO records (an XLA build that sums in
another order can move a bfloat16 rounding). The port rounds at the same
points and sums in other orders. Each bound is a few times the worst reading
of the port on the CPU and of ``chip_smoke.py`` on an H100 (in brackets):
CLS cosine >= 1 - 5e-5 per row (1 - 1.1e-5) and max abs 5e-2 (3.1e-2, two
bfloat16 steps at |x| in [2, 4), after two layers and the final norm); over
the three DINO steps 5e-3 relative on the metrics (1.1e-3, the center norm),
1e-3 on every student and teacher parameter norm (2.4e-4), 5e-2 on the norms
of the student's changes (2.0e-2; a difference of nearby numbers).
"""

import numpy as np
import pytest
import torch

from chadavit_tpu_torch.hub import collate_images, random_images
from chadavit_tpu_torch.models.chada_vit import chada_vit
from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, build_dino, synthetic_dino_batch
from tests import torch_port_fixture as fixture

CLS_COS, CLS_ABS = 1 - 5e-5, 5e-2
METRIC_REL, NORM_REL, DELTA_REL = 5e-3, 1e-3, 5e-2
RECOMPUTE_REL = 1e-4


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _bf16_step(b):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126))) - 7)


def test_committed_cls_fixture_is_what_jax_computes():
    d = _load(fixture.BF16_PATH)
    assert int(d["weight_seed"]) == fixture.WEIGHT_SEED
    assert int(d["image_seed"]) == fixture.IMAGE_SEED
    assert tuple(d["counts"]) == fixture.COUNTS
    assert int(d["img_size"]) == fixture.IMG_SIZE and int(d["depth"]) == fixture.DEPTH
    ref = d["cls"]
    assert (np.abs(fixture.jax_cls("bfloat16") - ref) <= _bf16_step(ref)).all()
    # the bf16 fixture is a bf16 run, not the f32 one
    assert not np.array_equal(ref, _load(fixture.PATH)["cls"])


def test_port_on_cpu_matches_the_cls_fixture():
    d = _load(fixture.BF16_PATH)
    model = chada_vit(depth=int(d["depth"]), return_all_tokens=False,
                      img_size=int(d["img_size"]), dtype=torch.bfloat16)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in fixture.port_state_dict().items()})
    assert all(t.dtype == torch.float32 for t in model.state_dict().values())
    x, cc = collate_images(random_images(d["counts"].tolist(), int(d["img_size"]),
                                         int(d["image_seed"])))
    with torch.no_grad():
        out = model.eval()(x, cc)
    assert out.dtype == torch.bfloat16
    out, ref = out.float().numpy().astype(np.float64), d["cls"].astype(np.float64)
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= CLS_COS, cos
    assert np.abs(out - ref).max() <= CLS_ABS


@pytest.fixture(scope="module")
def dino():
    return _load(fixture.DINO_BF16_PATH)


def test_committed_dino_fixture_is_what_jax_computes(dino):
    d = dino
    assert int(d["weight_seed"]) == fixture.WEIGHT_SEED
    assert int(d["batch_seed"]) == fixture.DINO_BATCH_SEED
    assert tuple(d["counts"]) == fixture.DINO_COUNTS
    assert int(d["steps"]) == fixture.DINO_STEPS and int(d["depth"]) == fixture.DEPTH
    ref = fixture.jax_dino("bfloat16")
    assert list(ref["names"]) == list(d["names"])
    for k in (*fixture.DINO_METRICS, "student_norms", "teacher_norms", "student_delta_norms"):
        np.testing.assert_allclose(ref[k], d[k], rtol=RECOMPUTE_REL, atol=0, err_msg=k)


def test_port_on_cpu_matches_the_dino_fixture(dino):
    d = dino
    spec = DinoPretrainSpec(**fixture.DINO_SPEC, dtype=torch.bfloat16)
    state, step, _, _ = build_dino(spec, device="cpu", seed=int(d["weight_seed"]))
    batch = synthetic_dino_batch(spec, len(d["counts"]), int(d["batch_seed"]),
                                 d["counts"].tolist(), device="cpu")
    assert batch["crops"].dtype == torch.bfloat16
    before = {n: p.detach().clone() for n, p in state.trainable()}
    for i in range(int(d["steps"])):
        state, m = step(state, batch)
        for k in fixture.DINO_METRICS:
            np.testing.assert_allclose(float(m[k]), d[k][i], rtol=METRIC_REL, err_msg=k)
    names = [str(n) for n in d["names"]]
    for side in ("student", "teacher"):
        sd = {f"{part}.{k}": v for part in ("backbone", "head")
              for k, v in getattr(state, side)[part].state_dict().items()}
        assert sorted(sd) == names
        assert all(v.dtype == torch.float32 for v in sd.values())
        norms = [sd[n].double().norm().item() for n in names]
        np.testing.assert_allclose(norms, d[f"{side}_norms"], rtol=NORM_REL, err_msg=side)
        if side == "student":
            for i, n in enumerate(names):
                if n in before and d["student_delta_norms"][i] > 0:
                    delta = (sd[n] - before[n]).double().norm().item()
                    np.testing.assert_allclose(delta, d["student_delta_norms"][i],
                                               rtol=DELTA_REL, err_msg=n)
