"""The committed JAX fixtures (tests/goldens/torch_port_cls_depth2.npz and
tests/goldens/torch_port_dino_depth2.npz) that ``chip_smoke.py`` holds the port
against on the card: they must still be what the JAX package computes, and the
port on the CPU must agree with them.

Tolerances: the JAX recompute runs the same float32 program, so 1e-5
absolute on the CLS and 1e-6 relative on the DINO records; the port sums in
another order through two full-width layers, so cosine >= 1 - 1e-5 per row
and 1e-4 absolute on the CLS, and on the three DINO steps 1e-4 relative on
the metrics, 1e-5 on the parameter norms and 1e-3 on the norms of the
student's changes (a difference of nearby numbers), as on the card.
"""

import numpy as np
import torch

from chadavit_tpu_torch.hub import collate_images, random_images
from chadavit_tpu_torch.models.chada_vit import chada_vit
from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, build_dino, synthetic_dino_batch
from tests import torch_port_fixture as fixture


def _committed():
    with np.load(fixture.PATH) as f:
        return {k: f[k] for k in f.files}


def test_committed_fixture_is_what_jax_computes():
    d = _committed()
    assert int(d["weight_seed"]) == fixture.WEIGHT_SEED
    assert int(d["image_seed"]) == fixture.IMAGE_SEED
    assert tuple(d["counts"]) == fixture.COUNTS
    assert int(d["img_size"]) == fixture.IMG_SIZE and int(d["depth"]) == fixture.DEPTH
    np.testing.assert_allclose(fixture.jax_cls(), d["cls"], rtol=0, atol=1e-5)


def test_port_on_cpu_matches_the_fixture():
    d = _committed()
    model = chada_vit(depth=int(d["depth"]), return_all_tokens=False,
                      img_size=int(d["img_size"]))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in fixture.port_state_dict().items()})
    x, cc = collate_images(random_images(d["counts"].tolist(), int(d["img_size"]),
                                         int(d["image_seed"])))
    with torch.no_grad():
        out = model.eval()(x, cc).numpy()
    ref = d["cls"]
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 1 - 1e-5, cos
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def _committed_dino():
    with np.load(fixture.DINO_PATH) as f:
        return {k: f[k] for k in f.files}


def test_committed_dino_fixture_is_what_jax_computes():
    d = _committed_dino()
    assert int(d["weight_seed"]) == fixture.WEIGHT_SEED
    assert int(d["batch_seed"]) == fixture.DINO_BATCH_SEED
    assert tuple(d["counts"]) == fixture.DINO_COUNTS
    assert int(d["steps"]) == fixture.DINO_STEPS and int(d["depth"]) == fixture.DEPTH
    ref = fixture.jax_dino()
    assert list(ref["names"]) == list(d["names"])
    for k in (*fixture.DINO_METRICS, "student_norms", "teacher_norms", "student_delta_norms"):
        np.testing.assert_allclose(ref[k], d[k], rtol=1e-6, atol=0, err_msg=k)


def test_port_on_cpu_matches_the_dino_fixture():
    d = _committed_dino()
    spec = DinoPretrainSpec(**fixture.DINO_SPEC)
    state, step, _, _ = build_dino(spec, device="cpu", seed=int(d["weight_seed"]))
    batch = synthetic_dino_batch(spec, len(d["counts"]), int(d["batch_seed"]),
                                 d["counts"].tolist(), device="cpu")
    before = {n: p.detach().clone() for n, p in state.trainable()}
    for i in range(int(d["steps"])):
        state, m = step(state, batch)
        for k in fixture.DINO_METRICS:
            np.testing.assert_allclose(float(m[k]), d[k][i], rtol=1e-4, err_msg=k)
    names = [str(n) for n in d["names"]]
    for side in ("student", "teacher"):
        sd = {f"{part}.{k}": v for part in ("backbone", "head")
              for k, v in getattr(state, side)[part].state_dict().items()}
        assert sorted(sd) == names
        norms = [sd[n].double().norm().item() for n in names]
        np.testing.assert_allclose(norms, d[f"{side}_norms"], rtol=1e-5, err_msg=side)
        if side == "student":
            for i, n in enumerate(names):
                if n in before and d["student_delta_norms"][i] > 0:
                    delta = (sd[n] - before[n]).double().norm().item()
                    np.testing.assert_allclose(delta, d["student_delta_norms"][i], rtol=1e-3,
                                               err_msg=n)
