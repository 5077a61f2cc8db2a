"""The committed JAX fixture (tests/goldens/torch_port_cls_depth2.npz) that
``chip_smoke.py`` holds the port against on the card: it must still be what
the JAX package computes, and the port on the CPU must agree with it.

Tolerances: the JAX recompute runs the same float32 program, so 1e-5
absolute; the port sums in another order through two full-width layers, so
cosine >= 1 - 1e-5 per row and 1e-4 absolute.
"""

import numpy as np
import torch

from chadavit_tpu_torch.hub import collate_images, random_images
from chadavit_tpu_torch.models.chada_vit import chada_vit
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
