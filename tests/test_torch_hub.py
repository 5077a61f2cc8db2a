"""The port's hub (chadavit_tpu_torch/hub.py) held against the JAX hub on the
CPU, with one set of weights driving both packages.

Tolerance: float32 on both sides; 1e-4 absolute after 12 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu import hub as jax_hub
from chadavit_tpu.models.import_torch import chada_vit_params_from_torch
from chadavit_tpu_torch import hub


def test_collate_images_matches_jax():
    images = hub.random_images([1, 4, 10, 3], img_size=32, seed=0)
    images.append(np.ones((32, 32), np.float32))  # a bare 2-D plane
    x, cc = hub.collate_images(images)
    ref_x, ref_cc = jax_hub.collate_images(images)
    assert x.dtype == torch.float32 and cc.dtype == torch.int32
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref_x))
    np.testing.assert_array_equal(cc.numpy(), np.asarray(ref_cc))


def test_extract_embeddings_on_cpu_match_the_jax_hub():
    model = hub.load_chadavit16_moyen(img_size=32, device="cpu", seed=0)
    images = hub.random_images([1, 4, 10, 3, 7], img_size=32, seed=1)
    embs = hub.extract_embeddings(model, images, batch_size=3)
    assert embs.shape == (5, 192)

    jax_model, _ = jax_hub.load_chadavit16_moyen(None, img_size=32)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray, chada_vit_params_from_torch(sd, depth=12))
    ref = jax_hub.extract_embeddings(jax_model, {"params": params}, images, batch_size=3)
    np.testing.assert_allclose(embs, ref, rtol=1e-4, atol=1e-4)


def test_seeded_weights_are_reproducible():
    a = hub.load_chadavit16_moyen(img_size=32, device="cpu", seed=5).state_dict()
    b = hub.load_chadavit16_moyen(img_size=32, device="cpu", seed=5).state_dict()
    c = hub.load_chadavit16_moyen(img_size=32, device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.linear1.weight"], c["blocks.0.linear1.weight"])


def test_load_without_a_device_raises_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        hub.load_chadavit16_moyen(img_size=32)
