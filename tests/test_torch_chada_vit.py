"""The port's ChAdaViT (chadavit_tpu_torch/models/chada_vit.py) and its weight
bridge (models/import_torch.py) held against the JAX package on the CPU, on a
small model: img 32, patch 16, D 32, depth 2, heads 2, FFN 64, up to 4
channels. One state dict drives both packages, through the JAX package's own
``chada_vit_params_from_torch``.

Tolerance: float32 on both sides, 2e-5 absolute and relative after two layers
and the final norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.models.chada_vit import ChAdaViT as JaxChAdaViT
from chadavit_tpu.models.chada_vit import channel_padding_mask as jax_mask
from chadavit_tpu.models.chada_vit import densify_one_channel_batch as jax_densify
from chadavit_tpu.models.import_torch import chada_vit_params_from_torch
from chadavit_tpu_torch.models.chada_vit import (
    ChAdaViT,
    channel_padding_mask,
    densify_one_channel_batch,
    random_state_dict,
)
from chadavit_tpu_torch.models.import_torch import state_dict_from_jax_params

CFG = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
           ffn_dim=64, max_channels=4)
COUNTS = np.asarray([4, 1, 2, 3], np.int32)
TOL = dict(rtol=2e-5, atol=2e-5)


def _port(block_impl="auto", seed=0, return_all_tokens=False):
    m = ChAdaViT(return_all_tokens=return_all_tokens, block_impl=block_impl, **CFG)
    m.load_state_dict(random_state_dict(m, seed))
    return m.eval()


def _jax(model, block_impl="xla", return_all_tokens=False):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = chada_vit_params_from_torch(sd, depth=CFG["depth"])
    jm = JaxChAdaViT(return_all_tokens=return_all_tokens, block_impl=block_impl,
                     attn_impl="xla", **CFG)
    return jm, {"params": jax.tree_util.tree_map(jnp.asarray, params)}


def _images(seed=1):
    return np.random.default_rng(seed).random((len(COUNTS), 4, 32, 32), dtype=np.float32)


def test_channel_padding_mask_matches_jax():
    ref = jax_mask(jnp.asarray(COUNTS), 4, 4)
    np.testing.assert_array_equal(channel_padding_mask(torch.from_numpy(COUNTS), 4, 4).numpy(),
                                  np.asarray(ref))


def test_tokenize_matches_jax():
    m = _port()
    jm, variables = _jax(m)
    x = _images()
    ref_emb, ref_mask = jm.apply(variables, jnp.asarray(x), jnp.asarray(COUNTS),
                                 method=JaxChAdaViT.tokenize)
    with torch.no_grad():
        emb, mask = m.tokenize(torch.from_numpy(x), torch.from_numpy(COUNTS))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(emb.numpy(), np.asarray(ref_emb), **TOL)


@pytest.mark.parametrize("block_impl", ["auto", "xla"])  # the layer chain; unfused
def test_cls_matches_jax(block_impl):
    m = _port(block_impl)
    jm, variables = _jax(m)
    x = _images()
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(COUNTS))
    with torch.no_grad():
        out = m(torch.from_numpy(x), torch.from_numpy(COUNTS))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cls_matches_jax_fused_kernel_interpret():
    # block_impl="fused" runs the JAX package's fused Pallas layer interpreted
    m = _port(seed=3)
    jm, variables = _jax(m, block_impl="fused")
    x = _images(4)
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(COUNTS))
    with torch.no_grad():
        out = m(torch.from_numpy(x), torch.from_numpy(COUNTS))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_tokens_at_valid_positions_match_jax():
    m = _port(return_all_tokens=True)
    jm, variables = _jax(m, return_all_tokens=True)
    x = _images(5)
    ref_tok, ref_valid = jm.apply(variables, jnp.asarray(x), jnp.asarray(COUNTS))
    with torch.no_grad():
        tok, valid = m(torch.from_numpy(x), torch.from_numpy(COUNTS))
    valid = valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref_valid))
    np.testing.assert_allclose(tok.numpy()[valid], np.asarray(ref_tok)[valid], **TOL)


def test_intermediate_layers_match_jax():
    m = _port(seed=6)
    jm, variables = _jax(m)
    x = _images(7)
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(COUNTS), 2,
                   method=JaxChAdaViT.get_intermediate_layers)
    with torch.no_grad():
        outs = m.get_intermediate_layers(torch.from_numpy(x), torch.from_numpy(COUNTS), n=2)
    assert len(outs) == len(ref) == 2
    valid_len = 1 + 4 * COUNTS
    for o, r in zip(outs, ref):
        for i, n in enumerate(valid_len):
            np.testing.assert_allclose(o.numpy()[i, :n], np.asarray(r)[i, :n], **TOL)


def test_last_selfattention_matches_jax():
    m = _port(seed=8)
    jm, variables = _jax(m)
    x = _images(9)[:, :1]
    ref = jm.apply(variables, jnp.asarray(x), method=JaxChAdaViT.get_last_selfattention)
    with torch.no_grad():
        out = m.get_last_selfattention(torch.from_numpy(x))
    assert out.shape == (len(COUNTS), 2, 5, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_weights_port_to_jax_to_port_round_trip_is_exact():
    m = _port(seed=10)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    back = state_dict_from_jax_params(chada_vit_params_from_torch(sd, depth=CFG["depth"]))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_weights_jax_to_port_run_the_jax_model():
    jm = JaxChAdaViT(return_all_tokens=False, block_impl="xla", attn_impl="xla", **CFG)
    x = _images(11)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(COUNTS))["params"]
    sd = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    m = ChAdaViT(return_all_tokens=False, **CFG)
    m.load_state_dict(sd)
    # and back through the JAX importer: the same params, bit for bit
    again = chada_vit_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                        depth=CFG["depth"])
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, params), again)
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(COUNTS))
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x), torch.from_numpy(COUNTS))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_densify_one_channel_batch_matches_jax():
    rng = np.random.default_rng(12)
    counts = [2, 1, 3]
    flat = rng.random((sum(counts), 1, 32, 32), dtype=np.float32)
    ref_x, ref_c = jax_densify(flat, counts, 4)
    x, c = densify_one_channel_batch(flat, counts, 4)
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref_x))
    np.testing.assert_array_equal(c.numpy(), np.asarray(ref_c))
