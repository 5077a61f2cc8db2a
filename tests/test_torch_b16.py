"""ChAdaViT-B/16 in the port (D 768, 12 heads of 64, FFN 2048; the root
bench's B/16 phase and ``scripts/pretrain/dino_chada_vit_b16_pod.yaml``), on
the CPU, against the JAX package.

- The route: the port's copy of the JAX layer's VMEM gate
  (``ops/fused_block.py::jax_layer_fused``) equals the JAX arithmetic at
  every sequence width of 1-10 channels, in both dtypes; on the CUDA route
  (the launch stubbed) ChAdaViT-moyen takes the layer chain at S 2048,
  B/16 at S 2048 the unfused layer with one attention forward launch a layer
  forward and one backward launch a layer backward (and no chain launch),
  and B/16 where the gate says fused the layer chain, its forward and
  backward launches counted under the chain's D 768 instances (``_d768``)
  and the attention's head-64 ones; a width the chain is not built for (D
  384) still raises ``NotImplementedError`` there.
- The weights: the JAX model's init carried into the port
  (``state_dict_from_jax_params``, the packed ``in_proj`` of 12 heads) gives
  the same CLS and tokens, at B/16's widths (depth 2, 32 px) and a narrow
  head-64 model (D 128, 2 heads), through the fused and the unfused layer;
  on the fused route the port matches the JAX model with
  ``block_impl="fused"`` (its Pallas layer kernel in interpret mode): the CLS
  and every parameter's gradient of a loss on it;
  the port's seeded weights and a 65 536-prototype head go to JAX and back
  bit for bit (three DINO steps with that head: ``tests/test_torch_b16_train.py``).
- The full-width fixtures that ``chip_smoke.py`` holds the card to:
  ``tests/test_torch_b16_fixture.py``.

Tolerance: float32 on both sides, 2e-5 relative (and absolute) on the CLS
and tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.models.chada_vit import ChAdaViT as JaxChAdaViT
from chadavit_tpu.models.import_torch import (
    chada_vit_params_from_torch,
    dino_head_params_from_torch,
)
from chadavit_tpu.ops import fused_block as jax_fused_block
from chadavit_tpu_torch.models.chada_vit import ChAdaViT, EncoderLayer, chada_vit
from chadavit_tpu_torch.models.dino_head import DINOHead
from chadavit_tpu_torch.models.import_torch import (
    head_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from chadavit_tpu_torch.ops import _launch, fused_block
from tests import torch_port_fixture as fixture
from tests.test_torch_fused_block_backward import fake_cuda  # noqa: F401 (a fixture)

D, HEADS, FFN = 768, 12, 2048
# S_pad of a batch whose widest image has 1..10 channels (1 + 196 c, padded to 128)
S_BY_CHANNELS = [256, 512, 640, 896, 1024, 1280, 1408, 1664, 1792, 2048]
TOL = dict(rtol=2e-5, atol=2e-5)
CHAIN = ["ln_linear_fwd", "prefix_attention_fwd", "linear_residual_ln_fwd", "linear_relu_fwd",
         "linear_residual_ln_fwd"]
DTYPES = [torch.float32, torch.bfloat16]


def _tag(dtype):
    return "" if dtype == torch.float32 else "_bf16"


# ---- the route: the JAX layer's gate ------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", S_BY_CHANNELS)
def test_gate_equals_the_jax_arithmetic(s, dtype):
    itemsize = 4 if dtype == torch.float32 else 2
    for d, heads in ((D, HEADS), (192, 2)):
        blk = jax_fused_block.pick_block(s)
        assert fused_block.pick_block(s) == blk
        s_pad = -(-s // blk) * blk
        est = jax_fused_block.vmem_estimate(s_pad, d, FFN, heads, blk, itemsize)
        assert fused_block.vmem_estimate(s_pad, d, FFN, heads, blk, itemsize) == est
        want = (d // heads) % 8 == 0 and est <= jax_fused_block.VMEM_BYTES
        assert fused_block.jax_layer_fused(s, d, FFN, heads, dtype) == want


def test_gate_sends_wide_b16_batches_to_the_unfused_layer():
    # ChAdaViT-B/16: unfused from 8 channels in bf16, from 4 in f32; moyen never
    fused = {dt: [fused_block.jax_layer_fused(s, D, FFN, HEADS, dt) for s in S_BY_CHANNELS]
             for dt in DTYPES}
    assert fused[torch.bfloat16] == [True] * 7 + [False] * 3
    assert fused[torch.float32] == [True] * 3 + [False] * 7
    assert all(fused_block.jax_layer_fused(s, 192, FFN, 2, dt)
               for s in S_BY_CHANNELS for dt in DTYPES)
    # no valid_len, attention weights asked, or a head width off 8: unfused
    assert not fused_block.jax_layer_fused(256, D, FFN, HEADS, torch.float32,
                                           has_valid_len=False)
    assert not fused_block.jax_layer_fused(256, D, FFN, HEADS, torch.float32,
                                           return_attention=True)
    assert not fused_block.jax_layer_fused(256, 60, FFN, 2, torch.float32)


# ---- the route on CUDA tensors, the launch stubbed -----------------------------------
def _layer_run(d, heads, s, dtype, valid):
    layer = EncoderLayer(d, heads, FFN, dtype=dtype)
    x = torch.zeros(1, s, d, dtype=dtype, requires_grad=True)
    return layer, x, layer(x, None, valid_len=torch.tensor([valid], dtype=torch.int32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_moyen_takes_the_chain_at_2048(fake_cuda, dtype):
    _, _, y = _layer_run(192, 2, 2048, dtype, 1961)
    assert type(y.grad_fn).__name__ == "FusedEncoderBlockBackward"
    assert fake_cuda.calls == [name + _tag(dtype) for name in CHAIN]


@pytest.mark.parametrize("dtype", DTYPES)
def test_b16_takes_the_unfused_layer_at_2048(fake_cuda, dtype):
    fwd, bwd = "prefix_attention_fwd" + _tag(dtype), "prefix_attention_bwd" + _tag(dtype)
    before = dict(_launch.LAUNCHES)
    layer, x, y = _layer_run(D, HEADS, 2048, dtype, 1961)
    assert fake_cuda.calls == [fwd]  # no chain launch: the library products and norms
    y.float().sum().backward()
    assert fake_cuda.calls == [fwd, bwd]
    (fargs, bargs) = fake_cuda.args
    assert (fargs[9], fargs[10], bargs[15], bargs[16]) == (HEADS, 64, HEADS, 64)
    for name in (fwd, bwd):
        assert _launch.LAUNCHES[name + "_hd64"] == before.get(name + "_hd64", 0) + 1
    assert x.grad is not None and layer.self_attn.in_proj_weight.grad is not None


CHAIN_BWD = {"layernorm_bwd": 3, "linear_dgrad": 4, "linear_wgrad": 4, "prefix_attention_bwd": 1,
             "ln_linear_fwd": 1, "linear_relu_fwd": 1, "linear_residual_ln_fwd": 1}


def _c_entry(name, dtype):
    """The C entry point a launch of chain entry ``name`` at D 768 goes to:
    the bfloat16 K1a, K1b, K1c, K2b and K2c there are the wgmma kernels, the
    float32 K1a the 128-row GEMM behind its LN1 row pass and the float32 K2b
    and K2c the stream-K walks."""
    if dtype == torch.bfloat16 and name in ("ln_linear_fwd", "linear_residual_ln_fwd",
                                            "linear_relu_fwd", "linear_dgrad", "linear_wgrad"):
        return name + "_wgmma_bf16"
    if dtype == torch.float32 and name in ("ln_linear_fwd", "linear_wgrad", "linear_dgrad"):
        return name + "_d768"
    return name + _tag(dtype)


def _counted(name, dtype):
    """The instance a launch of chain entry ``name`` at D 768 is counted under."""
    entry = name + _tag(dtype)
    if name.startswith("prefix_attention"):
        return entry + "_hd64"
    return fused_block.instance(entry, D)


@pytest.mark.parametrize("dtype, s", [(torch.bfloat16, 640), (torch.float32, 256)])
def test_b16_where_the_gate_says_fused_raises(fake_cuda, dtype, s):
    # (the name is from when the chain had no D 768 instances and this raised)
    # where the gate says fused, B/16 takes the layer chain: its forward
    # launches, then its backward's, each counted under its D 768 instance
    before = dict(_launch.LAUNCHES)
    layer, x, y = _layer_run(D, HEADS, s, dtype, s - 100)
    assert type(y.grad_fn).__name__ == "FusedEncoderBlockBackward"
    assert fake_cuda.calls == [_c_entry(name, dtype) for name in CHAIN]
    y.float().sum().backward()
    backward = fake_cuda.calls[len(CHAIN):]
    assert {n: backward.count(_c_entry(n, dtype)) for n in CHAIN_BWD} == CHAIN_BWD
    assert len(backward) == sum(CHAIN_BWD.values())
    launched = {k: v - before.get(k, 0) for k, v in _launch.LAUNCHES.items()
                if v != before.get(k, 0)}
    want = {}
    for name in CHAIN:
        want[_counted(name, dtype)] = want.get(_counted(name, dtype), 0) + 1
    for name, n in CHAIN_BWD.items():
        want[_counted(name, dtype)] = want.get(_counted(name, dtype), 0) + n
    assert launched == want
    assert x.grad is not None and layer.self_attn.in_proj_weight.grad is not None


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_width_the_chain_is_not_built_for_still_raises(fake_cuda, dtype):
    # D 384 in 3 heads of 128, where the JAX gate says fused
    assert fused_block.jax_layer_fused(256, 384, FFN, 3, dtype)
    with pytest.raises(NotImplementedError, match="D 384"):
        _layer_run(384, 3, 256, dtype, 156)
    assert fake_cuda.calls == []


# ---- the weights and the model against JAX ---------------------------------------------
SMALL = dict(img_size=32, patch_size=16, depth=2, ffn_dim=FFN, max_channels=10)
SMALL_COUNTS = np.asarray([10, 1, 4, 7], np.int32)


@pytest.mark.parametrize("block_impl", ["auto", "xla"])  # the layer chain; the unfused layer
@pytest.mark.parametrize("d, heads", [(D, HEADS), (128, 2)])
def test_jax_init_carried_across_gives_the_same_model(d, heads, block_impl):
    cfg = dict(SMALL, embed_dim=d, num_heads=heads)
    x = np.random.default_rng(5).random((len(SMALL_COUNTS), 10, 32, 32), dtype=np.float32)
    outs = {}
    for all_tokens in (False, True):
        jm = JaxChAdaViT(return_all_tokens=all_tokens, block_impl="xla", attn_impl="xla", **cfg)
        if not outs:
            params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                             jnp.asarray(SMALL_COUNTS))["params"]
            sd = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params))
            assert sd["blocks.0.self_attn.in_proj_weight"].shape == (3 * d, d)
        m = ChAdaViT(return_all_tokens=all_tokens, block_impl=block_impl, **cfg)
        m.load_state_dict(sd)
        ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(SMALL_COUNTS))
        with torch.no_grad():
            out = m.eval()(torch.from_numpy(x), torch.from_numpy(SMALL_COUNTS))
        if all_tokens:
            (tok, valid), (ref_tok, ref_valid) = out, ref
            np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
            v = valid.numpy()
            np.testing.assert_allclose(tok.numpy()[v], np.asarray(ref_tok)[v], **TOL)
        else:
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        outs[all_tokens] = out


def test_b16_on_the_fused_route_matches_the_jax_fused_kernel():
    # B/16 at depth 2, 32 px, images of 3, 1 and 2 channels (13 tokens, padded
    # to 128: the JAX gate takes the fused layer): the port, whose layers take
    # the layer chain (plain versions on the CPU), against the JAX model with
    # block_impl="fused" (its Pallas layer kernel and custom VJP in interpret
    # mode) from the same weights: the CLS, and the gradient of every
    # parameter of a loss on it (sum of (CLS - target)^2), within 1e-4 of each
    # gradient's largest entry (at least 1), the port's float32 gradient bound
    cfg = dict(SMALL, embed_dim=D, num_heads=HEADS)
    counts = np.asarray([3, 1, 2], np.int32)
    rng = np.random.default_rng(9)
    x = rng.random((len(counts), 3, 32, 32), dtype=np.float32)
    tgt = rng.standard_normal((len(counts), D)).astype(np.float32)
    assert fused_block.jax_layer_fused(128, D, FFN, HEADS, torch.float32)
    jm = JaxChAdaViT(return_all_tokens=False, block_impl="fused", attn_impl="xla", **cfg)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(counts))["params"]

    def jloss(p):
        cls = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(counts))
        return jnp.sum((cls - tgt) ** 2), cls

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    sd = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    gref = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    m = ChAdaViT(return_all_tokens=False, **cfg)
    m.load_state_dict(sd)
    out = m(torch.from_numpy(x), torch.from_numpy(counts))
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    grads = dict(m.named_parameters())
    assert set(grads) == set(gref)
    for name, g in gref.items():
        got = grads[name].grad.numpy()
        assert np.abs(got - g.numpy()).max() <= 1e-4 * max(1.0, np.abs(g.numpy()).max()), name


def test_b16_weights_and_head_go_to_jax_and_back_exactly():
    from chadavit_tpu_torch.models.chada_vit import random_state_dict
    from chadavit_tpu_torch.models.dino_head import random_head_state_dict

    m = chada_vit(depth=2, img_size=32, embed_dim=D, num_heads=HEADS)
    sd = {k: v.numpy() for k, v in random_state_dict(m, 7).items()}
    back = state_dict_from_jax_params(chada_vit_params_from_torch(sd, depth=2))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    head = DINOHead(D, num_prototypes=fixture.B16_PROTOTYPES)
    hsd = {k: v.numpy() for k, v in random_head_state_dict(head, 8).items()}
    assert hsd["last_layer.weight_v"].shape == (fixture.B16_PROTOTYPES, 256)
    hback = head_state_dict_from_jax_params(dino_head_params_from_torch(hsd))
    assert set(hback) == set(hsd)
    for k in hsd:
        np.testing.assert_array_equal(hback[k].numpy(), hsd[k], err_msg=k)
