"""The port's compute dtype on its entry points, on the CPU: the factory
``chada_vit(**kwargs)`` reads the JAX factory's keys and raises on the values
it does not honour; a bfloat16 model, head or trainer keeps every parameter in
float32 (LayerNorm scale and bias included); the hub's ``dtype`` is the compute
dtype, as in the JAX hub, and its bfloat16 CLS matches the JAX hub's; the
trainer's batch comes in the spec's dtype; and a bfloat16 call on the CUDA
route (the launch stubbed) reaches the bfloat16 entry point of every kernel,
with nothing cast quietly to float32.

Tolerance of the hub comparison: bfloat16 on both sides through 12 layers,
rounded at the same points and summed in other orders: cosine >= 0.999 per
row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu import hub as jax_hub
from chadavit_tpu.models.import_torch import chada_vit_params_from_torch
from chadavit_tpu_torch import hub
from chadavit_tpu_torch.models.chada_vit import ChAdaViT, EncoderLayer, chada_vit
from chadavit_tpu_torch.models.dino_head import DINOHead
from chadavit_tpu_torch.ops import flash_attention, fused_block
from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, build_dino, synthetic_dino_batch
from tests.test_torch_fused_block_backward import fake_cuda  # noqa: F401 (a fixture)

SMALL = dict(embed_dim=32, depth=1, num_heads=2, img_size=32, max_number_channels=2)
HUB_COS = 0.999
MOYEN_HD = 96  # ChAdaViT-moyen's head width (D 192, 2 heads)


# ---- the factory ------------------------------------------------------------------
@pytest.mark.parametrize("key, value", [
    ("dtype", torch.float32), ("dtype", torch.bfloat16), ("param_dtype", torch.float32),
    ("attn_impl", "auto"), ("ln_impl", "auto"), ("ln_impl", "xla"), ("ln_impl", "pallas"),
    ("seq_pad_multiple", 128), ("patch_embed_conv", True), ("patch_embed_conv", False),
    ("shard_mesh", None)])
def test_factory_accepts_the_jax_defaults_and_the_honoured_values(key, value):
    m = chada_vit(**SMALL, **{key: value})
    assert isinstance(m, ChAdaViT)
    if key == "dtype":
        assert m.dtype == value and all(b.dtype == value for b in m.blocks)


@pytest.mark.parametrize("key, value", [
    ("dtype", torch.float16), ("param_dtype", torch.bfloat16), ("attn_impl", "pallas"),
    ("attn_impl", "xla"), ("ln_impl", "triton"), ("seq_pad_multiple", 0),
    ("seq_pad_multiple", 256), ("shard_mesh", object())])
def test_factory_raises_on_each_value_it_does_not_honour(key, value):
    with pytest.raises(NotImplementedError, match=key):
        chada_vit(**SMALL, **{key: value})


def test_modules_refuse_other_dtypes():
    with pytest.raises(NotImplementedError, match="dtype"):
        EncoderLayer(32, 2, 64, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="param_dtype"):
        ChAdaViT(img_size=32, embed_dim=32, depth=1, param_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="dtype"):
        DINOHead(32, 16, dtype=torch.float16)


# ---- float32 parameters under a bfloat16 compute dtype -----------------------------
def test_bf16_model_keeps_float32_parameters_and_computes_in_bf16():
    m = chada_vit(**SMALL, return_all_tokens=False, dtype=torch.bfloat16)
    sd = m.state_dict()
    assert all(t.dtype == torch.float32 for t in sd.values())
    assert sd["blocks.0.norm1.weight"].dtype == torch.float32  # LN gamma/beta too
    assert sd["norm.bias"].dtype == torch.float32
    x = torch.rand(3, 2, 32, 32)
    emb = m(x, torch.tensor([2, 1, 2], dtype=torch.int32))
    assert emb.dtype == torch.bfloat16 and emb.shape == (3, 32)
    tokens, _ = m.tokenize(x, torch.tensor([2, 1, 2], dtype=torch.int32))
    assert tokens.dtype == torch.bfloat16


def test_bf16_unfused_layer_and_attention_weights_run():
    # block_impl="xla", the plain layer, computes in bf16 too
    m = chada_vit(**SMALL, return_all_tokens=False, block_impl="xla", dtype=torch.bfloat16)
    emb = m(torch.rand(2, 2, 32, 32), torch.tensor([1, 2], dtype=torch.int32))
    assert emb.dtype == torch.bfloat16 and torch.isfinite(emb.float()).all()
    attn = m.get_last_selfattention(torch.rand(2, 1, 32, 32))
    assert attn.shape == (2, 2, 5, 5) and torch.isfinite(attn).all()


def test_bf16_trainer_keeps_float32_state_and_takes_bf16_batches():
    spec = DinoPretrainSpec(
        backbone_kwargs=dict(embed_dim=32, patch_size=16, return_all_tokens=False,
                             max_number_channels=2, depth=1, num_heads=2),
        img_size=32, max_channels=2, proj_hidden_dim=16, proj_output_dim=8,
        num_prototypes=16, dtype=torch.bfloat16)
    state, step, model, head = build_dino(spec, device="cpu")
    assert model.dtype == torch.bfloat16 and head.dtype == torch.bfloat16
    for side in (state.student, state.teacher):
        for part in ("backbone", "head"):
            assert all(t.dtype == torch.float32 for t in side[part].state_dict().values())
    batch = synthetic_dino_batch(spec, 3, device="cpu")
    assert batch["crops"].dtype == torch.bfloat16
    state, m = step(state, batch)
    assert torch.isfinite(m["dino_loss"]) and m["dino_loss"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for _, p in state.trainable())
    assert state.center.dtype == torch.float32


def test_trainer_refuses_other_dtypes():
    with pytest.raises(NotImplementedError, match="dtype"):
        build_dino(DinoPretrainSpec(dtype=torch.float16), device="cpu")


# ---- the hub ----------------------------------------------------------------------------
def test_hub_dtype_is_the_compute_dtype_and_matches_the_jax_hub():
    model = hub.load_chadavit16_moyen(img_size=32, dtype=torch.bfloat16, device="cpu", seed=3)
    sd = model.state_dict()
    assert all(t.dtype == torch.float32 for t in sd.values())
    images = hub.random_images([1, 4, 10, 3], img_size=32, seed=4)
    embs = hub.extract_embeddings(model, images, batch_size=2)
    assert embs.dtype == np.float32 and embs.shape == (4, 192)

    jax_model, _ = jax_hub.load_chadavit16_moyen(None, img_size=32, dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(
        jnp.asarray, chada_vit_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                                 depth=12))
    ref = np.asarray(jax_hub.extract_embeddings(jax_model, {"params": params}, images,
                                                batch_size=2), np.float32)
    cos = (embs * ref).sum(-1) / (np.linalg.norm(embs, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= HUB_COS, cos
    # a bf16 run, not the f32 one
    f32 = hub.extract_embeddings(hub.load_chadavit16_moyen(img_size=32, device="cpu", seed=3),
                                 images, batch_size=2)
    assert not np.array_equal(embs, f32)


# ---- the CUDA route in bfloat16, with the launch stubbed ----------------------------
def _z(*shape, dtype=torch.bfloat16, requires_grad=False):
    return torch.zeros(shape, dtype=dtype, requires_grad=requires_grad)


def _f32_weights(requires_grad):
    d, f = fused_block.D_MODEL, fused_block.D_FFN
    shapes = [(3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,), (d,), (d,), (f, d), (f,),
              (d, f), (d,)]
    return [_z(*s, dtype=torch.float32, requires_grad=requires_grad) for s in shapes]


def test_cuda_route_bf16_layer_reaches_the_bf16_kernels(fake_cuda):
    ws = _f32_weights(True)
    x = _z(2, 128, fused_block.D_MODEL, requires_grad=True)
    vl = torch.tensor([128, 3], dtype=torch.int32)
    y = fused_block.fused_encoder_block(x, vl, *ws, 2)
    assert y.dtype == torch.bfloat16
    forward = ["ln_linear_fwd_bf16", "prefix_attention_fwd_bf16", "linear_residual_ln_fwd_bf16",
               "linear_relu_fwd_bf16", "linear_residual_ln_fwd_bf16"]
    assert fake_cuda.calls == forward
    y.backward(torch.zeros_like(y))
    backward = fake_cuda.calls[len(forward):]
    assert all(name.endswith("_bf16") for name in backward)
    assert [backward.count(k + "_bf16") for k in ("layernorm_bwd", "linear_dgrad",
                                                  "linear_wgrad", "prefix_attention_bwd")] \
        == [3, 4, 4, 1]
    assert x.grad.dtype == torch.bfloat16
    assert all(w.grad is not None and w.grad.dtype == torch.float32 for w in ws)


def test_cuda_route_bf16_attention_reaches_the_bf16_kernels(fake_cuda):
    q, k, v = (_z(2, 128, 2 * MOYEN_HD, requires_grad=True) for _ in range(3))
    vl = torch.tensor([128, 3], dtype=torch.int32)
    out = flash_attention.prefix_flash_attention(q, k, v, vl, 2)
    out.backward(torch.zeros_like(out))
    assert fake_cuda.calls == ["prefix_attention_fwd_bf16", "prefix_attention_bwd_bf16"]
    assert q.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["bf16_ln_params", "mixed_activations", "float16"])
def test_cuda_route_refuses_what_has_no_kernel(fake_cuda, case):
    d = fused_block.D_MODEL
    x = _z(2, 128, d)
    vl = torch.tensor([128, 3], dtype=torch.int32)
    wqkv, bqkv = _z(3 * d, d), _z(3 * d)
    g, b = _z(d, dtype=torch.float32), _z(d, dtype=torch.float32)
    if case == "bf16_ln_params":  # LN parameters stay f32: no quiet cast
        g = g.bfloat16()
    elif case == "mixed_activations":  # one activation dtype per call
        wqkv = wqkv.float()
    else:
        x, wqkv, bqkv = x.half(), wqkv.half(), bqkv.half()
    with torch.no_grad(), pytest.raises(TypeError):
        fused_block.ln_linear(x, g, b, 1e-5, wqkv, bqkv, vl)
    assert fake_cuda.calls == []


def test_cuda_route_bf16_operands_need_8_byte_alignment(fake_cuda):
    d = fused_block.D_MODEL
    buf = _z(2 * 128 * d + 2)
    x = buf[2:].view(2, 128, d)  # 4 bytes past an 8-byte boundary
    vl = torch.tensor([128, 3], dtype=torch.int32)
    with torch.no_grad(), pytest.raises(ValueError, match="aligned"):
        fused_block.linear_relu(x, _z(fused_block.D_FFN, d), _z(fused_block.D_FFN), vl)
    assert fake_cuda.calls == []
