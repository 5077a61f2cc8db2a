"""The port's encoder-layer chain (chadavit_tpu_torch/ops/fused_block.py) held
against the JAX package on the CPU: the fused Pallas kernel in interpret mode,
one unfused JAX EncoderLayer (block_impl="xla"), and the JAX expression of
each GEMM step.

On the CPU every step runs its plain version; the CUDA kernels are held
against those on the card (test_torch_kernels_gpu.py, chip_smoke.py).
Tolerance: float32 on both sides, 3e-5 absolute and relative after two
LayerNorms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.models.chada_vit import EncoderLayer as JaxEncoderLayer
from chadavit_tpu.ops.fused_block import fused_encoder_block as jax_fused
from chadavit_tpu.ops.layernorm import layernorm as jax_layernorm
from chadavit_tpu_torch.models.chada_vit import EncoderLayer as PortEncoderLayer
from chadavit_tpu_torch.ops import _build, _launch, attention, flash_attention, fused_block

B, S, D, H, F = 3, 256, 32, 2, 64
VALID = [256, 130, 60]  # 60 < 128 leaves a whole sequence block to skip
EPS1, EPS2 = 1e-5, 1e-6
TOL = dict(rtol=3e-5, atol=3e-5)


def _weights(seed=0):
    """The 12 layer parameters in nn.Linear layout (out, in), as numpy."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return [n(3 * D, D, scale=D ** -0.5), n(3 * D, scale=0.1),
            n(D, D, scale=D ** -0.5), n(D, scale=0.1),
            1 + n(D, scale=0.1), n(D, scale=0.1), 1 + n(D, scale=0.1), n(D, scale=0.1),
            n(F, D, scale=D ** -0.5), n(F, scale=0.1),
            n(D, F, scale=F ** -0.5), n(D, scale=0.1)]


def _jax_layout(ws):
    """Transpose the matrices to the JAX kernels' (in, out) layout."""
    return [w.T.copy() if w.ndim == 2 else w for w in ws]


def _x(seed=1, s=S):
    return np.random.default_rng(seed).standard_normal((B, s, D)).astype(np.float32)


def _port(x, vl, ws):
    return fused_block.fused_encoder_block(
        torch.from_numpy(x), torch.from_numpy(vl), *map(torch.from_numpy, ws),
        H, EPS1, EPS2).numpy()


def _assert_valid_rows_close(out, ref, valid, **tol):
    for i, n in enumerate(valid):
        np.testing.assert_allclose(np.asarray(out)[i, :n], np.asarray(ref)[i, :n], **tol)


def test_matches_jax_fused_kernel_interpret():
    ws, x, vl = _weights(), _x(), np.asarray(VALID, np.int32)
    ref = jax_fused(jnp.asarray(x), jnp.asarray(vl), *map(jnp.asarray, _jax_layout(ws)),
                    H, EPS1, EPS2, 128, True)
    _assert_valid_rows_close(_port(x, vl, ws), ref, vl, **TOL)


@pytest.mark.parametrize("s", [256, 200])  # 200: the chain pads to 256 and slices
def test_matches_jax_unfused_encoder_layer(s):
    ws, x = _weights(2), _x(3, s)
    vl = np.minimum(np.asarray(VALID, np.int32), s)
    (wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f) = _jax_layout(ws)
    params = {"in_proj_kernel": wqkv, "in_proj_bias": bqkv,
              "out_proj_kernel": wout, "out_proj_bias": bout,
              "norm1": {"scale": g1, "bias": b1}, "norm2": {"scale": g2, "bias": b2},
              "linear1": {"kernel": w1, "bias": b1f}, "linear2": {"kernel": w2, "bias": b2f}}
    layer = JaxEncoderLayer(embed_dim=D, num_heads=H, ffn_dim=F, layer_norm_eps=EPS1,
                            attn_impl="xla", block_impl="xla")
    mask = np.arange(s)[None, :] >= vl[:, None]
    ref = layer.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                      jnp.asarray(x), jnp.asarray(mask), valid_len=jnp.asarray(vl))
    # the JAX layer uses one eps for both norms
    out = fused_block.fused_encoder_block(
        torch.from_numpy(x), torch.from_numpy(vl), *map(torch.from_numpy, ws),
        H, EPS1, EPS1).numpy()
    assert out.shape == (B, s, D)
    _assert_valid_rows_close(out, ref, vl, **TOL)


def test_ln_linear_matches_jax():
    ws, x = _weights(4), _x(5)
    wqkv, bqkv, g1, b1 = ws[0], ws[1], ws[4], ws[5]
    ref = jnp.dot(jax_layernorm(jnp.asarray(x), jnp.asarray(g1), jnp.asarray(b1), EPS1),
                  jnp.asarray(wqkv.T)) + bqkv
    out = fused_block.ln_linear(torch.from_numpy(x), torch.from_numpy(g1),
                                torch.from_numpy(b1), EPS1, torch.from_numpy(wqkv),
                                torch.from_numpy(bqkv),
                                torch.from_numpy(np.asarray(VALID, np.int32)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_linear_relu_matches_jax():
    ws, x = _weights(6), _x(7)
    w1, b1f = ws[8], ws[9]
    ref = jax.nn.relu(jnp.dot(jnp.asarray(x), jnp.asarray(w1.T)) + b1f)
    out = fused_block.linear_relu(torch.from_numpy(x), torch.from_numpy(w1),
                                  torch.from_numpy(b1f),
                                  torch.from_numpy(np.asarray(VALID, np.int32)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("k", [D, F])  # the out-projection site and the FFN2 site
def test_linear_residual_ln_matches_jax(k):
    rng = np.random.default_rng(8)
    a = rng.standard_normal((B, S, k)).astype(np.float32)
    w = (rng.standard_normal((D, k)) * k ** -0.5).astype(np.float32)
    bias, g, b = (rng.standard_normal(D).astype(np.float32) * 0.1 for _ in range(3))
    g = g + 1
    res = _x(9)
    ref = jax_layernorm(jnp.dot(jnp.asarray(a), jnp.asarray(w.T)) + bias, jnp.asarray(g),
                        jnp.asarray(b), EPS2, residual=jnp.asarray(res))
    out = fused_block.linear_residual_ln(
        *map(torch.from_numpy, (a, w, bias, res, g, b)), EPS2,
        torch.from_numpy(np.asarray(VALID, np.int32)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_chain_on_cpu_is_its_plain_version_and_launches_nothing():
    ws, x, vl = _weights(10), _x(11), np.asarray(VALID, np.int32)
    counts = dict(_launch.LAUNCHES)
    out = _port(x, vl, ws)
    ref = fused_block.fused_encoder_block_reference(
        torch.from_numpy(x), torch.from_numpy(vl), *map(torch.from_numpy, ws),
        H, EPS1, EPS2).numpy()
    np.testing.assert_array_equal(out, ref)
    assert dict(_launch.LAUNCHES) == counts


# ---- the CUDA route: a kernel or an error, never the plain version ----------
@pytest.fixture
def cuda_route(monkeypatch):
    """The wrappers take their CUDA route with CPU tensors: every check before
    a launch runs, and reaching the launch raises KernelReached."""
    def library():
        raise KernelReached
    monkeypatch.setattr(_launch, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(_build, "library", library)


class KernelReached(Exception):
    pass


def _t(*shape):
    return torch.zeros(shape)


def _hub_steps(d, f, heads):
    """One call of each kernel wrapper and of the layer at widths d, f."""
    x, vl = _t(2, 64, d), torch.tensor([64, 3], dtype=torch.int32)
    ws = [_t(3 * d, d), _t(3 * d), _t(d, d), _t(d), _t(d), _t(d), _t(d), _t(d),
          _t(f, d), _t(f), _t(d, f), _t(d)]
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = ws
    return {
        "ln_linear": lambda: fused_block.ln_linear(x, g1, b1, EPS1, wqkv, bqkv, vl),
        "linear_relu": lambda: fused_block.linear_relu(x, w1, b1f, vl),
        "linear_residual_ln": lambda: fused_block.linear_residual_ln(
            _t(2, 64, f), w2, b2f, x, g2, b2, EPS2, vl),
        "prefix_flash_attention": lambda: flash_attention.prefix_flash_attention(
            x, x, x, vl, heads),
        "masked_multihead_attention": lambda: attention.masked_multihead_attention(
            x, x, x, None, heads, valid_len=vl),
        "fused_encoder_block": lambda: fused_block.fused_encoder_block(
            x, vl, *ws, heads),
        "EncoderLayer": lambda: PortEncoderLayer(d, heads, f)(x, None, valid_len=vl),
    }


STEPS = ["ln_linear", "linear_relu", "linear_residual_ln", "prefix_flash_attention",
         "masked_multihead_attention", "fused_encoder_block", "EncoderLayer"]


# the kernel wrappers refuse a width they are not built for (ValueError); the
# layer chain, whose instances at other widths are not ported, raises
# NotImplementedError naming them
REFUSAL = {"fused_encoder_block": NotImplementedError, "EncoderLayer": NotImplementedError}


@pytest.mark.parametrize("step", STEPS)
def test_cuda_route_refuses_widths_the_kernels_are_not_built_for(cuda_route, step):
    with pytest.raises(REFUSAL.get(step, ValueError)):
        _hub_steps(D, F, H)[step]()


@pytest.mark.parametrize("step", STEPS)
def test_cuda_route_refuses_a_width_between_the_built_ones(cuda_route, step):
    # D 384 in 3 heads of 128, where the JAX gate says fused
    with pytest.raises(REFUSAL.get(step, ValueError)):
        _hub_steps(384, 2048, 3)[step]()


@pytest.mark.parametrize("step", STEPS)
def test_cuda_route_launches_at_the_served_widths(cuda_route, step):
    with pytest.raises(KernelReached):
        _hub_steps(fused_block.D_MODEL, fused_block.D_FFN, 2)[step]()


@pytest.mark.parametrize("step", STEPS)
def test_cuda_route_launches_at_the_b16_widths(cuda_route, step):
    # ChAdaViT-B/16: D 768 in 12 heads of 64, FFN 2048
    with pytest.raises(KernelReached):
        _hub_steps(768, 2048, 12)[step]()


def test_chain_needs_valid_len(cuda_route):
    with pytest.raises(ValueError, match="valid_len"):
        fused_block.fused_encoder_block(_t(1, 64, fused_block.D_MODEL), None,
                                        *([None] * 12), 2)
