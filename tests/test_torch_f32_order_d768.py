"""The float32 summation orders that ChAdaViT-B/16's K1a, K1c and K1b kernels
keep at D 768 (``tests/torch_f32_order.py``), held on the CPU against the port's
plain versions and, through a layer, against the JAX package's fused Pallas
layer kernel in interpret mode (as ``tests/test_torch_fused_block_d768.py``
runs it). On the card the kernels must equal these models bit for bit
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py`` phase 2c), so this
is what ties those bits to the JAX package.

B 2, S 128 (one 128-row block of the kernels and of the JAX kernel), D 768,
FFN 2048, 12 heads, valid lengths (1, 128) and (31, 33): a lone token, a
full image, and prefixes on either side of a 32-row tile edge.

Tolerances: each model against the plain version within 2e-5 absolute on
the rows of the computed 32-row tiles (readings on this data, worst of the
two cases: K1a's qkv 5.3e-6, its stats 1.2e-7; K1b's out 1.7e-6 at the
out-projection and 5.0e-6 at FFN2, r 3.8e-6 and 5.5e-6, stats 1.2e-7; K1c's
hid within HID_TOL, read 5.0e-6), and exact zeros on the other
rows; the layer built from the models (hid by K1c's order, as the kernels
compute it) against the
JAX kernel within 2e-5 absolute on the valid rows (read 3.8e-6), the bound
of the D 768 layer test.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.ops.fused_block import fused_encoder_block as jax_fused
from chadavit_tpu_torch.ops import flash_attention as fa
from chadavit_tpu_torch.ops import fused_block
from tests import torch_f32_order as order

B, S, D, H, F = 2, 128, 768, 12, 2048
EPS1, EPS2 = 1e-5, 1e-6
VALIDS = [(1, 128), (31, 33)]
TOL = 2e-5
# K1c's hid: the model and the plain version sum K 768 products in other
# orders (|hid| up to 4.7 here; the reading 5.0e-6, a few ulp of it)
HID_TOL = 1e-5


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _layer(case: int):
    """The layer's input and 12 parameters (numpy, nn.Linear layout) and, as
    torch tensors, the chain through the order models: K1a's (qkv, mean,
    rstd), the plain attention, K1b's out-projection (out, mean, rstd, r),
    K1c's hid and K1b's FFN2."""
    rng = np.random.default_rng(40 + case)
    x = _n(rng, B, S, D) * 2 + 0.5
    ws = [_n(rng, 3 * D, D, scale=D ** -0.5), _n(rng, 3 * D, scale=0.02),
          _n(rng, D, D, scale=D ** -0.5), _n(rng, D, scale=0.02),
          1 + _n(rng, D, scale=0.1), _n(rng, D, scale=0.05),
          1 + _n(rng, D, scale=0.1), _n(rng, D, scale=0.05),
          _n(rng, F, D, scale=D ** -0.5), _n(rng, F, scale=0.02),
          _n(rng, D, F, scale=F ** -0.5), _n(rng, D, scale=0.02)]
    valid = list(VALIDS[case])
    vl = torch.tensor(valid, dtype=torch.int32)
    xt = torch.from_numpy(x)
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = map(torch.from_numpy, ws)
    k1a = order.ln_linear_order(xt, g1, b1, EPS1, wqkv, bqkv, valid)
    qkv = k1a[0]
    attn = fa.prefix_flash_attention_reference(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:],
                                               vl, H)
    k1b_out = order.linear_residual_ln_order(attn, wout, bout, xt, g1, b1, EPS1, valid)
    hid = order.linear_relu_order(k1b_out[0], w1, b1f, valid)
    k1b_ffn2 = order.linear_residual_ln_order(hid, w2, b2f, k1b_out[0], g2, b2, EPS2, valid)
    return x, ws, valid, dict(k1a=k1a, attn=attn, k1b_out=k1b_out, hid=hid, k1b_ffn2=k1b_ffn2)


def _assert_close_and_zero(got, ref, valid, what):
    """``got`` within TOL of ``ref`` on the rows of the computed 32-row
    tiles, exact zeros on the others."""
    for i, n in enumerate(valid):
        rows = -(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK
        err = (got[i, :rows] - ref[i, :rows]).abs().max().item()
        assert err <= TOL, (what, i, err)
        assert not got[i, rows:].any().item(), (what, i, "past the computed tiles")


@pytest.mark.parametrize("case", range(len(VALIDS)))
def test_k1a_order_matches_the_plain_version(case):
    x, ws, valid, chain = _layer(case)
    w = [torch.from_numpy(t) for t in ws]
    ref = fused_block.ln_linear_reference(torch.from_numpy(x), w[4], w[5], EPS1, w[0], w[1],
                                          save=True)
    for got, r, what in zip(chain["k1a"], ref, ("qkv", "mean", "rstd")):
        _assert_close_and_zero(got, r, valid, what)


@pytest.mark.parametrize("case", range(len(VALIDS)))
def test_k1c_order_matches_the_plain_version(case):
    x, ws, valid, chain = _layer(case)
    w = [torch.from_numpy(t) for t in ws]
    ref = fused_block.linear_relu_reference(chain["k1b_out"][0], w[8], w[9])
    for i, n in enumerate(valid):
        rows = -(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK
        err = (chain["hid"][i, :rows] - ref[i, :rows]).abs().max().item()
        assert err <= HID_TOL, (i, err)
        assert not chain["hid"][i, rows:].any().item(), (i, "past the computed tiles")


@pytest.mark.parametrize("site", ["out", "ffn2"])
@pytest.mark.parametrize("case", range(len(VALIDS)))
def test_k1b_order_matches_the_plain_version(case, site):
    x, ws, valid, chain = _layer(case)
    w = [torch.from_numpy(t) for t in ws]
    if site == "out":
        args = (chain["attn"], w[2], w[3], torch.from_numpy(x), w[4], w[5], EPS1)
    else:
        args = (chain["hid"], w[10], w[11], chain["k1b_out"][0], w[6], w[7], EPS2)
    ref = fused_block.linear_residual_ln_reference(*args, save=True)
    for got, r, what in zip(chain[f"k1b_{site}"], ref, ("out", "mean", "rstd", "r")):
        _assert_close_and_zero(got, r, valid, f"{site} {what}")


@pytest.mark.parametrize("case", range(len(VALIDS)))
def test_layer_of_the_orders_matches_jax_fused_kernel(case):
    x, ws, valid, chain = _layer(case)
    jw = [jnp.asarray(w.T.copy() if w.ndim == 2 else w) for w in ws]
    ref = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(np.asarray(valid, np.int32)), *jw, H,
                               EPS1, EPS2, 128, True))
    got = chain["k1b_ffn2"][0].numpy()
    for i, n in enumerate(valid):
        err = np.abs(got[i, :n].astype(np.float64) - ref[i, :n]).max()
        assert err <= TOL, (i, n, err)
