"""The port's encoder layer at ChAdaViT-B/16's widths (D 768, 12 heads of 64,
FFN 2048) held against the JAX package's fused Pallas layer kernel in
interpret mode on the CPU, forward and ``jax.vjp`` (dx and the 12 parameter
gradients), in float32 and bfloat16. JAX's ``EncoderLayer`` takes that
kernel for B/16 wherever its VMEM estimate fits (1-7 channels in bfloat16,
1-3 in float32), and so does the port's layer, whose chain has D 768
instances of every step; on the CPU each step runs its plain version, which
the kernels are held to on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py`` phase 2c).

B 2, S 256, valid lengths 256 and 100: the JAX kernel's 128-row blocks skip
the second image's last block, and the port's 32-row tiles its last four.
The cotangent is that of sum((y - target)^2) over every row of the 32-row
tiles that hold a valid row (the JAX kernel computes those rows for real
too, so its VJP is the truth there).

Tolerances, a few times the readings on this data on the CPU. float32: the
output within 2e-5 absolute on the valid rows (read: 2.4e-6), the gradients
within 1e-4 of their largest entry (at least 1; read: 5.9e-7), the bound of
the port's other float32 gradient tests. bfloat16 (both packages round at
the JAX kernel's casts but sum in other orders, so a value can land on a
neighbouring bfloat16; on the CPU XLA's excess precision also skips some of
the JAX kernel's casts): per valid row a cosine of at least 0.9999 (read:
1 - 1.3e-5) and a max abs of 4 bfloat16 steps at the row's largest entry
(read: 2); the gradients a cosine of at least 0.995 per tensor (read:
1 - 9.3e-4 on W1, whose gradient moves with each FFN hidden entry whose
ReLU mask the two packages' bfloat16 sums put on opposite sides of 0; the
other tensors read 1 - 3.7e-4 or better).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.ops.fused_block import fused_encoder_block as jax_fused
from chadavit_tpu_torch.ops import fused_block

B, S, D, H, F = 2, 256, 768, 12, 2048
VALID = [256, 100]
EPS1, EPS2 = 1e-5, 1e-6
F32_ABS, F32_REL = 2e-5, 1e-4
ROW_COS, ROW_STEPS, GRAD_COS = 0.9999, 4, 0.995
NAMES = ["x", "wqkv", "bqkv", "wout", "bout", "g1", "b1", "g2", "b2", "w1", "b1f", "w2",
         "b2f"]


def _weights(seed):
    """The 12 layer parameters in nn.Linear layout (out, in), as numpy."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return [n(3 * D, D, scale=D ** -0.5), n(3 * D, scale=0.02),
            n(D, D, scale=D ** -0.5), n(D, scale=0.02),
            1 + n(D, scale=0.1), n(D, scale=0.05), 1 + n(D, scale=0.1), n(D, scale=0.05),
            n(F, D, scale=D ** -0.5), n(F, scale=0.02),
            n(D, F, scale=F ** -0.5), n(D, scale=0.02)]


def _jax_weights(ws):
    """The JAX kernels' (in, out) layout."""
    return [jnp.asarray(w.T.copy() if w.ndim == 2 else w) for w in ws]


def _x(seed, dtype):
    """The layer input, rounded to bfloat16 for the bfloat16 runs (the one
    input both packages take)."""
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _rows():
    """Rows of each image the port computes: its 32-row tiles that hold a valid row."""
    return [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in VALID]


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_d768_layer_forward_matches_jax_fused_kernel(dtype):
    ws, x, vl = _weights(0), _x(1, dtype), np.asarray(VALID, np.int32)
    jdt = getattr(jnp, dtype)
    ref = jax_fused(jnp.asarray(x, jdt), jnp.asarray(vl), *_jax_weights(ws), H, EPS1, EPS2,
                    128, True)
    out = fused_block.fused_encoder_block(torch.from_numpy(x).to(getattr(torch, dtype)),
                                          torch.from_numpy(vl), *map(torch.from_numpy, ws),
                                          H, EPS1, EPS2)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, S, D)
    out, ref = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    for i, n in enumerate(VALID):
        a, b = out[i, :n].astype(np.float64), ref[i, :n].astype(np.float64)
        if dtype == "float32":
            assert np.abs(a - b).max() <= F32_ABS, (i, np.abs(a - b).max())
            continue
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        assert cos.min() >= ROW_COS, (i, cos.min())
        step = 2.0 ** (np.floor(np.log2(np.abs(b).max(-1))) - 7)
        assert (np.abs(a - b).max(-1) <= ROW_STEPS * step).all(), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_d768_layer_vjp_matches_jax_fused_kernel(dtype):
    ws = _weights(2)
    rng = np.random.default_rng(3)
    x = _x(4, dtype)
    tgt = rng.standard_normal((B, S, D)).astype(np.float32)
    vl = np.asarray(VALID, np.int32)
    rows = _rows()
    wrows = np.zeros((B, S, 1), np.float32)
    for i, n in enumerate(rows):
        wrows[i, :n] = 1.0
    jdt = getattr(jnp, dtype)

    def jloss(x_, *w_):
        y = jax_fused(x_, jnp.asarray(vl), *w_, H, EPS1, EPS2, 128, True)
        return jnp.sum((wrows * (y.astype(jnp.float32) - tgt)) ** 2)

    ref = jax.grad(jloss, argnums=tuple(range(13)))(jnp.asarray(x, jdt), *_jax_weights(ws))
    ref = [np.asarray(r.astype(jnp.float32)) for r in ref]
    ref = [r.T if r.ndim == 2 else r for r in ref]
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    wt = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    y = fused_block.fused_encoder_block(xt, torch.from_numpy(vl), *wt, H, EPS1, EPS2)
    loss = ((torch.from_numpy(wrows) * (y.float() - torch.from_numpy(tgt))) ** 2).sum()
    got = [g.float().numpy() for g in torch.autograd.grad(loss, [xt, *wt])]
    assert all(g.dtype == torch.float32 for g in torch.autograd.grad(
        fused_block.fused_encoder_block(xt, torch.from_numpy(vl), *wt, H, EPS1, EPS2).float()
        .sum(), wt))
    dx = np.concatenate([got[0][i, :n] for i, n in enumerate(rows)])
    dx_ref = np.concatenate([ref[0][i, :n] for i, n in enumerate(rows)])
    for name, a, b in zip(NAMES, [dx] + got[1:], [dx_ref] + ref[1:]):
        assert a.shape == b.shape, name
        if dtype == "float32":
            assert np.abs(a - b).max() <= F32_REL * max(1.0, np.abs(b).max()), name
        else:
            assert _cos(a, b) >= GRAD_COS, (name, _cos(a, b))
    for i, n in enumerate(rows):  # the zero-filled tiles get dx = 0
        assert not got[0][i, n:].any()
