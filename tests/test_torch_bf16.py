"""The port's bfloat16 kernels' plain versions held against the JAX package's
bfloat16 path on the CPU, and the gradient on the tail rows the forward
computes, in float32 and bfloat16.

At full width (D 192, 2 heads of 96, FFN 2048), B 3, S 256, valid lengths
256, 130 and 60: the prefix attention (JAX ``prefix_flash_attention`` in
interpret mode, its Pallas kernel and custom VJP) and the encoder layer (JAX
``fused_encoder_block`` in interpret mode) against the port's
``prefix_flash_attention`` and ``fused_encoder_block``, which run their plain
bfloat16 versions on CPU tensors; the LayerNorm against the JAX XLA one.

Both packages round at the same points (the JAX kernels' casts to the input
dtype) but sum in other orders, so a value can land on a neighbouring
bfloat16 (a relative step of 2^-8) and the chain carries such steps. (On the
CPU, XLA's excess precision also skips some of the JAX kernel's casts inside
its fusions.) Tolerances, measured on this data and stated per test: outputs
per valid row cosine >= 0.9999, and max abs <= 3e-2 where |ref| < 2. Where
|ref| >= 2 the layer's output can sit two bfloat16 steps from the JAX one:
one step of its pre-LN sum (2^-5 in [4, 8)) moves the output by about one
of its own steps at |y| in [2, 4), and its rounding adds another, 3.125e-2
in all (measured on this data: 32 entries, the first at sequence 0, row 10,
column 145: -2.078125 against JAX's -2.109375). Bfloat16 values in [2, 4)
lie 2^-6 apart, so no bound in [3e-2, 3.125e-2) separates them: those
entries are held to 3.125e-2, two steps there and one step at |y| >= 4.
Gradients: cosine >= 0.998 per tensor (the weight gradients sum rounded
products over every row).

The tail-cotangent tests are the port's counterpart of
``tests/test_fused_block.py::test_grad_parity_with_partial_tail_cotangent``:
the loss reads every row of the tiles that hold a valid row (32-row tiles for
the layer, 64-row query tiles for the attention), and the gradient must be
the true one. In float32: 1e-4 of the largest entry (at least 1), as the
port's other float32 gradient tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.ops.flash_attention import prefix_flash_attention as jax_flash
from chadavit_tpu.ops.fused_block import fused_encoder_block as jax_fused
from chadavit_tpu.ops.layernorm import layernorm as jax_layernorm
from chadavit_tpu_torch.ops import flash_attention, fused_block
from chadavit_tpu_torch.ops.layernorm import layernorm

B, S, D, H, F = 3, 256, 192, 2, 2048
VALID = [256, 130, 60]
EPS1, EPS2 = 1e-5, 1e-6
ROW_COS, ABS_BELOW, BIG, ABS_AT_BIG = 0.9999, 3e-2, 2.0, 2 * 2.0 ** -6
GRAD_COS = 0.998
F32_REL = 1e-4
NAMES = ["x", "wqkv", "bqkv", "wout", "bout", "g1", "b1", "g2", "b2", "w1", "b1f", "w2",
         "b2f"]


def _bf16(a):
    """numpy f32 -> the bfloat16 values, as f32 numpy (the one input both take)."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _weights(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return [n(3 * D, D, scale=D ** -0.5), n(3 * D, scale=0.1),
            n(D, D, scale=D ** -0.5), n(D, scale=0.1),
            1 + n(D, scale=0.1), n(D, scale=0.1), 1 + n(D, scale=0.1), n(D, scale=0.1),
            n(F, D, scale=D ** -0.5), n(F, scale=0.1),
            n(D, F, scale=F ** -0.5), n(D, scale=0.1)]


def _rows_upto(tile):
    """(B, S, 1) f32: 1 on every row of the tiles that hold a valid row."""
    w = np.zeros((B, S, 1), np.float32)
    for i, n in enumerate(VALID):
        w[i, :-(-n // tile) * tile] = 1.0
    return w


def _bf16_step(b):
    """The spacing of bfloat16 values at |b| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126))) - 7)


def _assert_rows_close(out, ref, rows):
    """bf16 outputs, per valid row: cosine, max abs 3e-2 where |ref| < 2, and
    3.125e-2 (two bf16 steps in [2, 4)) where |ref| >= 2."""
    for i, n in enumerate(rows):
        a, b = out[i, :n].astype(np.float64), ref[i, :n].astype(np.float64)
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        assert cos.min() >= ROW_COS, (i, cos.min())
        err, small = np.abs(a - b), np.abs(b) < BIG
        assert err[small].max(initial=0) <= ABS_BELOW, (i, err[small].max())
        assert err[~small].max(initial=0) <= ABS_AT_BIG, (i, err[~small].max())


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))


def _t(a):
    """JAX layout (in, out) of a matrix gradient -> nn.Linear (out, in)."""
    a = np.asarray(a, np.float32)
    return a.T if a.ndim == 2 else a


# ---- the attention --------------------------------------------------------------
def _qkv(seed):
    rng = np.random.default_rng(seed)
    return [_bf16(rng.standard_normal((B, S, D)).astype(np.float32)) for _ in range(3)]


def test_attention_forward_matches_jax():
    q, k, v = _qkv(0)
    vl = np.asarray(VALID, np.int32)
    ref = jax_flash(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), jnp.asarray(vl), H,
                    128, True)
    assert ref.dtype == jnp.bfloat16
    out = flash_attention.prefix_flash_attention(
        *(torch.from_numpy(t).bfloat16() for t in (q, k, v)), torch.from_numpy(vl), H)
    assert out.dtype == torch.bfloat16
    _assert_rows_close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), VALID)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_tail_cotangent_matches_jax_vjp(dtype):
    # the cotangent covers every row of the 64-query tiles that hold a valid
    # query; the forward computed those rows, so their gradient is exact
    q, k, v = _qkv(1)
    g = np.random.default_rng(2).standard_normal((B, S, D)).astype(np.float32)
    g = _bf16(g * _rows_upto(flash_attention.SEQ_BLOCK))
    vl = np.asarray(VALID, np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, jnp.asarray(vl), H, 128, True),
                     *(jnp.asarray(t, jdt) for t in (q, k, v)))
    ref = [np.asarray(r.astype(jnp.float32)) for r in vjp(jnp.asarray(g, jdt))]
    tdt = getattr(torch, dtype)
    qkv = [torch.from_numpy(t).to(tdt).requires_grad_(True) for t in (q, k, v)]
    out = flash_attention.prefix_flash_attention(*qkv, torch.from_numpy(vl), H)
    assert type(out.grad_fn).__name__ == "PrefixFlashAttentionBackward"
    got = [t.float().numpy() for t in torch.autograd.grad(out, qkv, torch.from_numpy(g).to(tdt))]
    for name, a, b in zip("qkv", got, ref):
        if dtype == "float32":
            assert np.abs(a - b).max() <= F32_REL * max(1.0, np.abs(b).max()), name
        else:
            assert _cos(a, b) >= GRAD_COS, (name, _cos(a, b))


def test_attention_tail_cotangent_matches_autograd_of_the_plain_forward():
    q, k, v = _qkv(3)
    g = np.random.default_rng(4).standard_normal((B, S, D)).astype(np.float32)
    g = torch.from_numpy(g * _rows_upto(flash_attention.SEQ_BLOCK))
    vl = torch.tensor(VALID, dtype=torch.int32)
    grads = []
    for fn in (flash_attention.prefix_flash_attention,
               flash_attention.prefix_flash_attention_reference):
        qkv = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*qkv, vl, H), qkv, g))
    for name, a, b in zip("qkv", *grads):
        assert (a - b).abs().max() <= F32_REL * max(1.0, b.abs().max().item()), name


# ---- the layer --------------------------------------------------------------------
def _jax_weights(ws):
    return [jnp.asarray(w.T.copy() if w.ndim == 2 else w) for w in ws]


def test_layer_forward_matches_jax():
    ws = _weights(0)
    x = _bf16(np.random.default_rng(5).standard_normal((B, S, D)).astype(np.float32))
    vl = np.asarray(VALID, np.int32)
    ref = jax_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(vl), *_jax_weights(ws), H,
                    EPS1, EPS2, 128, True)
    assert ref.dtype == jnp.bfloat16
    out = fused_block.fused_encoder_block(torch.from_numpy(x).bfloat16(),
                                          torch.from_numpy(vl),
                                          *map(torch.from_numpy, ws), H, EPS1, EPS2)
    assert out.dtype == torch.bfloat16
    _assert_rows_close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), VALID)


def _layer_grads(layer, x, ws, vl, wrows, tgt, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    y = layer(xt, torch.from_numpy(vl), *wt, H, EPS1, EPS2)
    loss = ((torch.from_numpy(wrows) * (y.float() - torch.from_numpy(tgt))) ** 2).sum()
    return [g.float().numpy() for g in torch.autograd.grad(loss, [xt, *wt])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_tail_cotangent_matches_jax_vjp(dtype):
    # a non-LN-invariant loss, sum((y - target)^2) over every row of the
    # 32-row tiles that hold a valid row: the JAX kernel computes those rows
    # for real too (its 128-row blocks cover them), so its VJP is the truth
    ws = _weights(1)
    rng = np.random.default_rng(6)
    x = _bf16(rng.standard_normal((B, S, D)).astype(np.float32))
    tgt = rng.standard_normal((B, S, D)).astype(np.float32)
    vl = np.asarray(VALID, np.int32)
    wrows = _rows_upto(fused_block.ROW_BLOCK)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def jloss(x_, *w_):
        y = jax_fused(x_, jnp.asarray(vl), *w_, H, EPS1, EPS2, 128, True)
        return jnp.sum((wrows * (y.astype(jnp.float32) - tgt)) ** 2)

    ref = jax.grad(jloss, argnums=tuple(range(13)))(jnp.asarray(x, jdt), *_jax_weights(ws))
    ref = [_t(r.astype(jnp.float32)) for r in ref]
    got = _layer_grads(fused_block.fused_encoder_block, x, ws, vl, wrows, tgt,
                       getattr(torch, dtype))
    rows = [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in VALID]
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_tail_cotangent_matches_autograd_of_the_plain_forward(dtype):
    # the Function's plain backward chain against torch autograd through the
    # plain forward chain; in bf16 autograd rounds its gradients at other
    # points than the chain, so the bf16 bound is the cosine one
    ws = _weights(2)
    rng = np.random.default_rng(7)
    x = _bf16(rng.standard_normal((B, S, D)).astype(np.float32))
    tgt = rng.standard_normal((B, S, D)).astype(np.float32)
    vl = np.asarray(VALID, np.int32)
    wrows = _rows_upto(fused_block.ROW_BLOCK)
    tdt = getattr(torch, dtype)
    got = _layer_grads(fused_block.fused_encoder_block, x, ws, vl, wrows, tgt, tdt)
    ref = _layer_grads(fused_block.fused_encoder_block_reference, x, ws, vl, wrows, tgt, tdt)
    rows = [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in VALID]
    for name, a, b in zip(NAMES, got, ref):
        if name == "x":
            a = np.concatenate([a[i, :n] for i, n in enumerate(rows)])
            b = np.concatenate([b[i, :n] for i, n in enumerate(rows)])
        if dtype == "float32":
            assert np.abs(a - b).max() <= F32_REL * max(1.0, np.abs(b).max()), name
        else:
            assert _cos(a, b) >= GRAD_COS, (name, _cos(a, b))


def test_layer_saves_bf16_residuals_and_returns_f32_parameter_gradients():
    ws = [torch.from_numpy(w) for w in _weights(3)]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((B, S, D))
                         .astype(np.float32)).bfloat16()
    vl = torch.tensor(VALID, dtype=torch.int32)
    y, (attn, x2, r2, lse, stats) = fused_block.layer_forward(
        fused_block.PLAIN_STEPS, x, vl, tuple(ws), H, EPS1, EPS2, save=True)
    assert all(t.dtype == torch.bfloat16 for t in (y, attn, x2, r2))
    assert lse.dtype == torch.float32 and all(t.dtype == torch.float32 for t in stats)
    grads = fused_block.fused_encoder_block_backward_reference(
        torch.ones_like(y), x, vl, attn, x2, r2, lse, stats, tuple(ws), H, EPS1)
    assert grads[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in grads[1:])
    packed = fused_block.pack_weights(tuple(ws), torch.bfloat16)
    assert [t.dtype for t in packed] == [torch.bfloat16] * 4 + [torch.float32] * 4 \
        + [torch.bfloat16] * 4


# ---- the LayerNorm ----------------------------------------------------------------
@pytest.mark.parametrize("with_residual", [False, True])
def test_layernorm_matches_jax_xla(with_residual):
    rng = np.random.default_rng(9)
    x, r = (_bf16(rng.standard_normal((B, 40, D)).astype(np.float32) * 2) for _ in range(2))
    scale = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(D)).astype(np.float32)
    res = r if with_residual else None
    ref = jax_layernorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias),
                        EPS2, impl="xla",
                        residual=None if res is None else jnp.asarray(res, jnp.bfloat16))
    out = layernorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                    torch.from_numpy(bias), EPS2,
                    residual=None if res is None else torch.from_numpy(res).bfloat16())
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    # f32 stats of the same bf16 sums: at most one bf16 step apart
    a, b = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert (np.abs(a - b) <= _bf16_step(b)).all()
