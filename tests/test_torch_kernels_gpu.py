"""Each CUDA kernel of chadavit_tpu_torch against its plain PyTorch version,
on the card, at the widths of ChAdaViT-moyen (D 192, 2 heads of 96, FFN 2048)
with ragged prefixes (single-token, partial and full, row tiles past the
prefix), the forward kernels and the backward kernels (each on the inputs
the layer's backward chain gives it), and the gradients of the layer and of
the attention through their autograd Functions; then the bfloat16 instances
the same way, and the gradients with a cotangent on the tail rows the
forward computes, in both dtypes. Marked ``gpu``; skips without
a CUDA device. It imports no JAX, so on the card's machine it runs without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerance: float32 on both sides, 1e-4 absolute on the rows < valid_len; for
gradients, 1e-4 times the largest entry of the reference where that exceeds 1
(weight gradients sum over every valid row).
"""

import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from chadavit_tpu_torch.ops import _launch, fused_block
from chadavit_tpu_torch.ops import flash_attention as fa
from chip_smoke import BF16_COS, Recorder, bf16_err

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, dev, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


def _assert_valid_rows_close(out, ref, valid):
    torch.cuda.synchronize()
    for i, n in enumerate(valid):
        err = (out[i, :n] - ref[i, :n]).abs().max().item()
        assert err <= TOL, (i, n, err)


D, HEADS, F = fused_block.D_MODEL, 2, fused_block.D_FFN
VALIDS = [[256, 200, 65, 1], [1, 97, 129, 255], [197, 589, 33, 64]]


@pytest.mark.parametrize("valid", VALIDS)
def test_prefix_attention(dev, valid):
    rng = np.random.default_rng(sum(valid))
    s = max(256, -(-max(valid) // 64) * 64)
    qkv = _randn(rng, dev, len(valid), s, 3 * D)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    before = _launch.LAUNCHES["prefix_attention_fwd"]
    out = fa.prefix_flash_attention(q, k, v, vl, HEADS)
    assert _launch.LAUNCHES["prefix_attention_fwd"] == before + 1
    _assert_valid_rows_close(out, fa.prefix_flash_attention_reference(q, k, v, vl, HEADS), valid)
    # query blocks wholly past the prefix are written as zeros
    for i, n in enumerate(valid):
        assert not out[i, -(-n // 64) * 64:].any().item()


@pytest.mark.parametrize("valid", VALIDS)
def test_gemm_steps_and_chain(dev, valid):
    rng = np.random.default_rng(sum(valid))
    s = -(-max(valid) // 128) * 128
    x = _randn(rng, dev, len(valid), s, D)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    w = [_randn(rng, dev, 3 * D, D, scale=D ** -0.5), _randn(rng, dev, 3 * D, scale=0.1),
         _randn(rng, dev, D, D, scale=D ** -0.5), _randn(rng, dev, D, scale=0.1),
         1 + _randn(rng, dev, D, scale=0.1), _randn(rng, dev, D, scale=0.1),
         1 + _randn(rng, dev, D, scale=0.1), _randn(rng, dev, D, scale=0.1),
         _randn(rng, dev, F, D, scale=D ** -0.5), _randn(rng, dev, F, scale=0.1),
         _randn(rng, dev, D, F, scale=F ** -0.5), _randn(rng, dev, D, scale=0.1)]
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = w
    _assert_valid_rows_close(fused_block.ln_linear(x, g1, b1, 1e-5, wqkv, bqkv, vl),
                             fused_block.ln_linear_reference(x, g1, b1, 1e-5, wqkv, bqkv), valid)
    hid = fused_block.linear_relu(x, w1, b1f, vl)
    _assert_valid_rows_close(hid, fused_block.linear_relu_reference(x, w1, b1f), valid)
    _assert_valid_rows_close(
        fused_block.linear_residual_ln(hid, w2, b2f, x, g2, b2, 1e-6, vl),
        fused_block.linear_residual_ln_reference(hid, w2, b2f, x, g2, b2, 1e-6), valid)
    _assert_valid_rows_close(
        fused_block.linear_residual_ln(x, wout, bout, x, g1, b1, 1e-5, vl),
        fused_block.linear_residual_ln_reference(x, wout, bout, x, g1, b1, 1e-5), valid)
    out = fused_block.fused_encoder_block(x, vl, *w, HEADS)
    _assert_valid_rows_close(
        out, fused_block.fused_encoder_block_reference(x, vl, *w, HEADS), valid)
    # row tiles wholly past the prefix are zero
    for i, n in enumerate(valid):
        assert not out[i, -(-n // 32) * 32:].any().item()


def test_wrappers_refuse_other_dtypes(dev):
    x = torch.zeros((1, 64, D), dtype=torch.float16, device=dev)
    vl = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        fa.prefix_flash_attention(x, x, x, vl, HEADS)


def test_wrappers_refuse_other_widths(dev):
    x = torch.zeros((1, 64, 64), device=dev)
    vl = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        fa.prefix_flash_attention(x, x, x, vl, 2)  # head width 32
    with pytest.raises(ValueError):
        fused_block.linear_relu(x, torch.zeros((128, 64), device=dev),
                                torch.zeros((128,), device=dev), vl)


def _layer_inputs(rng, dev, valid):
    s = -(-max(valid) // 128) * 128
    x = _randn(rng, dev, len(valid), s, D)
    w = [_randn(rng, dev, 3 * D, D, scale=D ** -0.5), _randn(rng, dev, 3 * D, scale=0.1),
         _randn(rng, dev, D, D, scale=D ** -0.5), _randn(rng, dev, D, scale=0.1),
         1 + _randn(rng, dev, D, scale=0.1), _randn(rng, dev, D, scale=0.1),
         1 + _randn(rng, dev, D, scale=0.1), _randn(rng, dev, D, scale=0.1),
         _randn(rng, dev, F, D, scale=D ** -0.5), _randn(rng, dev, F, scale=0.1),
         _randn(rng, dev, D, F, scale=F ** -0.5), _randn(rng, dev, D, scale=0.1)]
    dy = _randn(rng, dev, len(valid), s, D)
    for i, n in enumerate(valid):
        dy[i, n:] = 0
    return x, w, dy, torch.tensor(valid, dtype=torch.int32, device=dev)


def _assert_grad_close(out, ref, valid):
    torch.cuda.synchronize()
    if out.dim() == 3:
        for i, n in enumerate(valid):
            scale = max(1.0, ref[i, :n].abs().max().item())
            assert (out[i, :n] - ref[i, :n]).abs().max().item() <= TOL * scale, (i, n)
            assert not out[i, n:].any().item(), ("past valid_len", i, n)
    else:
        scale = max(1.0, ref.abs().max().item())
        assert (out - ref).abs().max().item() <= TOL * scale


@pytest.mark.parametrize("valid", VALIDS)
def test_backward_kernels(dev, valid):
    rng = np.random.default_rng(sum(valid) + 1)
    x, w, dy, vl = _layer_inputs(rng, dev, valid)
    _, (attn, x2, r2, lse, stats) = fused_block.layer_forward(
        fused_block.PLAIN_STEPS, x, vl, tuple(w), HEADS, 1e-5, 1e-5, save=True)
    rec = Recorder(fused_block.PLAIN_STEPS)
    fused_block.layer_backward(rec, dy, x, vl, attn, x2, r2, lse, stats, w, HEADS, 1e-5)
    kernels = {"layernorm_bwd": fused_block.layernorm_bwd,
               "linear_dgrad": fused_block.linear_dgrad,
               "linear_wgrad": fused_block.linear_wgrad,
               "attention_bwd": fa.prefix_attention_bwd}
    seen = []
    for name, (args, kwargs), ref in rec.calls:
        if name not in kernels:
            continue
        entry = "prefix_attention_bwd" if name == "attention_bwd" else name
        before = _launch.LAUNCHES[entry]
        out = kernels[name](*args, **kwargs)
        assert _launch.LAUNCHES[entry] == before + 1
        seen.append(name)
        for o, r in zip(out if isinstance(out, tuple) else (out,),
                        ref if isinstance(ref, tuple) else (ref,)):
            _assert_grad_close(o, r, valid)
    assert sorted(seen) == sorted(["layernorm_bwd"] * 3 + ["linear_dgrad"] * 4
                                  + ["linear_wgrad"] * 4 + ["attention_bwd"])


@pytest.mark.parametrize("valid", VALIDS)
def test_layer_gradient_through_the_function(dev, valid):
    # held against the plain backward chain on the residuals the Function's
    # own forward saves: against autograd of the plain forward, a pre-activation
    # within rounding of 0 can flip its ReLU mask between the two forwards and
    # move a whole gradient row, which is the kink of ReLU, not a kernel fault
    rng = np.random.default_rng(sum(valid) + 2)
    x, w, dy, vl = _layer_inputs(rng, dev, valid)
    xg = x.clone().requires_grad_(True)
    wg = [t.clone().requires_grad_(True) for t in w]
    y = fused_block.fused_encoder_block(xg, vl, *wg, HEADS)
    assert type(y.grad_fn).__name__ == "FusedEncoderBlockBackward"
    got = torch.autograd.grad(y, [xg, *wg], dy)
    with torch.no_grad():
        _, (attn, x2, r2, lse, stats) = fused_block.layer_forward(
            fused_block.KERNEL_STEPS, x, vl, tuple(w), HEADS, 1e-5, 1e-5, save=True)
        ref = fused_block.fused_encoder_block_backward_reference(
            dy, x, vl, attn, x2, r2, lse, stats, w, HEADS, 1e-5)
    for o, r in zip(got, ref):
        _assert_grad_close(o, r.reshape(o.shape), valid)


@pytest.mark.parametrize("valid", VALIDS)
def test_attention_gradient_through_the_function(dev, valid):
    rng = np.random.default_rng(sum(valid) + 3)
    s = max(256, -(-max(valid) // 64) * 64)
    qkv = _randn(rng, dev, len(valid), s, 3 * D)
    dout = _randn(rng, dev, len(valid), s, D)
    for i, n in enumerate(valid):
        dout[i, n:] = 0
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    grads = []
    for fn in (fa.prefix_flash_attention, fa.prefix_flash_attention_reference):
        t = qkv.clone().requires_grad_(True)
        out = fn(t[..., :D], t[..., D:2 * D], t[..., 2 * D:], vl, HEADS)
        grads.append(torch.autograd.grad(out, t, dout)[0])
    _assert_grad_close(grads[0], grads[1], valid)


# ---- bfloat16 instances, and cotangents on the tail rows the forward computes --
# bf16 on both sides, rounded at the same points (the JAX kernels' casts); the
# two sides sum in other orders, so a value can round to a neighbouring bf16
# and the chain carries such steps. The bounds are chip_smoke.py's (BF16_STEPS
# bf16 steps at the largest entry of a bf16 output, BF16_F32_REL of the
# largest entry of a float32 one, a cosine of at least BF16_COS over the whole
# tensor).


def _bf16_weights(w):
    return fused_block.pack_weights(w, torch.bfloat16)


def _assert_bf16_close(out, ref, rows=None):
    torch.cuda.synchronize()
    err, tol, cos = bf16_err(out, ref, rows)
    assert err <= tol, (err, tol)
    assert cos >= BF16_COS, cos


@pytest.mark.parametrize("valid", VALIDS)
def test_bf16_forward_kernels_and_chain(dev, valid):
    rng = np.random.default_rng(sum(valid) + 4)
    x, w, _, vl = _layer_inputs(rng, dev, valid)
    x = x.bfloat16()
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = _bf16_weights(w)
    qkv = fused_block.ln_linear_reference(x, g1, b1, 1e-5, wqkv, bqkv)
    _assert_bf16_close(fused_block.ln_linear(x, g1, b1, 1e-5, wqkv, bqkv, vl), qkv, valid)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    a = fa.prefix_flash_attention_reference(q, k, v, vl, HEADS)
    before = _launch.LAUNCHES["prefix_attention_fwd_bf16"]
    _assert_bf16_close(fa.prefix_flash_attention(q, k, v, vl, HEADS), a, valid)
    assert _launch.LAUNCHES["prefix_attention_fwd_bf16"] == before + 1
    x2 = fused_block.linear_residual_ln_reference(a, wout, bout, x, g1, b1, 1e-5)
    _assert_bf16_close(fused_block.linear_residual_ln(a, wout, bout, x, g1, b1, 1e-5, vl),
                       x2, valid)
    hid = fused_block.linear_relu_reference(x2, w1, b1f)
    _assert_bf16_close(fused_block.linear_relu(x2, w1, b1f, vl), hid, valid)
    _assert_bf16_close(fused_block.linear_residual_ln(hid, w2, b2f, x2, g2, b2, 1e-5, vl),
                       fused_block.linear_residual_ln_reference(hid, w2, b2f, x2, g2, b2,
                                                                1e-5), valid)
    out = fused_block.fused_encoder_block(x, vl, *w, HEADS)
    assert out.dtype == torch.bfloat16
    _assert_bf16_close(out, fused_block.fused_encoder_block_reference(x, vl, *w, HEADS),
                       valid)
    for i, n in enumerate(valid):
        assert not out[i, -(-n // 32) * 32:].any().item()


def _tail_cotangent(dy, valid, tile):
    """dy kept on every row of the tiles that hold a valid row, zero past."""
    dy = dy.clone()
    for i, n in enumerate(valid):
        dy[i, -(-n // tile) * tile:] = 0
    return dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", VALIDS)
def test_backward_kernels_with_tail_cotangent(dev, valid, dtype):
    # every backward kernel on the inputs the plain backward chain gives it,
    # with a cotangent on the tail rows of the partially valid 32-row tiles
    rng = np.random.default_rng(sum(valid) + 5)
    x, w, dy, vl = _layer_inputs(rng, dev, valid)
    dy = _randn(rng, dev, *dy.shape)
    dy = _tail_cotangent(dy, valid, fused_block.ROW_BLOCK).to(dtype)
    x = x.to(dtype)
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, x.shape[1])
            for n in valid]
    _, (attn, x2, r2, lse, stats) = fused_block.layer_forward(
        fused_block.PLAIN_STEPS, x, vl, tuple(w), HEADS, 1e-5, 1e-5, save=True)
    rec = Recorder(fused_block.PLAIN_STEPS)
    fused_block.layer_backward(rec, dy, x, vl, attn, x2, r2, lse, stats, w, HEADS, 1e-5)
    kernels = {"layernorm_bwd": fused_block.layernorm_bwd,
               "linear_dgrad": fused_block.linear_dgrad,
               "linear_wgrad": fused_block.linear_wgrad,
               "attention_bwd": fa.prefix_attention_bwd}
    for name, (args, kwargs), ref in rec.calls:
        if name not in kernels:
            continue
        out = kernels[name](*args, **kwargs)
        for o, r in zip(out if isinstance(out, tuple) else (out,),
                        ref if isinstance(ref, tuple) else (ref,)):
            if dtype == torch.float32:
                torch.cuda.synchronize()
                if o.dim() == 3:
                    for i, n in enumerate(rows):
                        scale = max(1.0, r[i, :n].abs().max().item())
                        assert (o[i, :n] - r[i, :n]).abs().max().item() <= TOL * scale
                else:
                    assert (o - r).abs().max().item() <= TOL * max(1.0, r.abs().max().item())
            else:
                _assert_bf16_close(o, r, rows if o.dim() == 3 else None)
            if o.dim() == 3:  # the zero-filled tiles get exact zeros
                for i, n in enumerate(rows):
                    assert not o[i, n:].any().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", VALIDS)
def test_layer_gradient_with_tail_cotangent(dev, valid, dtype):
    # the Function's backward against the plain backward chain on its own
    # residuals, with a cotangent on the tail rows the forward computed
    rng = np.random.default_rng(sum(valid) + 6)
    x, w, dy, vl = _layer_inputs(rng, dev, valid)
    dy = _tail_cotangent(_randn(rng, dev, *dy.shape), valid, fused_block.ROW_BLOCK).to(dtype)
    x = x.to(dtype)
    rows = [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in valid]
    xg = x.clone().requires_grad_(True)
    wg = [t.clone().requires_grad_(True) for t in w]
    y = fused_block.fused_encoder_block(xg, vl, *wg, HEADS)
    got = torch.autograd.grad(y, [xg, *wg], dy)
    assert got[0].dtype == dtype and all(g.dtype == torch.float32 for g in got[1:])
    with torch.no_grad():
        _, (attn, x2, r2, lse, stats) = fused_block.layer_forward(
            fused_block.KERNEL_STEPS, x, vl, tuple(w), HEADS, 1e-5, 1e-5, save=True)
        ref = fused_block.fused_encoder_block_backward_reference(
            dy, x, vl, attn, x2, r2, lse, stats, w, HEADS, 1e-5)
    for i, (o, r) in enumerate(zip(got, ref)):
        r = r.reshape(o.shape)
        if dtype == torch.float32:
            _assert_grad_close(o, r, rows) if i == 0 else _assert_grad_close(o, r, valid)
        else:
            _assert_bf16_close(o, r, rows if i == 0 else None)
    for i, n in enumerate(rows):
        assert not got[0][i, n:].any().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", VALIDS)
def test_attention_gradient_with_tail_cotangent(dev, valid, dtype):
    # the Function's backward against the plain backward on the Function's
    # own forward (its out and lse), with a cotangent on the tail rows of the
    # partially valid 64-query tiles
    rng = np.random.default_rng(sum(valid) + 7)
    s = max(256, -(-max(valid) // 64) * 64)
    qkv = _randn(rng, dev, len(valid), s, 3 * D).to(dtype)
    dout = _tail_cotangent(_randn(rng, dev, len(valid), s, D), valid, fa.SEQ_BLOCK).to(dtype)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    rows = [-(-n // fa.SEQ_BLOCK) * fa.SEQ_BLOCK for n in valid]
    t = qkv.clone().requires_grad_(True)
    out = fa.prefix_flash_attention(t[..., :D], t[..., D:2 * D], t[..., 2 * D:], vl, HEADS)
    got = torch.autograd.grad(out, t, dout)[0]
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    with torch.no_grad():
        o, lse = fa.attention_forward(q, k, v, vl, HEADS, with_lse=True)
        ref = fa.prefix_flash_attention_backward_reference(q, k, v, o, lse, dout, vl, HEADS)
    if dtype == torch.float32:
        _assert_grad_close(got, ref, rows)
    else:
        _assert_bf16_close(got, ref, rows)
        for i, n in enumerate(rows):
            assert not got[i, n:].any().item()


# ---- K5/K6: the standalone LayerNorm kernels (csrc/layernorm.cu) -------------------
LN_SHAPES = [(4, 2048, D), (3, 45, D), (7, 11, 64), (2, 5, 1024)]


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layernorm_kernels(dev, shape, dtype, residual, eps):
    from chadavit_tpu_torch.ops import layernorm as ln

    rng = np.random.default_rng(shape[1] + residual)
    d = shape[-1]
    x = (_randn(rng, dev, *shape) * 2 + 0.5).to(dtype)
    r = _randn(rng, dev, *shape).to(dtype) if residual else None
    g, b = 1 + _randn(rng, dev, d, scale=0.1), _randn(rng, dev, d, scale=0.05)
    dy = _randn(rng, dev, *shape).to(dtype)
    before = dict(_launch.LAUNCHES)
    y, mu, rstd = ln.ln_fwd(x, r, g, b, eps)
    dx, dg, db = ln.ln_bwd(x, r, g, mu, rstd, dy)
    name = _launch.entry_point("ln_fwd", dtype), _launch.entry_point("ln_bwd", dtype)
    assert [_launch.LAUNCHES[n] - before.get(n, 0) for n in name] == [1, 1]
    ry, rmu, rrstd = ln.ln_fwd_reference(x, r, g, b, eps)
    rdx, rdg, rdb = ln.ln_bwd_reference(x, r, g, mu, rstd, dy)
    assert y.dtype == dtype and dx.dtype == dtype
    assert all(t.dtype == torch.float32 for t in (mu, rstd, dg, db))
    if dtype == torch.float32:
        for out, ref in ((y, ry), (mu, rmu), (rstd, rrstd), (dx, rdx)):
            torch.cuda.synchronize()
            assert (out - ref).abs().max().item() <= TOL * max(1.0, ref.abs().max().item())
        for out, ref in ((dg, rdg), (db, rdb)):
            assert (out - ref).abs().max().item() <= TOL * max(1.0, ref.abs().max().item())
    else:
        for out, ref in ((y, ry), (dx, rdx), (mu, rmu), (rstd, rrstd), (dg, rdg), (db, rdb)):
            _assert_bf16_close(out, ref)
    # the same bits from run to run: no atomics, fixed-order sums
    dx2, dg2, db2 = ln.ln_bwd(x, r, g, mu, rstd, dy)
    assert torch.equal(dx, dx2) and torch.equal(dg, dg2) and torch.equal(db, db2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_layernorm_gradient_through_the_functions(dev, dtype, residual):
    # layernorm(impl="pallas") under autograd against autograd of the plain
    # version of the kernel path (scale and bias rounded to x's dtype)
    from chadavit_tpu_torch.ops import layernorm as ln

    rng = np.random.default_rng(11 + residual)
    x = _randn(rng, dev, 4, 300, D).to(dtype).requires_grad_(True)
    r = _randn(rng, dev, 4, 300, D).to(dtype).requires_grad_(True) if residual else None
    g = (1 + _randn(rng, dev, D, scale=0.1)).requires_grad_(True)
    b = _randn(rng, dev, D, scale=0.05).requires_grad_(True)
    t = _randn(rng, dev, 4, 300, D)
    leaves = [x, g, b] + ([r] if residual else [])

    def loss(y):  # not LN-invariant: sum((y - t)^2)
        return ((y.float() - t) ** 2).sum()

    got = torch.autograd.grad(loss(ln.layernorm(x, g, b, 1e-6, impl="pallas", residual=r)),
                              leaves)
    ref = torch.autograd.grad(loss(ln.ln_fwd_reference(x, r, g, b, 1e-6)[0]), leaves)
    assert got[1].dtype == torch.float32 and got[2].dtype == torch.float32
    if residual:
        assert torch.equal(got[0], got[3])  # one cotangent for both addends
    for o, rf in zip(got, ref):
        if dtype == torch.float32:
            torch.cuda.synchronize()
            assert (o - rf).abs().max().item() <= TOL * max(1.0, rf.abs().max().item())
        else:
            _assert_bf16_close(o, rf)


def test_layernorm_refuses_other_widths(dev):
    from chadavit_tpu_torch.ops import layernorm as ln

    g = torch.ones(2048 + 4, device=dev)
    with pytest.raises(ValueError, match="at most"):
        ln.ln_fwd(torch.ones(3, 2048 + 4, device=dev), None, g, g, 1e-5)
    g = torch.ones(6, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        ln.ln_fwd(torch.ones(3, 6, device=dev), None, g, g, 1e-5)


# ---- the bf16 linear_dgrad / linear_wgrad (tensor cores) at every site ------
# Each site on its own, bf16 inputs drawn with numpy, against the plain bf16
# version (the bounds above), at the hub's shapes, at the train batch's 64
# sequences and at ragged lengths: valid_len not a multiple of 32 or 128, an
# image with one valid row and one wholly padded image. A second call repeats
# the bits (fixed-order sums, no atomics).
_HUB = [1 + 196 * c for c in (1, 3, 5, 10, 2, 7, 9, 10)]
_TRAIN = [1 + 196 * c for c in np.random.default_rng(64).integers(1, 11, 64)]
TC_BATCHES = {"hub": (2048, _HUB), "train": (2048, _TRAIN),
              "ragged": (384, [1, 0, 33, 127, 129, 383, 200, 65])}
TC_SITES = ["dgrad_ffn1", "dgrad_ffn2", "dgrad_out", "dgrad_qkv",
            "wgrad_qkv", "wgrad_out", "wgrad_ffn1", "wgrad_ffn2"]


def _tc_call(site, rng, dev, bsz, s, vl):
    """The site's kernel call and its plain version, on fresh bf16 inputs."""
    def bf(*shape, scale=1.0):
        return _randn(rng, dev, *shape, scale=scale).bfloat16()

    if site.startswith("dgrad"):
        k, n, epi = {"dgrad_ffn1": (D, F, "relu_of"), "dgrad_ffn2": (F, D, "residual"),
                     "dgrad_out": (D, D, None), "dgrad_qkv": (3 * D, D, None)}[site]
        dy, w = bf(bsz, s, k), bf(k, n, scale=k ** -0.5)
        kw = {} if epi is None else {epi: bf(bsz, s, n)}
        return (lambda: fused_block.linear_dgrad(dy, w, vl, **kw),
                lambda: fused_block.linear_dgrad_reference(dy, w, vl, **kw))
    n, k = {"wgrad_qkv": (3 * D, D), "wgrad_out": (D, D), "wgrad_ffn1": (F, D),
            "wgrad_ffn2": (D, F)}[site]
    dy, x = bf(bsz, s, n), bf(bsz, s, k)
    ln = None
    if site == "wgrad_qkv":
        ln = (_randn(rng, dev, bsz, s, scale=0.1), 1 + _randn(rng, dev, bsz, s, scale=0.1).abs(),
              1 + _randn(rng, dev, k, scale=0.1), _randn(rng, dev, k, scale=0.1))
    return (lambda: fused_block.linear_wgrad(dy, x, vl, ln=ln),
            lambda: fused_block.linear_wgrad_reference(dy, x, vl, ln=ln))


@pytest.mark.parametrize("site", TC_SITES)
@pytest.mark.parametrize("batch", list(TC_BATCHES))
def test_bf16_tensor_core_gemms_at_every_site(dev, batch, site):
    s, valid = TC_BATCHES[batch]
    rng = np.random.default_rng(len(valid) + TC_SITES.index(site))
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    kernel, plain = _tc_call(site, rng, dev, len(valid), s, vl)
    entry = ("linear_dgrad" if site.startswith("dgrad") else "linear_wgrad") + "_bf16"
    before = _launch.LAUNCHES[entry]
    out, again = kernel(), kernel()
    assert _launch.LAUNCHES[entry] == before + 2
    ref = plain()
    outs, agains = (out, again) if isinstance(out, tuple) else ((out,), (again,))
    refs = ref if isinstance(ref, tuple) else (ref,)
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for n in valid]
    for o, a, r in zip(outs, agains, refs):
        assert torch.equal(o, a), "a second call gives other bits"
        if o.dim() == 3:
            assert o.dtype == torch.bfloat16
            _assert_bf16_close(o, r, rows)
            for i, n in enumerate(rows):  # the zero-filled tiles get exact zeros
                assert not o[i, n:].any().item()
        else:
            assert o.dtype == torch.float32
            _assert_bf16_close(o, r)


# ---- the bf16 prefix attention (tensor cores, csrc/prefix_attention_bf16.cu) --
# K3 and K4 against their plain bf16 versions (the bounds above) at every kind
# of prefix: one token, a 64-query tile less one, exactly one and one more,
# the hub's 197 and 1961, and the whole padded sequence; on the column slices
# of one packed qkv (rows of 576, as the layer passes them) and on contiguous
# q, k, v; with and without the lse; the backward with a cotangent on every
# row of the computed query tiles. A second call repeats the bits.
ATTN_VALID, ATTN_S = [1, 63, 64, 65, 197, 1961, 2048], 2048
ATTN_ROWS = [min(-(-n // 64) * 64, ATTN_S) for n in ATTN_VALID]


def _bf16_qkv(rng, dev, layout):
    qkv = _randn(rng, dev, len(ATTN_VALID), ATTN_S, 3 * D).bfloat16()
    if layout == "packed":
        return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    return tuple(qkv[..., i * D:(i + 1) * D].contiguous() for i in range(3))


@pytest.mark.parametrize("layout", ["packed", "contiguous"])
def test_bf16_tensor_core_attention_forward(dev, layout):
    q, k, v = _bf16_qkv(np.random.default_rng(11), dev, layout)
    vl = torch.tensor(ATTN_VALID, dtype=torch.int32, device=dev)
    before = _launch.LAUNCHES["prefix_attention_fwd_bf16"]
    out, lse = fa.attention_forward(q, k, v, vl, HEADS, with_lse=True)
    again, lse_again = fa.attention_forward(q, k, v, vl, HEADS, with_lse=True)
    bare, none = fa.attention_forward(q, k, v, vl, HEADS, with_lse=False)
    assert _launch.LAUNCHES["prefix_attention_fwd_bf16"] == before + 3 and none is None
    assert torch.equal(out, again) and torch.equal(lse, lse_again) and torch.equal(out, bare)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, rlse = fa.prefix_flash_attention_reference(q, k, v, vl, HEADS, return_lse=True)
    _assert_bf16_close(out, ref, ATTN_ROWS)
    _assert_bf16_close(lse.transpose(1, 2), rlse.transpose(1, 2), ATTN_ROWS)
    for i, n in enumerate(ATTN_ROWS):  # the tiles past the prefix: zeros, lse 1e30
        assert not out[i, n:].any().item()
        assert (lse[i, :, n:] == 1e30).all().item()


@pytest.mark.parametrize("layout", ["packed", "contiguous"])
def test_bf16_tensor_core_attention_backward(dev, layout):
    rng = np.random.default_rng(12)
    q, k, v = _bf16_qkv(rng, dev, layout)
    vl = torch.tensor(ATTN_VALID, dtype=torch.int32, device=dev)
    dout = _tail_cotangent(_randn(rng, dev, len(ATTN_VALID), ATTN_S, D), ATTN_VALID,
                           fa.SEQ_BLOCK).bfloat16()
    o, lse = fa.attention_forward(q, k, v, vl, HEADS, with_lse=True)
    before = _launch.LAUNCHES["prefix_attention_bwd_bf16"]
    got = fa.prefix_attention_bwd(q, k, v, o, lse, dout, vl, HEADS)
    again = fa.prefix_attention_bwd(q, k, v, o, lse, dout, vl, HEADS)
    assert _launch.LAUNCHES["prefix_attention_bwd_bf16"] == before + 2
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    ref = fa.prefix_flash_attention_backward_reference(q, k, v, o, lse, dout, vl, HEADS)
    for j in range(3):  # dq, dk, dv
        _assert_bf16_close(got[..., j * D:(j + 1) * D], ref[..., j * D:(j + 1) * D], ATTN_ROWS)
    for i, n in enumerate(ATTN_ROWS):  # the zero-filled tiles get exact zeros
        assert not got[i, n:].any().item()


# ---- the bf16 linear_relu / linear_residual_ln (tensor cores, K1c / K1b) ------
# csrc/linear_fwd_bf16.cu against the plain bf16 versions (the bounds above)
# at every site (K1c; K1b at the out projection, K 192, and at FFN2, K 2048),
# with and without the save outputs, at the hub's shapes, at the train batch's
# 64 sequences and at every kind of prefix: one row, a 32-row tile less one,
# exactly one and one more, a 64-row block less one, exactly one and one
# more, the hub's 197 and 1961, and the whole padded sequence. The 32-row
# tiles past the prefix are zeros, also the second tile of a computed 64-row
# block. A second call repeats the bits.
FWD_BATCHES = {"ragged": (2048, [1, 31, 32, 33, 63, 64, 65, 197, 1961, 2048]),
               "hub": (2048, _HUB), "train": (2048, _TRAIN)}
FWD_SITES = {"relu": D, "residual_ln_out": D, "residual_ln_ffn2": F}


FWD_CASES = [("relu", False), ("residual_ln_out", False), ("residual_ln_out", True),
             ("residual_ln_ffn2", False), ("residual_ln_ffn2", True)]


@pytest.mark.parametrize("site, save", FWD_CASES)
@pytest.mark.parametrize("batch", list(FWD_BATCHES))
def test_bf16_tensor_core_forward_gemms(dev, batch, site, save):
    s, valid = FWD_BATCHES[batch]
    rng = np.random.default_rng(len(valid) + list(FWD_SITES).index(site))
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    bsz, k = len(valid), FWD_SITES[site]

    def bf(*shape, scale=1.0):
        return _randn(rng, dev, *shape, scale=scale).bfloat16()

    if site == "relu":
        x, w, b = bf(bsz, s, D), bf(F, D, scale=D ** -0.5), bf(F, scale=0.1)
        entry = "linear_relu_fwd_bf16"

        def kernel():
            return fused_block.linear_relu(x, w, b, vl)

        def plain():
            return fused_block.linear_relu_reference(x, w, b)
    else:
        a, w, b = bf(bsz, s, k), bf(D, k, scale=k ** -0.5), bf(D, scale=0.1)
        res = bf(bsz, s, D)
        g, beta = 1 + _randn(rng, dev, D, scale=0.1), _randn(rng, dev, D, scale=0.1)
        entry = "linear_residual_ln_fwd_bf16"

        def kernel():
            return fused_block.linear_residual_ln(a, w, b, res, g, beta, 1e-5, vl, save=save)

        def plain():
            return fused_block.linear_residual_ln_reference(a, w, b, res, g, beta, 1e-5,
                                                            save=save)
    before = _launch.LAUNCHES[entry]
    with torch.no_grad():
        out, again = kernel(), kernel()
    assert _launch.LAUNCHES[entry] == before + 2
    ref = plain()
    outs, agains, refs = ((out, again, ref) if save else ((out,), (again,), (ref,)))
    for o, ag in zip(outs, agains):
        assert torch.equal(o, ag), "a second call gives other bits"
    dtypes = [torch.bfloat16]
    if save:  # out, the LN stats (mean, rstd) as one f32 tensor, r
        outs = (outs[0], torch.stack(outs[1:3], -1), outs[3])
        refs = (refs[0], torch.stack(refs[1:3], -1), refs[3])
        dtypes = [torch.bfloat16, torch.float32, torch.bfloat16]
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for n in valid]
    for o, r, dt in zip(outs, refs, dtypes):
        assert o.dtype == dt
        _assert_bf16_close(o, r, rows)
        for i, n in enumerate(rows):  # the zero-filled tiles get exact zeros
            assert not o[i, n:].any().item()


# ---- the bf16 ln_linear (tensor cores, K1a) ---------------------------------------
# csrc/linear_fwd_bf16.cu's LN1 + QKV against the plain bf16 version (the
# bounds above) on three seeds, with and without the saved LN1 stats, at every
# kind of prefix (an image of one valid row and one of 31, a 64-row block
# whose second 32-row tile is padding), at the hub's shapes and at the train
# batch's 64 sequences. The 32-row tiles past the prefix are zeros in qkv and
# in the stats; a second call repeats the bits.
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("batch", list(FWD_BATCHES))
def test_bf16_tensor_core_ln_linear(dev, batch, save, seed):
    s, valid = FWD_BATCHES[batch]
    rng = np.random.default_rng(100 + seed)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    x = _randn(rng, dev, len(valid), s, D).bfloat16()
    w = _randn(rng, dev, 3 * D, D, scale=D ** -0.5).bfloat16()
    b = _randn(rng, dev, 3 * D, scale=0.1).bfloat16()
    g, beta = 1 + _randn(rng, dev, D, scale=0.1), _randn(rng, dev, D, scale=0.05)
    before = _launch.LAUNCHES["ln_linear_fwd_bf16"]
    with torch.no_grad():
        out = fused_block.ln_linear(x, g, beta, 1e-5, w, b, vl, save=save)
        again = fused_block.ln_linear(x, g, beta, 1e-5, w, b, vl, save=save)
    assert _launch.LAUNCHES["ln_linear_fwd_bf16"] == before + 2
    ref = fused_block.ln_linear_reference(x, g, beta, 1e-5, w, b, save=save)
    outs, agains, refs = (out, again, ref) if save else ((out,), (again,), (ref,))
    for o, ag in zip(outs, agains):
        assert torch.equal(o, ag), "a second call gives other bits"
    dtypes = [torch.bfloat16]
    if save:  # qkv, then the LN1 stats (mean, rstd) as one f32 tensor
        outs, refs = (outs[0], torch.stack(outs[1:], -1)), (refs[0], torch.stack(refs[1:], -1))
        dtypes.append(torch.float32)
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for n in valid]
    for o, r, dt in zip(outs, refs, dtypes):
        assert o.dtype == dt
        _assert_bf16_close(o, r, rows)
        for i, n in enumerate(rows):  # the zero-filled tiles get exact zeros
            assert not o[i, n:].any().item()


# ---- layernorm_bwd (K2a) at the train batch: 64 sequences of 2048 rows ---------------
# 4096 32-row tiles cut into fused_block.layernorm_bwd_splits shares: dx and
# dgamma/dbeta against the plain version (float32: the tolerance above; bf16:
# the bounds above), with the site-1 residual and dgb summed into (accumulate
# 1) and without (accumulate 0); the zero-filled tiles get dx = 0 and dgb
# repeats its bits.
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_bwd_at_the_train_batch(dev, dtype, accumulate):
    from chadavit_tpu_torch.ops.layernorm import layernorm_stats

    s, valid = 2048, _TRAIN
    rng = np.random.default_rng(7 + accumulate)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    xin = (_randn(rng, dev, len(valid), s, D) * 2 + 0.5).to(dtype)
    dy = _tail_cotangent(_randn(rng, dev, len(valid), s, D), valid,
                         fused_block.ROW_BLOCK).to(dtype)
    res = _randn(rng, dev, len(valid), s, D).to(dtype) if accumulate else None
    g = 1 + _randn(rng, dev, D, scale=0.1)
    mean, rstd = (t[..., 0] for t in layernorm_stats(xin, 1e-5))
    dgb0 = _randn(rng, dev, 2 * D) if accumulate else None
    entry = _launch.entry_point("layernorm_bwd", dtype)
    before = _launch.LAUNCHES[entry]
    runs = [fused_block.layernorm_bwd(dy, xin, mean, rstd, g, vl, residual=res,
                                      dgb=None if dgb0 is None else dgb0.clone())
            for _ in range(2)]
    assert _launch.LAUNCHES[entry] == before + 2
    assert fused_block.layernorm_bwd_splits(len(valid), s) == fused_block.LN_BWD_SPLITS
    (dx, dgb), (dx2, dgb2) = runs
    assert torch.equal(dx, dx2) and torch.equal(dgb, dgb2), "a second call gives other bits"
    rdx, rdgb = fused_block.layernorm_bwd_reference(
        dy, xin, mean, rstd, g, vl, residual=res, dgb=None if dgb0 is None else dgb0.clone())
    rows = [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in valid]
    assert dx.dtype == dtype and dgb.dtype == torch.float32
    if dtype == torch.float32:
        _assert_grad_close(dx, rdx, rows)
        _assert_grad_close(dgb, rdgb, rows)
    else:
        _assert_bf16_close(dx, rdx, rows)
        _assert_bf16_close(dgb, rdgb)
        for i, n in enumerate(rows):
            assert not dx[i, n:].any().item()


# ---- the float32 linear_residual_ln (K1b) and linear_wgrad (K2c) redesigned ----
# on the shared main loop of csrc/sgemm_f32.cuh: each against its plain float32
# version (the tolerances above: 1e-4 absolute on the rows the forward computes;
# for dW and db 1e-4 times the reference's largest entry where that exceeds 1),
# at every kind of prefix (an image with no valid row, one row, 33 rows and a
# whole sequence), with S_pad a multiple of 32 but not of 64, at the hub's
# shapes and at the f32 train batch's 16 sequences. The 32-row tiles past the
# prefix get exact zeros; a second call repeats the bits.
F32_BATCHES = {"ragged": (2048, [0, 1, 33, 2048, 197, 1961]),
               "odd": (96, [0, 1, 33, 96, 64, 65]),
               "hub": (2048, _HUB), "train": (2048, _TRAIN[:16])}
F32_WGRAD_SITES = {"qkv": (3 * D, D), "qkv_ln": (3 * D, D), "out": (D, D), "ffn1": (F, D),
                   "ffn2": (D, F)}


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("k", [D, F])
@pytest.mark.parametrize("batch", list(F32_BATCHES))
def test_f32_linear_residual_ln_at_both_sites(dev, batch, k, save):
    s, valid = F32_BATCHES[batch]
    rng = np.random.default_rng(len(valid) + k + save)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    bsz = len(valid)
    a, w, b = _randn(rng, dev, bsz, s, k), _randn(rng, dev, D, k, scale=k ** -0.5), \
        _randn(rng, dev, D, scale=0.1)
    res = _randn(rng, dev, bsz, s, D)
    g, beta = 1 + _randn(rng, dev, D, scale=0.1), _randn(rng, dev, D, scale=0.1)
    before = _launch.LAUNCHES["linear_residual_ln_fwd"]
    with torch.no_grad():
        out, again = (fused_block.linear_residual_ln(a, w, b, res, g, beta, 1e-5, vl, save=save)
                      for _ in range(2))
    assert _launch.LAUNCHES["linear_residual_ln_fwd"] == before + 2
    ref = fused_block.linear_residual_ln_reference(a, w, b, res, g, beta, 1e-5, save=save)
    outs, agains, refs = (out, again, ref) if save else ((out,), (again,), (ref,))
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for n in valid]
    for o, ag, r in zip(outs, agains, refs):
        assert torch.equal(o, ag), "a second call gives other bits"
        assert o.dtype == torch.float32
        o, r = (o, r) if o.dim() == 3 else (o[..., None], r[..., None])
        some = [i for i, n in enumerate(rows) if n]  # images with a computed tile
        _assert_valid_rows_close(o[some], r[some], [rows[i] for i in some])
        for i, n in enumerate(rows):  # the zero-filled tiles get exact zeros
            assert not o[i, n:].any().item()


@pytest.mark.parametrize("site", list(F32_WGRAD_SITES))
@pytest.mark.parametrize("batch", list(F32_BATCHES))
def test_f32_linear_wgrad_at_every_site(dev, batch, site):
    s, valid = F32_BATCHES[batch]
    rng = np.random.default_rng(len(valid) + list(F32_WGRAD_SITES).index(site))
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    bsz, (n, k) = len(valid), F32_WGRAD_SITES[site]
    dy, x = _randn(rng, dev, bsz, s, n), _randn(rng, dev, bsz, s, k)
    ln = None
    if site == "qkv_ln":
        ln = (_randn(rng, dev, bsz, s, scale=0.1), 1 + _randn(rng, dev, bsz, s, scale=0.1).abs(),
              1 + _randn(rng, dev, k, scale=0.1), _randn(rng, dev, k, scale=0.1))
    before = _launch.LAUNCHES["linear_wgrad"]
    out, again = (fused_block.linear_wgrad(dy, x, vl, ln=ln) for _ in range(2))
    assert _launch.LAUNCHES["linear_wgrad"] == before + 2
    ref = fused_block.linear_wgrad_reference(dy, x, vl, ln=ln)
    for o, ag, r in zip(out, again, ref):
        assert torch.equal(o, ag), "a second call gives other bits"
        assert o.dtype == torch.float32 and o.shape == r.shape
        _assert_grad_close(o, r, valid)


# ---- the float32 linear_dgrad (K2b) and attention backward (K4) redesigned ----
# linear_dgrad on the shared main loop of csrc/sgemm_f32.cuh (the FFN1 site a
# two-block cluster splitting K), at every site, and the attention backward
# of csrc/prefix_attention_bwd.cu (its prep pass, dk/dv and dq, the images
# taken longest first), each against its plain float32 version with the
# tolerances above, at every kind of prefix, at the hub's shapes and at the
# f32 train batch's 16 sequences. The cotangent covers every row of the
# tiles the forward computes, also those past valid_len (32-row tiles of the
# layer, 64-query tiles of the attention); the zero-filled tiles get exact
# zeros, and a second call repeats the bits.
F32_DGRAD_SITES = {"ffn2_hid": (D, F, "relu_of"), "ffn1_x2": (F, D, "residual"),
                   "out": (D, D, None), "qkv": (3 * D, D, None)}


def _assert_computed_rows_close(out, ref, rows):
    """float32 within the gradient tolerance on the rows the forward computes
    (images with none are skipped), exact zeros past them."""
    some = [i for i, n in enumerate(rows) if n]
    _assert_grad_close(out[some], ref[some], [rows[i] for i in some])
    for i, n in enumerate(rows):
        assert not out[i, n:].any().item(), ("past the computed tiles", i, n)


@pytest.mark.parametrize("site", list(F32_DGRAD_SITES))
@pytest.mark.parametrize("batch", list(F32_BATCHES))
def test_f32_linear_dgrad_at_every_site(dev, batch, site):
    s, valid = F32_BATCHES[batch]
    rng = np.random.default_rng(len(valid) + list(F32_DGRAD_SITES).index(site))
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    bsz, (k, n, epi) = len(valid), F32_DGRAD_SITES[site]
    rows = [min(-(-m // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for m in valid]
    dy = _tail_cotangent(_randn(rng, dev, bsz, s, k), valid, fused_block.ROW_BLOCK)
    w = _randn(rng, dev, k, n, scale=k ** -0.5)
    kw = {} if epi is None else {epi: _randn(rng, dev, bsz, s, n)}
    before = _launch.LAUNCHES["linear_dgrad"]
    out, again = (fused_block.linear_dgrad(dy, w, vl, **kw) for _ in range(2))
    assert _launch.LAUNCHES["linear_dgrad"] == before + 2
    assert out.dtype == torch.float32 and torch.equal(out, again), "a second call gives other bits"
    _assert_computed_rows_close(out, fused_block.linear_dgrad_reference(dy, w, vl, **kw), rows)


F32_ATTN_BATCHES = {"ragged": (2048, [0] + ATTN_VALID), "hub": (2048, _HUB),
                    "train": (2048, _TRAIN[:16])}


@pytest.mark.parametrize("layout", ["packed", "contiguous"])
@pytest.mark.parametrize("batch", list(F32_ATTN_BATCHES))
def test_f32_attention_backward(dev, batch, layout):
    s, valid = F32_ATTN_BATCHES[batch]
    rng = np.random.default_rng(len(valid) + 13)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    qkv = _randn(rng, dev, len(valid), s, 3 * D)
    q, k, v = ((qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]) if layout == "packed" else
               tuple(qkv[..., i * D:(i + 1) * D].contiguous() for i in range(3)))
    dout = _tail_cotangent(_randn(rng, dev, len(valid), s, D), valid, fa.SEQ_BLOCK)
    rows = [min(-(-n // fa.SEQ_BLOCK) * fa.SEQ_BLOCK, s) for n in valid]
    o, lse = fa.attention_forward(q, k, v, vl, HEADS, with_lse=True)
    before = _launch.LAUNCHES["prefix_attention_bwd"]
    got = fa.prefix_attention_bwd(q, k, v, o, lse, dout, vl, HEADS)
    again = fa.prefix_attention_bwd(q, k, v, o, lse, dout, vl, HEADS)
    assert _launch.LAUNCHES["prefix_attention_bwd"] == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again), "a second call gives other bits"
    ref = fa.prefix_flash_attention_backward_reference(q, k, v, o, lse, dout, vl, HEADS)
    for j in range(3):  # dq, dk, dv
        _assert_computed_rows_close(got[..., j * D:(j + 1) * D], ref[..., j * D:(j + 1) * D],
                                    rows)


# ---- the float32 attention forward (K3) and FFN1 + ReLU (K1c) redesigned ----
# K3 (csrc/prefix_attention.cu: register softmax, a cp.async ring of K and V
# tiles, the images longest first) and K1c (csrc/fused_block.cu on the shared
# main loop of csrc/sgemm_f32.cuh: resident x rows, a ring of W1 slices), each
# against its plain float32 version with the tolerances above, at every kind
# of prefix (an image with no valid row, one row, the 64-tile edges 63, 64, 65
# and a whole sequence; for K1c also S_pad a multiple of 32 but not of 64), at
# the hub's shapes and at the f32 train batch's 16 sequences; K3 on the column
# slices of one packed qkv and on contiguous q, k, v, with and without the lse.
# The tiles past the prefix get exact zeros (and lse 1e30), and a second call
# repeats the bits. Then K3's o and lse feed the float32 K4 at the train
# batch, against the plain forward and backward: the backward's recomputed
# scores agree with the forward's.
def _f32_qkv(rng, dev, valid, s, layout):
    qkv = _randn(rng, dev, len(valid), s, 3 * D)
    if layout == "packed":
        return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    return tuple(qkv[..., i * D:(i + 1) * D].contiguous() for i in range(3))


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("layout", ["packed", "contiguous"])
@pytest.mark.parametrize("batch", list(F32_ATTN_BATCHES))
def test_f32_attention_forward(dev, batch, layout, with_lse):
    s, valid = F32_ATTN_BATCHES[batch]
    rng = np.random.default_rng(len(valid) + 17)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    q, k, v = _f32_qkv(rng, dev, valid, s, layout)
    rows = [min(-(-n // fa.SEQ_BLOCK) * fa.SEQ_BLOCK, s) for n in valid]
    before = _launch.LAUNCHES["prefix_attention_fwd"]
    out, lse = fa.attention_forward(q, k, v, vl, HEADS, with_lse=with_lse)
    again, lse_again = fa.attention_forward(q, k, v, vl, HEADS, with_lse=with_lse)
    assert _launch.LAUNCHES["prefix_attention_fwd"] == before + 2
    assert out.dtype == torch.float32 and torch.equal(out, again), "a second call gives other bits"
    ref, rlse = fa.prefix_flash_attention_reference(q, k, v, vl, HEADS, return_lse=True)
    some = [i for i, n in enumerate(rows) if n]  # images with a computed tile
    _assert_valid_rows_close(out[some], ref[some], [rows[i] for i in some])
    for i, n in enumerate(rows):  # the query tiles past the prefix: zeros
        assert not out[i, n:].any().item(), ("past the computed tiles", i, n)
    if not with_lse:
        assert lse is None and lse_again is None
        return
    assert lse.dtype == torch.float32 and lse.shape == (len(valid), HEADS, s)
    assert torch.equal(lse, lse_again), "a second call gives other bits"
    _assert_valid_rows_close(lse.transpose(1, 2)[some], rlse.transpose(1, 2)[some],
                             [rows[i] for i in some])
    for i, n in enumerate(rows):  # and lse 1e30
        assert (lse[i, :, n:] == 1e30).all().item(), ("lse past the computed tiles", i, n)


@pytest.mark.parametrize("batch", list(F32_BATCHES))
def test_f32_linear_relu_at_every_batch(dev, batch):
    s, valid = F32_BATCHES[batch]
    rng = np.random.default_rng(len(valid) + 19)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    x = _randn(rng, dev, len(valid), s, D)
    w, b = _randn(rng, dev, F, D, scale=D ** -0.5), _randn(rng, dev, F, scale=0.1)
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for n in valid]
    before = _launch.LAUNCHES["linear_relu_fwd"]
    with torch.no_grad():
        out, again = (fused_block.linear_relu(x, w, b, vl) for _ in range(2))
    assert _launch.LAUNCHES["linear_relu_fwd"] == before + 2
    assert out.dtype == torch.float32 and torch.equal(out, again), "a second call gives other bits"
    some = [i for i, n in enumerate(rows) if n]
    _assert_valid_rows_close(out[some], fused_block.linear_relu_reference(x, w, b)[some],
                             [rows[i] for i in some])
    for i, n in enumerate(rows):  # the zero-filled 32-row tiles
        assert not out[i, n:].any().item(), ("past the computed tiles", i, n)


def test_f32_attention_forward_lse_feeds_the_backward(dev):
    s, valid = F32_ATTN_BATCHES["train"]
    rng = np.random.default_rng(23)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    q, k, v = _f32_qkv(rng, dev, valid, s, "packed")
    dout = _tail_cotangent(_randn(rng, dev, len(valid), s, D), valid, fa.SEQ_BLOCK)
    rows = [min(-(-n // fa.SEQ_BLOCK) * fa.SEQ_BLOCK, s) for n in valid]
    o, lse = fa.attention_forward(q, k, v, vl, HEADS, with_lse=True)
    got = fa.prefix_attention_bwd(q, k, v, o, lse, dout, vl, HEADS)
    ro, rlse = fa.prefix_flash_attention_reference(q, k, v, vl, HEADS, return_lse=True)
    ref = fa.prefix_flash_attention_backward_reference(q, k, v, ro, rlse, dout, vl, HEADS)
    for j in range(3):  # dq, dk, dv
        _assert_computed_rows_close(got[..., j * D:(j + 1) * D], ref[..., j * D:(j + 1) * D],
                                    rows)


# ---- the float32 LN1 + QKV (K1a) redesigned on csrc/sgemm_f32.cuh ----------------
# Its qkv, mean and rstd are the bits of the first port's kernel (gemm_tile):
# the plain version below repeats that kernel's arithmetic step by step in
# float32 (row_stats' lane-strided sums and warp butterfly, the prologue, every
# sum from k = 0 upward with fmaf, then the bias), and the kernel must equal it
# exactly, in every column cut that scripts/bench_linear_f32.py builds (as
# built 192 columns a block of 4 warps of 8 x 6 sums; 3 slabs of 192 walked by
# one block; 192 columns a block of 3 warps of 8 x 8 sums; 288 columns a block
# of 4 warps of 8 x 9 sums), at prefixes on either side of a 32-row tile edge
# and at the hub's shapes. The tiles past the prefix get exact zeros, stats
# included.
def _fmaf(a, b, c):
    """CUDA's fmaf on float32 tensors: a * b + c rounded once, computed exactly
    in float64 (the product is exact there; the sum's rounding error is
    recovered by TwoSum, and a float64 sum that lies halfway between two
    float32 values is rounded to the side that error lies on)."""
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    f = s.float()
    back = f.double()
    other = torch.nextafter(f, torch.where(s > back, math.inf, -math.inf).float())
    tie = (s != back) & (s - back == (other.double() - back) / 2)
    return torch.where(tie & (e != 0) & ((e > 0) == (other.double() > back)), other, f)


def _ln_linear_first_port_order(x, g, b, eps, w, bias):
    """``(qkv, mean, rstd)`` in the order of the first port's ln_linear_fwd
    as nvcc compiles it: lane l sums columns l, l + 32, ... in order (s += v;
    ss = fmaf(v, v, ss)), the warp adds the lanes by the xor butterfly 16, 8,
    4, 2, 1, mu = s / K, var = max(ss / K - mu * mu, 0) with the product
    rounded on its own (nvcc fuses no fmaf there), rstd = rsqrtf(var + eps);
    h = fmaf((x - mu) * rstd, g, beta); qkv = the fmaf chain over k from 0,
    then + bias. (Which products nvcc fuses was read on the card, against
    the first port's own kernel.)"""
    bsz, s_pad, k = x.shape
    m, n = bsz * s_pad, w.shape[0]
    xr = x.reshape(m, k)
    lanes = xr.reshape(m, k // 32, 32)  # column lane + 32 c
    s = torch.zeros(m, 32, device=x.device)
    ss = torch.zeros_like(s)
    for c in range(k // 32):
        s = s + lanes[:, c]
        ss = _fmaf(lanes[:, c], lanes[:, c], ss)
    idx = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        s, ss = s + s[:, idx ^ o], ss + ss[:, idx ^ o]
    kk = torch.full((m,), float(k), device=x.device)
    mu = s[:, 0] / kk
    rstd = torch.rsqrt(torch.clamp(ss[:, 0] / kk - mu * mu, min=0.0) + eps)
    h = _fmaf((xr - mu[:, None]) * rstd[:, None], g.expand(m, k), b.expand(m, k))
    acc = torch.zeros(m, n, device=x.device)
    for j in range(k):
        acc = _fmaf(h[:, j:j + 1].expand(m, n), w[:, j].expand(m, n), acc)
    return ((acc + bias).reshape(bsz, s_pad, n), mu.reshape(bsz, s_pad),
            rstd.reshape(bsz, s_pad))


K1A_BATCHES = {"edges": (256, [0, 1, 31, 32, 33, 63, 64, 65, 255, 256]), "hub": (2048, _HUB)}
K1A_CUTS = ["as built", "k1a_slabs3", "k1a_tn8", "k1a_tn9_bn288"]  # the bench's column cuts


@functools.lru_cache(maxsize=None)
def _bench_builds():
    """The K1a column-cut builds of scripts/bench_linear_f32.py, built once."""
    path = Path(__file__).resolve().parent.parent / "scripts" / "bench_linear_f32.py"
    spec = importlib.util.spec_from_file_location("bench_linear_f32", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    from chadavit_tpu_torch.ops._build import BUILD_DIR
    return bench.build(BUILD_DIR / "bench_linear_f32", [c for c in K1A_CUTS if c != "as built"])


def _ln_linear_cut(cut, x, g, b, eps, w, bias, vl, save):
    if cut == "as built":
        before = _launch.LAUNCHES["ln_linear_fwd"]
        got = fused_block.ln_linear(x, g, b, eps, w, bias, vl, save=save)
        assert _launch.LAUNCHES["ln_linear_fwd"] == before + 1
        return got if save else (got,)
    bsz, s, k = x.shape
    n = w.shape[0]
    out = torch.empty(bsz, s, n, device=x.device)
    mean, rstd = (torch.empty(bsz, s, device=x.device) for _ in range(2)) if save else (None,
                                                                                      None)
    status = _bench_builds()[cut].ln_linear_fwd(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), eps, w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None if mean is None else mean.data_ptr(),
        None if rstd is None else rstd.data_ptr(), vl.data_ptr(), bsz * s, k, n, s,
        torch.cuda.current_stream().cuda_stream)
    assert status == 0
    return (out, mean, rstd) if save else (out,)


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("cut", K1A_CUTS)
@pytest.mark.parametrize("batch", list(K1A_BATCHES))
def test_f32_ln_linear_keeps_the_first_port_bits(dev, batch, cut, save):
    s, valid = K1A_BATCHES[batch]
    rng = np.random.default_rng(len(valid) + 29)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    x = _randn(rng, dev, len(valid), s, D) * 2 + 0.5
    w, bias = _randn(rng, dev, 3 * D, D, scale=D ** -0.5), _randn(rng, dev, 3 * D, scale=0.02)
    g, b = 1 + _randn(rng, dev, D, scale=0.1), _randn(rng, dev, D, scale=0.05)
    with torch.no_grad():
        got = _ln_linear_cut(cut, x, g, b, 1e-5, w, bias, vl, save)
        again = _ln_linear_cut(cut, x, g, b, 1e-5, w, bias, vl, save)
    torch.cuda.synchronize()
    ref = _ln_linear_first_port_order(x, g, b, 1e-5, w, bias)
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for n in valid]
    for o, ag, r, what in zip(got, again, ref, ("qkv", "mean", "rstd")):
        assert torch.equal(o, ag), f"{what}: a second call gives other bits"
        for i, n in enumerate(rows):
            assert torch.equal(o[i, :n], r[i, :n]), (what, i, n)
            assert not o[i, n:].any().item(), (what, "past the computed tiles", i, n)


# ---- K6, ln_bwd redesigned: a split plan of M alone, half a warp a row at D 192 ----
# Both dtypes, with and without the residual: M smaller than one split, M no
# multiple of the split's rows, M past the most splits (LN_BWD_MAX_SPLITS
# times LN_BWD_SPLIT_ROWS: the cap holds), and D 64, 192 and 1024, against the
# plain version (float32: TOL of the reference's largest entry where that
# exceeds 1; bf16: the bounds above); one launch a call; a second call repeats
# the bits.
LN6_SHAPES = [(1, 5, D), (3, 45, D), (1, 200, 64), (2, 37, 1024), (33, 2048, D)]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LN6_SHAPES)
def test_ln_bwd_splits_on_the_card(dev, shape, dtype, residual):
    from chadavit_tpu_torch.ops import layernorm as ln

    rng = np.random.default_rng(shape[1] + 31 * residual)
    d, m = shape[-1], shape[0] * shape[1]
    x = (_randn(rng, dev, *shape) * 2 + 0.5).to(dtype)
    r = _randn(rng, dev, *shape).to(dtype) if residual else None
    g = 1 + _randn(rng, dev, d, scale=0.1)
    dy = _randn(rng, dev, *shape).to(dtype)
    _, mu, rstd = ln.ln_fwd_reference(x, r, g, g, 1e-5)
    entry = _launch.entry_point("ln_bwd", dtype)
    before = _launch.LAUNCHES[entry]
    got = ln.ln_bwd(x, r, g, mu, rstd, dy)
    assert _launch.LAUNCHES[entry] == before + 1
    again = ln.ln_bwd(x, r, g, mu, rstd, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "a second call gives other bits"
    splits = ln.ln_bwd_splits(m)
    assert splits == min(ln.LN_BWD_MAX_SPLITS, -(-m // ln.LN_BWD_SPLIT_ROWS))
    ref = ln.ln_bwd_reference(x, r, g, mu, rstd, dy)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    for o, rf in zip(got, ref):
        if dtype == torch.float32:
            assert (o - rf).abs().max().item() <= TOL * max(1.0, rf.abs().max().item())
        else:
            _assert_bf16_close(o, rf)
