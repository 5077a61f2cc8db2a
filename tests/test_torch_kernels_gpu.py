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
