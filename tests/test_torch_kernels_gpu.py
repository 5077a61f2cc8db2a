"""Each CUDA kernel of chadavit_tpu_torch against its plain PyTorch version,
on the card, at the widths of ChAdaViT-moyen (D 192, 2 heads of 96, FFN 2048)
with ragged prefixes (single-token, partial and full, row tiles past the
prefix), the forward kernels and the backward kernels (each on the inputs
the layer's backward chain gives it), and the gradients of the layer and of
the attention through their autograd Functions. Marked ``gpu``; skips without
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

from chadavit_tpu_torch.ops import fused_block
from chadavit_tpu_torch.ops import flash_attention as fa
from chip_smoke import Recorder

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
    before = fa.prefix_flash_attention.launches
    out = fa.prefix_flash_attention(q, k, v, vl, HEADS)
    assert fa.prefix_flash_attention.launches == before + 1
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
        before = kernels[name].launches
        out = kernels[name](*args, **kwargs)
        assert kernels[name].launches == before + 1
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
