"""Each CUDA kernel of chadavit_tpu_torch against its plain PyTorch version,
on the card, at the widths of ChAdaViT-moyen (D 192, 2 heads of 96, FFN 2048;
ChAdaViT-B/16's D 768 and the smoke configs' D 64 as cases of the same tests)
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
from pathlib import Path

import numpy as np
import pytest
import torch

from chadavit_tpu_torch.ops import _build, _launch, fused_block
from chadavit_tpu_torch.ops import flash_attention as fa
from chip_smoke import BF16_COS, Recorder, backward_reference, bf16_err
from tests import torch_bf16_order as bf16_order
from tests import torch_f32_order as f32_order
from tests import torch_ln_bwd_order as ln_bwd_order

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
    # built: D 64, 192 and 768 (FFN 2048), head widths 32, 64 and 96
    x = torch.zeros((1, 64, 128), device=dev)
    vl = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        fa.prefix_flash_attention(x[..., :32], x[..., :32], x[..., :32], vl, 2)  # head width 16
    with pytest.raises(ValueError):
        fa.prefix_flash_attention(x, x, x, vl, 1)  # head width 128
    with pytest.raises(ValueError):
        fused_block.linear_relu(x, torch.zeros((2048, 128), device=dev),
                                torch.zeros((2048,), device=dev), vl)  # D 128


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


# ---- the layer chain at D 768 (ChAdaViT-B/16: FFN 2048, 12 heads of 64) ------------
# The D 768 instances of both dtypes against their plain versions at the
# bounds above (float32 1e-4, the backward's outputs 1e-4 of their largest
# entry; bfloat16 bf16_err), at the widths where the JAX gate takes the fused
# layer (S_pad 640: 1-3 channels, both dtypes; 1408: 7 channels, bfloat16):
# the forward and backward steps are cases of the tests of both widths
# (LAYER_CASES); the layer's gradient through FusedEncoderBlock against the
# plain backward chain on the Function's own residuals (in bfloat16 with the
# kernel's recompute of the FFN hidden: chip_smoke's backward_reference) is
# test_d768_layer_gradient_through_the_function.
D16, H16 = 768, 12
D768_BATCHES = {"narrow": (640, [589, 197, 1, 393, 64, 33]),
                "wide": (1408, [1373, 1, 785, 1000])}
# a bf16 parameter gradient of the layer beyond bf16_err's bound from the
# plain chain's: its largest distance from the float32 truth over the plain
# bf16 chain's (read 0.996 to 1.004 on an H100)
TRUTH_GAP = 1.1


def _d768_inputs(rng, dev, valid, s, dtype, d=D16):
    f = fused_block.WIDTHS[d]
    x = _randn(rng, dev, len(valid), s, d)
    w = [_randn(rng, dev, 3 * d, d, scale=d ** -0.5), _randn(rng, dev, 3 * d, scale=0.02),
         _randn(rng, dev, d, d, scale=d ** -0.5), _randn(rng, dev, d, scale=0.02),
         1 + _randn(rng, dev, d, scale=0.1), _randn(rng, dev, d, scale=0.05),
         1 + _randn(rng, dev, d, scale=0.1), _randn(rng, dev, d, scale=0.05),
         _randn(rng, dev, f, d, scale=d ** -0.5), _randn(rng, dev, f, scale=0.02),
         _randn(rng, dev, d, f, scale=f ** -0.5), _randn(rng, dev, d, scale=0.02)]
    dy = _tail_cotangent(_randn(rng, dev, len(valid), s, d), valid, fused_block.ROW_BLOCK)
    return x.to(dtype), w, dy.to(dtype), torch.tensor(valid, dtype=torch.int32, device=dev)


# ---- the layer chain at D 64 (the smoke configs: FFN 2048, 2 heads of 32) ------
# The D 64 instances of both dtypes, at the same bounds, on the smoke crop's
# sequences (32 px, 1-4 channels: S 17 at most, padded to 128) and at the hub's
# channel counts (S_pad 2048, where the JAX gate fuses the layer at D 64 too):
# cases of the tests of every width (LAYER_CASES, LAYER_GRAD_CASES), and of
# the attention's (HD64_WIDTHS: D 64 in 2 heads of 32).
D64, H64 = fused_block.D_SMALL, 2
D64_BATCHES = {"crop": (128, [17, 5, 9, 13, 1, 17, 9, 5, 13, 17, 1, 9, 17, 13, 5, 17]),
               "hub": (2048, [1 + 196 * c for c in (1, 3, 5, 10, 2, 7, 9, 10)])}

# the layer chain's cases at every width it is built for: ChAdaViT-moyen's
# VALIDS, ChAdaViT-B/16's D768_BATCHES, the smoke width's D64_BATCHES
LAYER_CASES = ([("moyen", i) for i in range(len(VALIDS))] + [("b16", b) for b in D768_BATCHES]
               + [("smoke", b) for b in D64_BATCHES])


def _case_valid(width, case):
    if width == "moyen":
        return VALIDS[case]
    return (D768_BATCHES if width == "b16" else D64_BATCHES)[case][1]


def _layer_case(width, case, rng, dev, dtype):
    """x, the 12 float32 parameters, a cotangent on every row of the 32-row
    tiles that hold a valid row, valid_len and the heads of a case; x and the
    cotangent in ``dtype``."""
    valid = _case_valid(width, case)
    if width == "moyen":
        x, w, dy, vl = _layer_inputs(rng, dev, valid)
        dy = _tail_cotangent(_randn(rng, dev, *dy.shape), valid, fused_block.ROW_BLOCK)
        return x.to(dtype), w, dy.to(dtype), vl, HEADS
    if width == "smoke":
        x, w, dy, vl = _d768_inputs(rng, dev, valid, D64_BATCHES[case][0], dtype, D64)
        return x, w, dy, vl, H64
    x, w, dy, vl = _d768_inputs(rng, dev, valid, D768_BATCHES[case][0], dtype)
    return x, w, dy, vl, H16


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
@pytest.mark.parametrize("width, case", LAYER_CASES)
def test_backward_kernels_with_tail_cotangent(dev, width, case, dtype):
    # every backward kernel on the inputs the plain backward chain gives it,
    # with a cotangent on the tail rows of the partially valid 32-row tiles,
    # twice for the same bits and counted under its instance's name
    valid = _case_valid(width, case)
    rng = np.random.default_rng(sum(valid) + 5)
    x, w, dy, vl, heads = _layer_case(width, case, rng, dev, dtype)
    d = x.shape[2]
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, x.shape[1])
            for n in valid]
    _, (attn, x2, r2, lse, stats) = fused_block.layer_forward(
        fused_block.PLAIN_STEPS, x, vl, tuple(w), heads, 1e-5, 1e-5, save=True)
    rec = Recorder(fused_block.PLAIN_STEPS)
    fused_block.layer_backward(rec, dy, x, vl, attn, x2, r2, lse, stats, w, heads, 1e-5)
    kernels = {"layernorm_bwd": fused_block.layernorm_bwd,
               "linear_dgrad": fused_block.linear_dgrad,
               "linear_wgrad": fused_block.linear_wgrad,
               "attention_bwd": fa.prefix_attention_bwd}
    seen = []
    for name, (args, kwargs), ref in rec.calls:
        if name not in kernels:
            continue
        entry = (fa.instance(_launch.entry_point("prefix_attention_bwd", dtype), d // heads)
                 if name == "attention_bwd"
                 else fused_block.instance(_launch.entry_point(name, dtype), d))
        before = _launch.LAUNCHES[entry]
        out, again = ((o if isinstance(o, tuple) else (o,)) for o in (
            kernels[name](*args, **{k: (v.clone() if k == "dgb" else v)
                                    for k, v in kwargs.items()}) for _ in range(2)))
        torch.cuda.synchronize()
        assert _launch.LAUNCHES[entry] == before + 2, entry
        assert all(torch.equal(p, q) for p, q in zip(out, again)), (name, "other bits")
        seen.append(name)
        for o, r in zip(out, ref if isinstance(ref, tuple) else (ref,)):
            if dtype == torch.float32:
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
    assert sorted(seen) == sorted(["layernorm_bwd"] * 3 + ["linear_dgrad"] * 4
                                  + ["linear_wgrad"] * 4 + ["attention_bwd"])


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
# the plain model tests/torch_f32_order.py::ln_linear_order repeats that
# kernel's arithmetic step by step in float32 (row_stats' lane-strided sums
# and warp butterfly, the prologue, every sum from k = 0 upward with fmaf,
# then the bias), and the kernel must equal it exactly: at D 192 in every
# column cut that scripts/bench_linear_f32.py builds (as built 192 columns a
# block of 4 warps of 8 x 6 sums; 3 slabs of 192 walked by one block; 192
# columns a block of 3 warps of 8 x 8 sums; 288 columns a block of 4 warps of
# 8 x 9 sums), at prefixes on either side of a 32-row tile edge and at the
# hub's shapes; at D 768 (ln_linear_fwd_d768: the LN1 row pass, then the
# 128-row GEMM) at those prefixes, at chip_smoke.py's narrow f32 batch and at
# an S that is no multiple of 128 (5 sequences of 160 rows, M 800: 128-row
# blocks that hold rows of two images, computed tiles of both among them, and
# a last block of one tile, computed). On a card of 132 SMs K1a's GEMM takes
# its 64-column tile at the straddle batch and K1b's at the edges, the 96-column
# one elsewhere (gemm128_launch), so the bit tests hold both tiles.
# The tiles past the prefix get exact zeros, stats included; the rows of x
# there are NaN, which no output may show (they are not read).
K1A_BATCHES = {"edges": (256, [0, 1, 31, 32, 33, 63, 64, 65, 255, 256]), "hub": (2048, _HUB),
               # chip_smoke.py's NARROW_F32 (phase 2c: B/16 on the layer chain)
               "narrow": (640, [1 + 196 * c for c in (3, 1, 2, 3, 1, 2, 3, 2)]),
               "straddle": (160, [1, 33, 97, 160, 129])}
K1A_CUTS = ["as built", "k1a_slabs3", "k1a_tn8", "k1a_tn9_bn288"]  # the bench's column cuts
D768_BIT_BATCHES = ["edges", "narrow", "straddle"]
# D 192 in every cut at the edges and the hub; D 768 as built at D768_BIT_BATCHES
K1A_CASES = ([(D, b, c) for b in ("edges", "hub") for c in K1A_CUTS]
             + [(D16, b, "as built") for b in D768_BIT_BATCHES])


def _poison_padding(t, valid):
    """NaN into the rows of the 32-row tiles that hold no valid row."""
    for i, n in enumerate(valid):
        t[i, -(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK:] = float("nan")
    return t


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
        name = fused_block.instance("ln_linear_fwd", x.shape[-1])
        before = _launch.LAUNCHES[name]
        got = fused_block.ln_linear(x, g, b, eps, w, bias, vl, save=save)
        assert _launch.LAUNCHES[name] == before + 1
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
@pytest.mark.parametrize("case", K1A_CASES)
def test_f32_ln_linear_keeps_the_first_port_bits(dev, case, save):
    d, batch, cut = case
    s, valid = K1A_BATCHES[batch]
    rng = np.random.default_rng(len(valid) + 29)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    x = _poison_padding(_randn(rng, dev, len(valid), s, d) * 2 + 0.5, valid)
    w, bias = _randn(rng, dev, 3 * d, d, scale=d ** -0.5), _randn(rng, dev, 3 * d, scale=0.02)
    g, b = 1 + _randn(rng, dev, d, scale=0.1), _randn(rng, dev, d, scale=0.05)
    with torch.no_grad():
        got = _ln_linear_cut(cut, x, g, b, 1e-5, w, bias, vl, save)
        again = _ln_linear_cut(cut, x, g, b, 1e-5, w, bias, vl, save)
    torch.cuda.synchronize()
    ref = f32_order.ln_linear_order(x, g, b, 1e-5, w, bias, valid)
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for n in valid]
    for o, ag, r, what in zip(got, again, ref, ("qkv", "mean", "rstd")):
        assert torch.equal(o, ag), f"{what}: a second call gives other bits"
        for i, n in enumerate(rows):
            assert torch.equal(o[i, :n], r[i, :n]), (what, i, n)
            assert not o[i, n:].any().item(), (what, "past the computed tiles", i, n)


# ---- the float32 K1b at D 768 keeps the bits of its first kernel ------------------
# linear_residual_ln at N 768 (the 128-row GEMM writes r, a row pass takes the
# LayerNorm) at both sites (K 768 and K 2048), with and without its save
# outputs, against tests/torch_f32_order.py::linear_residual_ln_order, the
# order of the four-block column cluster it replaces: equal bit for bit, zeros
# (out, stats, r) on the tiles past the prefix, whose rows of a and of the
# residual are NaN (not read); a second call gives the same bits. The
# batches of K1a's test above, the straddling blocks among them.
K1B_D768_SITES = {"out": (D16, 1e-5), "ffn2": (F, 1e-6)}


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("site", list(K1B_D768_SITES))
@pytest.mark.parametrize("batch", D768_BIT_BATCHES)
def test_f32_d768_linear_residual_ln_keeps_its_bits(dev, batch, site, save):
    s, valid = K1A_BATCHES[batch]
    k, eps = K1B_D768_SITES[site]
    rng = np.random.default_rng(len(valid) + k)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    a = _poison_padding(_randn(rng, dev, len(valid), s, k), valid)
    if site == "ffn2":
        a = torch.relu(a)  # the FFN hidden
    res = _poison_padding(_randn(rng, dev, len(valid), s, D16), valid)
    w, bias = _randn(rng, dev, D16, k, scale=k ** -0.5), _randn(rng, dev, D16, scale=0.02)
    g, b = 1 + _randn(rng, dev, D16, scale=0.1), _randn(rng, dev, D16, scale=0.05)
    name = "linear_residual_ln_fwd_d768"
    before = _launch.LAUNCHES[name]
    with torch.no_grad():
        got, again = (fused_block.linear_residual_ln(a, w, bias, res, g, b, eps, vl, save=save)
                      for _ in range(2))
    torch.cuda.synchronize()
    assert _launch.LAUNCHES[name] == before + 2
    got, again = (t if save else (t,) for t in (got, again))
    ref = f32_order.linear_residual_ln_order(a, w, bias, res, g, b, eps, valid)
    for o, ag, r, what in zip(got, again, ref, ("out", "mean", "rstd", "r")):
        assert torch.equal(o, ag), f"{what}: a second call gives other bits"
        assert torch.equal(o, r), (what, (o - r).abs().max().item())


# ---- the float32 K1c at D 768 keeps the first port's bits --------------------------
# linear_relu at K 768 (the 128-row GEMM with its ReLU epilogue) against
# tests/torch_f32_order.py::linear_relu_order, the order of the first port's
# kernel: equal bit for bit, zeros on the tiles past the prefix, whose rows
# of x are NaN (not read); a second call gives the same bits. At chip_smoke.py's
# narrow f32 rows and at its 3-channel bucket's (B16_BUCKET_F32's two images,
# two crops each), and at K1a's edges and straddle batches (a last 128-row
# block of one tile, blocks that hold rows of two images).
K1C_D768_BATCHES = {"narrow": K1A_BATCHES["narrow"],
                    "bucket": (640, [1 + 196 * c for c in (3, 2, 3, 2)]),
                    "edges": K1A_BATCHES["edges"], "straddle": K1A_BATCHES["straddle"]}


@pytest.mark.parametrize("batch", list(K1C_D768_BATCHES))
def test_f32_d768_linear_relu_keeps_the_first_port_bits(dev, batch):
    s, valid = K1C_D768_BATCHES[batch]
    rng = np.random.default_rng(len(valid) + 37)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    x = _poison_padding(_randn(rng, dev, len(valid), s, D16), valid)
    w, bias = _randn(rng, dev, F, D16, scale=D16 ** -0.5), _randn(rng, dev, F, scale=0.02)
    name = "linear_relu_fwd_d768"
    before = _launch.LAUNCHES[name]
    with torch.no_grad():
        got, again = (fused_block.linear_relu(x, w, bias, vl) for _ in range(2))
    torch.cuda.synchronize()
    assert _launch.LAUNCHES[name] == before + 2
    assert torch.equal(got, again), "a second call gives other bits"
    ref = f32_order.linear_relu_order(x, w, bias, valid)
    assert torch.equal(got, ref), (got - ref).abs().max().item()


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


# ---- K3 and K4 at head width 64 (ChAdaViT-B/16: D 768 in 12 heads) -----------------
# The head-64 instances of both dtypes against their plain versions (the
# bounds above: float32 1e-4, the gradients 1e-4 of their largest entry;
# bfloat16 bf16_err) on the column slices of one packed qkv (rows of 3 D), at
# every kind of prefix, at the hub's shapes and at an S of three 64-row tiles
# (the bf16 K4's 128-row blocks then end an image on one tile), B/16's 12
# heads and a narrow model's 2, on three seeds: the lse, zeros and lse 1e30 on
# the query tiles past the prefix, the backward with a cotangent on the valid
# rows and with one on every row of the computed tiles (exact zeros past
# them), each call twice for the same bits, and the launches counted under
# the head-64 instance's name.
# (D, heads): the head-64 widths, and the smoke width's head of 32
HD64_WIDTHS = {"b16": (768, 12), "narrow": (128, 2), "smoke_hd32": (D64, H64)}
HD64_BATCHES = {"ragged": (2048, ATTN_VALID), "hub": (2048, _HUB),
                "odd_tiles": (192, [1, 64, 65, 129, 192])}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", list(HD64_WIDTHS))
@pytest.mark.parametrize("batch", list(HD64_BATCHES))
def test_head_64_attention_forward_and_backward(dev, batch, width, dtype, seed):
    d, heads = HD64_WIDTHS[width]
    s, valid = HD64_BATCHES[batch]
    rng = np.random.default_rng(len(valid) + d + 1000 * seed)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    qkv = _randn(rng, dev, len(valid), s, 3 * d).to(dtype)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    rows = [min(-(-n // fa.SEQ_BLOCK) * fa.SEQ_BLOCK, s) for n in valid]
    fwd = fa.instance(_launch.entry_point("prefix_attention_fwd", dtype), d // heads)
    bwd = fa.instance(_launch.entry_point("prefix_attention_bwd", dtype), d // heads)
    before = (_launch.LAUNCHES[fwd], _launch.LAUNCHES[bwd])
    out, lse = fa.attention_forward(q, k, v, vl, heads, with_lse=True)
    again, lse_again = fa.attention_forward(q, k, v, vl, heads, with_lse=True)
    assert torch.equal(out, again) and torch.equal(lse, lse_again), "other bits"
    assert out.dtype == dtype and lse.shape == (len(valid), heads, s)
    ref, rlse = fa.prefix_flash_attention_reference(q, k, v, vl, heads, return_lse=True)
    close = _assert_valid_rows_close if dtype == torch.float32 else _assert_bf16_close
    close(out, ref, rows)
    close(lse.transpose(1, 2), rlse.transpose(1, 2), rows)
    for i, n in enumerate(rows):  # the query tiles past the prefix: zeros, lse 1e30
        assert not out[i, n:].any().item() and (lse[i, :, n:] == 1e30).all().item()
    tail = _tail_cotangent(_randn(rng, dev, len(valid), s, d), valid, fa.SEQ_BLOCK)
    on_valid = tail.clone()
    for i, n in enumerate(valid):
        on_valid[i, n:] = 0
    for dout in (tail.to(dtype), on_valid.to(dtype)):
        got = fa.prefix_attention_bwd(q, k, v, out, lse, dout, vl, heads)
        assert torch.equal(got, fa.prefix_attention_bwd(q, k, v, out, lse, dout, vl, heads))
        gref = fa.prefix_flash_attention_backward_reference(q, k, v, out, lse, dout, vl, heads)
        for j in range(3):  # dq, dk, dv
            if dtype == torch.float32:
                _assert_computed_rows_close(got[..., j * d:(j + 1) * d],
                                            gref[..., j * d:(j + 1) * d], rows)
            else:
                _assert_bf16_close(got[..., j * d:(j + 1) * d], gref[..., j * d:(j + 1) * d],
                                   rows)
        for i, n in enumerate(rows):  # the zero-filled tiles get exact zeros
            assert not got[i, n:].any().item()
    assert (_launch.LAUNCHES[fwd], _launch.LAUNCHES[bwd]) == (before[0] + 2, before[1] + 4)


FWD_STEPS = ["ln_linear", "ln_linear_save", "linear_relu", "residual_ln_out",
             "residual_ln_out_save", "residual_ln_ffn2", "residual_ln_ffn2_save"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step", FWD_STEPS)
@pytest.mark.parametrize("width, case", LAYER_CASES)
def test_forward_steps_twice_with_save_outputs(dev, width, case, step, dtype):
    # each forward step at both widths, with and without its save outputs:
    # twice for the same bits, counted under its instance's name, zeros on the
    # 32-row tiles past the prefix
    valid = _case_valid(width, case)
    rng = np.random.default_rng(len(valid) + FWD_STEPS.index(step))
    x, w, _, vl, _ = _layer_case(width, case, rng, dev, dtype)
    bsz, s, d = x.shape
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = fused_block.pack_weights(w, dtype)
    rows = [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in valid]
    save = step.endswith("_save")
    a = _randn(rng, dev, bsz, s, d).to(dtype)
    hid = torch.relu(_randn(rng, dev, bsz, s, w1.shape[0])).to(dtype)
    kernel, plain, entry = {
        "ln_linear": (lambda: fused_block.ln_linear(x, g1, b1, 1e-5, wqkv, bqkv, vl, save=save),
                      lambda: fused_block.ln_linear_reference(x, g1, b1, 1e-5, wqkv, bqkv,
                                                              save=save), "ln_linear_fwd"),
        "linear_relu": (lambda: fused_block.linear_relu(x, w1, b1f, vl),
                        lambda: fused_block.linear_relu_reference(x, w1, b1f), "linear_relu_fwd"),
        "residual_ln_out": (
            lambda: fused_block.linear_residual_ln(a, wout, bout, x, g1, b1, 1e-5, vl, save=save),
            lambda: fused_block.linear_residual_ln_reference(a, wout, bout, x, g1, b1, 1e-5,
                                                             save=save),
            "linear_residual_ln_fwd"),
        "residual_ln_ffn2": (
            lambda: fused_block.linear_residual_ln(hid, w2, b2f, x, g2, b2, 1e-6, vl, save=save),
            lambda: fused_block.linear_residual_ln_reference(hid, w2, b2f, x, g2, b2, 1e-6,
                                                             save=save),
            "linear_residual_ln_fwd"),
    }[step.removesuffix("_save")]
    name = fused_block.instance(_launch.entry_point(entry, dtype), d)
    before = _launch.LAUNCHES[name]
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    assert _launch.LAUNCHES[name] == before + 2, name
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(p, q) for p, q in zip(got, again)), "other bits on a second call"
    ref = plain()
    ref = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(got, ref):
        for i, n in enumerate(rows):  # the 32-row tiles past the prefix are zeros
            assert not o[i, n:].any().item(), (i, n)
        if o.dim() == 2:  # the row stats, float32
            o, r = o[..., None], r[..., None]
        if dtype == torch.bfloat16:
            _assert_bf16_close(o, r, rows)
        else:
            _assert_valid_rows_close(o, r, rows)


# the layer's gradient at D 768 and, as cases of the same test, at D 64
LAYER_GRAD_CASES = {**{b: (D16, H16) + D768_BATCHES[b] for b in D768_BATCHES},
                    **{f"d64_{b}": (D64, H64) + D64_BATCHES[b] for b in D64_BATCHES}}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", list(LAYER_GRAD_CASES))
def test_d768_layer_gradient_through_the_function(dev, batch, dtype, seed):
    d, heads, s, valid = LAYER_GRAD_CASES[batch]
    rng = np.random.default_rng(len(valid) + 12 + 100 * seed)
    x, w, dy, vl = _d768_inputs(rng, dev, valid, s, dtype, d)
    rows = [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in valid]
    xg = x.clone().requires_grad_(True)
    wg = [t.clone().requires_grad_(True) for t in w]
    # the layer's K1c and its attention backward at this width (at D 768 the
    # 128-row GEMM and, in bf16, the wgmma K4), counted under their instances
    k1c = fused_block.instance(_launch.entry_point("linear_relu_fwd", dtype), d)
    k4 = fa.instance(_launch.entry_point("prefix_attention_bwd", dtype), d // heads)
    before = (_launch.LAUNCHES[k1c], _launch.LAUNCHES[k4])
    y = fused_block.fused_encoder_block(xg, vl, *wg, heads)
    assert type(y.grad_fn).__name__ == "FusedEncoderBlockBackward"
    got = torch.autograd.grad(y, [xg, *wg], dy)
    # the forward's K1c and the backward's recompute of hid; one K4
    assert (_launch.LAUNCHES[k1c], _launch.LAUNCHES[k4]) == (before[0] + 2, before[1] + 1)
    with torch.no_grad():
        _, res = fused_block.layer_forward(fused_block.KERNEL_STEPS, x, vl, tuple(w), heads,
                                           1e-5, 1e-5, save=True)
        ref = backward_reference(dy, x, vl, res, w, heads, 1e-5)
        y_plain = fused_block.fused_encoder_block_reference(x, vl, *w, heads)
    names = ["dx", "wqkv", "bqkv", "wout", "bout", "g1", "b1", "g2", "b2", "w1", "b1f", "w2",
             "b2f"]
    if dtype == torch.bfloat16:
        # the float32 truth: the plain chain in float32 on the same (bfloat16)
        # inputs. A parameter gradient sums rounded products over every row,
        # and the kernels round their operands (dqkv, dz1, ...) at other values
        # than the plain bfloat16 chain: one within bf16_err's bound passes,
        # one beyond it must be no farther from the truth than the plain
        # bfloat16 chain is (within TRUTH_GAP of it), besides the cosine. On
        # the many short images here WQKV reads 1.46 to 1.67 times bf16_err's
        # bound from the plain chain's on three of the six batches and seeds,
        # and 0.996 to 1.004 times the plain chain's distance from the truth
        # (phase 2c of chip_smoke reads at most 1.2e-3 of the largest entry
        # at its hub shapes). Each reading is printed (pytest -s)
        xf = x.float()
        with torch.no_grad():
            _, resf = fused_block.layer_forward(fused_block.PLAIN_STEPS, xf, vl, tuple(w), heads,
                                                1e-5, 1e-5, save=True)
            truth = fused_block.layer_backward(fused_block.PLAIN_STEPS, dy.float(), xf, vl,
                                               *resf, w, heads, 1e-5)
    for i_t, (name, o, r) in enumerate(zip(names, got, ref)):
        r = r.reshape(o.shape)
        if dtype == torch.bfloat16:
            torch.cuda.synchronize()
            err, tol, cos = bf16_err(o, r, rows if o.dim() == 3 else None)
            assert cos >= BF16_COS, (name, cos)
            if o.dim() == 3:
                assert err <= tol, (name, err, tol)
            elif err > tol:
                t = truth[i_t].reshape(o.shape)
                gap, gap_plain = ((v.float() - t).abs().max().item() for v in (o, r))
                print(f"{batch} seed {seed} {name}: {err / tol:.3f} x bf16_err's bound from the "
                      f"plain chain; to the float32 truth {gap / gap_plain:.3f} x the plain bf16 "
                      f"chain's")
                assert gap <= TRUTH_GAP * gap_plain, (name, err, tol, gap, gap_plain)
            else:
                print(f"{batch} seed {seed} {name}: {err / tol:.3f} x bf16_err's bound from the "
                      f"plain chain")
        elif o.dim() == 3:
            _assert_computed_rows_close(o, r, rows)
        else:
            _assert_grad_close(o, r, rows)
    for i, n in enumerate(rows):
        assert not got[0][i, n:].any().item()
    if dtype == torch.bfloat16:
        _assert_bf16_close(y.detach(), y_plain, valid)
    else:
        _assert_valid_rows_close(y.detach(), y_plain, valid)


# ---- ChAdaViT-B/16's bf16 K1a and K2c on wgmma (csrc/linear_wgmma_bf16.cu) ------
# K1a (ln_linear at D 768) and the four K2c sites against their plain bf16
# versions (bf16_err's bounds) on D768_BATCHES and three seeds: a second call
# repeats the bits (fixed-order sums, the stream-K partials added in block
# order), the 32-row tiles past the prefix are zeros in qkv and its stats.
WGRAD_D768_SITES = {"qkv": (3 * D16, D16), "out": (D16, D16), "ffn1": (F, D16),
                    "ffn2": (D16, F)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("batch", list(D768_BATCHES))
def test_d768_wgmma_ln_linear(dev, batch, save, seed):
    s, valid = D768_BATCHES[batch]
    rng = np.random.default_rng(300 + seed)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    x = _randn(rng, dev, len(valid), s, D16).bfloat16()
    w = _randn(rng, dev, 3 * D16, D16, scale=D16 ** -0.5).bfloat16()
    b = _randn(rng, dev, 3 * D16, scale=0.1).bfloat16()
    g, beta = 1 + _randn(rng, dev, D16, scale=0.1), _randn(rng, dev, D16, scale=0.05)
    name = "ln_linear_fwd_bf16_d768"
    before = _launch.LAUNCHES[name]
    with torch.no_grad():
        out = fused_block.ln_linear(x, g, beta, 1e-5, w, b, vl, save=save)
        again = fused_block.ln_linear(x, g, beta, 1e-5, w, b, vl, save=save)
    assert _launch.LAUNCHES[name] == before + 2
    ref = fused_block.ln_linear_reference(x, g, beta, 1e-5, w, b, save=save)
    outs, agains, refs = (out, again, ref) if save else ((out,), (again,), (ref,))
    for o, ag in zip(outs, agains):
        assert torch.equal(o, ag), "a second call gives other bits"
    if save:  # qkv, then the LN1 stats (mean, rstd) as one f32 tensor
        outs, refs = (outs[0], torch.stack(outs[1:], -1)), (refs[0], torch.stack(refs[1:], -1))
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for n in valid]
    for o, r in zip(outs, refs):
        _assert_bf16_close(o, r, rows)
        for i, n in enumerate(rows):  # the zero-filled tiles get exact zeros
            assert not o[i, n:].any().item()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("site", list(WGRAD_D768_SITES))
@pytest.mark.parametrize("batch", list(D768_BATCHES))
def test_d768_wgmma_wgrad(dev, batch, site, seed):
    s, valid = D768_BATCHES[batch]
    n, k = WGRAD_D768_SITES[site]
    rng = np.random.default_rng(400 + seed)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    dy = _tail_cotangent(_randn(rng, dev, len(valid), s, n), valid,
                         fused_block.ROW_BLOCK).bfloat16()
    x = _randn(rng, dev, len(valid), s, k).bfloat16()
    ln = None
    if site == "qkv":
        ln = (_randn(rng, dev, len(valid), s, scale=0.1),
              1 + _randn(rng, dev, len(valid), s, scale=0.1).abs(),
              1 + _randn(rng, dev, k, scale=0.1), _randn(rng, dev, k, scale=0.1))
    name = "linear_wgrad_bf16_d768"
    before = _launch.LAUNCHES[name]
    out, again = (fused_block.linear_wgrad(dy, x, vl, ln=ln) for _ in range(2))
    assert _launch.LAUNCHES[name] == before + 2
    ref = fused_block.linear_wgrad_reference(dy, x, vl, ln=ln)
    for o, a, r in zip(out, again, ref):
        assert torch.equal(o, a), "a second call gives other bits"
        assert o.dtype == torch.float32
        _assert_bf16_close(o, r)


@pytest.mark.parametrize("batch", list(TC_BATCHES))
def test_ln_rows_prepass_is_the_old_ln_staging(dev, batch):
    # the pre-pass's h from the saved stats, bit for bit the h that the D 192
    # wgrad's LN staging makes in shared memory: the same D 192 kernel on h
    # without LN gives the same dW and db as on x with it
    s, valid = TC_BATCHES[batch]
    rng = np.random.default_rng(77)
    bsz = len(valid)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    dy = _randn(rng, dev, bsz, s, 3 * D).bfloat16()
    x = _randn(rng, dev, bsz, s, D).bfloat16()
    mean, rstd = _randn(rng, dev, bsz, s, scale=0.1), 1 + _randn(rng, dev, bsz, s, scale=0.1).abs()
    g, beta = 1 + _randn(rng, dev, D, scale=0.1), _randn(rng, dev, D, scale=0.1)
    h, *_ = fused_block.layernorm_rows(x, g, beta, vl, stats=(mean, rstd))
    staged = fused_block.linear_wgrad(dy, x, vl, ln=(mean, rstd, g, beta))
    prepass = fused_block.linear_wgrad(dy, h, vl)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(staged, prepass))
    # and h itself is the plain version's on the computed rows, zeros elsewhere
    ref, *_ = fused_block.layernorm_rows_reference(x, g, beta, vl, stats=(mean, rstd))
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for n in valid]
    _assert_bf16_close(h, ref, rows)
    assert all(not h[i, n:].any().item() for i, n in enumerate(rows))


@pytest.mark.parametrize("batch", list(D768_BATCHES))
def test_ln_rows_prepass_takes_k1as_stats(dev, batch):
    # at D 768 the pre-pass that takes the stats gives the stats and h of the
    # plain version (bf16_err's bounds), zeros on the zero-filled tiles, and
    # the same h again from the stats it wrote
    s, valid = D768_BATCHES[batch]
    rng = np.random.default_rng(78)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    x = (_randn(rng, dev, len(valid), s, D16) * 2 + 0.5).bfloat16()
    g, beta = 1 + _randn(rng, dev, D16, scale=0.1), _randn(rng, dev, D16, scale=0.1)
    h, mean, rstd = fused_block.layernorm_rows(x, g, beta, vl)
    ref = fused_block.layernorm_rows_reference(x, g, beta, vl)
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for n in valid]
    _assert_bf16_close(h, ref[0], rows)
    _assert_bf16_close(torch.stack((mean, rstd), -1), torch.stack(ref[1:], -1), rows)
    for t in (h, mean, rstd):
        assert all(not t[i, n:].any().item() for i, n in enumerate(rows))
    h2, *_ = fused_block.layernorm_rows(x, g, beta, vl, stats=(mean, rstd))
    torch.cuda.synchronize()
    assert torch.equal(h, h2)


# ---- ChAdaViT-B/16's bf16 K1c and K2b on wgmma (csrc/linear_wgmma_bf16.cu) ------
# K1c (linear_relu at D 768) and K2b (linear_dgrad at its four D 768 sites)
# against their plain bf16 versions (bf16_err's bounds) on D768_BATCHES and
# three seeds: a second call repeats the bits, and the rows of the 32-row
# tiles past the prefix, which the kernels write themselves (no pre-pass),
# are zeros also where the output's memory held NaN before. The cotangent of
# K2b is on every row of the computed tiles, as the chain's.
DGRAD_D768_SITES = {"ffn2": (D16, F, "relu_of"), "ffn1": (F, D16, "residual"),
                    "out": (D16, D16, None), "qkv": (3 * D16, D16, None)}


def _nan_block(shape, dev):
    """Leaves a freed block of NaN of ``shape`` in the caching allocator, which
    the next allocation of that size takes."""
    torch.full(shape, float("nan"), dtype=torch.bfloat16, device=dev)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("batch", list(D768_BATCHES))
def test_d768_wgmma_linear_relu(dev, batch, seed):
    s, valid = D768_BATCHES[batch]
    rng = np.random.default_rng(500 + seed)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    x = _randn(rng, dev, len(valid), s, D16).bfloat16()
    w = _randn(rng, dev, F, D16, scale=D16 ** -0.5).bfloat16()
    b = _randn(rng, dev, F, scale=0.1).bfloat16()
    name = "linear_relu_fwd_bf16_d768"
    before = _launch.LAUNCHES[name]
    with torch.no_grad():
        _nan_block((len(valid), s, F), dev)
        out = fused_block.linear_relu(x, w, b, vl)
        _nan_block((len(valid), s, F), dev)
        again = fused_block.linear_relu(x, w, b, vl)
    assert _launch.LAUNCHES[name] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(out, again), "a second call gives other bits"
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for n in valid]
    _assert_bf16_close(out, fused_block.linear_relu_reference(x, w, b), rows)
    for i, n in enumerate(rows):  # the zero-filled tiles get exact zeros
        assert not out[i, n:].any().item(), (i, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("site", list(DGRAD_D768_SITES))
@pytest.mark.parametrize("batch", list(D768_BATCHES))
def test_d768_wgmma_dgrad(dev, batch, site, seed):
    s, valid = D768_BATCHES[batch]
    k, n, aux = DGRAD_D768_SITES[site]
    rng = np.random.default_rng(600 + seed)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    dy = _tail_cotangent(_randn(rng, dev, len(valid), s, k), valid,
                         fused_block.ROW_BLOCK).bfloat16()
    w = _randn(rng, dev, k, n, scale=k ** -0.5).bfloat16()
    kw = {} if aux is None else {aux: _randn(rng, dev, len(valid), s, n).bfloat16()}
    name = "linear_dgrad_bf16_d768"
    before = _launch.LAUNCHES[name]
    _nan_block((len(valid), s, n), dev)
    out = fused_block.linear_dgrad(dy, w, vl, **kw)
    _nan_block((len(valid), s, n), dev)
    again = fused_block.linear_dgrad(dy, w, vl, **kw)
    assert _launch.LAUNCHES[name] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(out, again), "a second call gives other bits"
    rows = [min(-(-m // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for m in valid]
    _assert_bf16_close(out, fused_block.linear_dgrad_reference(dy, w, vl, **kw), rows)
    for i, m in enumerate(rows):
        assert not out[i, m:].any().item(), (i, m)


# ---- ChAdaViT-B/16's float32 K2c: the stream-K walk (csrc/fused_block_bwd.cu) ----
# linear_wgrad at D 768 in float32 at its four sites, the QKV site with and
# without LN1 (qkv_ln, qkv), against the plain float32 version (the gradient
# tolerance) at chip_smoke.py's narrow float32 rows (phase 2c), at the rows
# of 4e (b)'s 3-channel bucket, and at S 160 with images of no valid row,
# one row and whole sequences (its units of one image run into the next's
# within a block's share); the rows of the tiles past the prefix are NaN in dy
# and x (never read). One launch a call, under linear_wgrad_d768; a second
# call repeats the bits (the partials added in block order). At qkv_ln the
# pre-pass's X' is the forward's h bit for bit: the walk on x with LN1 gives
# the bits it gives without LN1 on h = fmaf((x - mean) rstd, g, beta).
F32_WGRAD_D768_BATCHES = {"narrow": K1A_BATCHES["narrow"],
                          "bucket": (640, [1 + 196 * c for c in (3, 2, 3, 2)]),
                          "straddle": (160, [1, 33, 0, 97, 160, 129])}
F32_WGRAD_D768_SITES = {"qkv": (3 * D16, D16), "qkv_ln": (3 * D16, D16), "out": (D16, D16),
                        "ffn1": (F, D16), "ffn2": (D16, F)}


@pytest.mark.parametrize("site", list(F32_WGRAD_D768_SITES))
@pytest.mark.parametrize("batch", list(F32_WGRAD_D768_BATCHES))
def test_f32_d768_stream_wgrad_at_every_site(dev, batch, site):
    s, valid = F32_WGRAD_D768_BATCHES[batch]
    n, k = F32_WGRAD_D768_SITES[site]
    rng = np.random.default_rng(700 + list(F32_WGRAD_D768_SITES).index(site))
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    bsz = len(valid)
    dy = _poison_padding(_randn(rng, dev, bsz, s, n), valid)
    x = _poison_padding(_randn(rng, dev, bsz, s, k), valid)
    ln = None
    if site == "qkv_ln":
        ln = (_randn(rng, dev, bsz, s, scale=0.1), 1 + _randn(rng, dev, bsz, s, scale=0.1).abs(),
              1 + _randn(rng, dev, k, scale=0.1), _randn(rng, dev, k, scale=0.1))
    name = "linear_wgrad_d768"
    before = _launch.LAUNCHES[name]
    out, again = (fused_block.linear_wgrad(dy, x, vl, ln=ln) for _ in range(2))
    assert _launch.LAUNCHES[name] == before + 2
    ref = fused_block.linear_wgrad_reference(dy, x, vl, ln=ln)
    for o, ag, r in zip(out, again, ref):
        assert torch.equal(o, ag), "a second call gives other bits"
        assert o.dtype == torch.float32 and o.shape == r.shape
        assert torch.isfinite(o).all().item()
        _assert_grad_close(o, r, valid)
    if ln is not None:
        mean, rstd, g, b = ln
        h = f32_order.fmaf((x - mean[..., None]) * rstd[..., None], g.expand_as(x),
                           b.expand_as(x))
        on_h = fused_block.linear_wgrad(dy, h, vl)
        assert all(torch.equal(o, oh) for o, oh in zip(out, on_h))


# ---- ChAdaViT-B/16's bf16 K1b on wgmma with a row pass (csrc/linear_wgmma_bf16.cu) --
# linear_residual_ln at D 768 in bfloat16 at both sites, with and without its
# save outputs, against the plain bf16 version (bf16_err's bounds) at the
# narrow batch and at S 192 with images of no valid row, one row and whole
# sequences, whose odd counts of 64-row units pair units of two images in one
# 128-row tile of the GEMM; the rows of the 32-row tiles past the prefix are
# NaN in a and the residual (never stored: out, r and the stats are zeros
# there). One launch a call, under linear_residual_ln_fwd_bf16_d768; a
# second call repeats the bits. Then the LayerNorm bit for bit: out, mean and
# rstd equal tests/torch_bf16_order.py's order (the four-block column
# cluster's) applied to the kernel's own r.
BF16_K1B_D768_BATCHES = {"narrow": D768_BATCHES["narrow"],
                         "straddle": (192, [1, 65, 0, 129, 192, 33])}
BF16_K1B_D768_SITES = {"out": (D16, 1e-5), "ffn2": (F, 1e-6)}


def _bf16_k1b_d768_inputs(dev, batch, site):
    s, valid = BF16_K1B_D768_BATCHES[batch]
    k, eps = BF16_K1B_D768_SITES[site]
    rng = np.random.default_rng(800 + k)
    a = _poison_padding(_randn(rng, dev, len(valid), s, k), valid)
    if site == "ffn2":
        a = torch.relu(a)  # the FFN hidden
    res = _poison_padding(_randn(rng, dev, len(valid), s, D16), valid)
    w, bias = _randn(rng, dev, D16, k, scale=k ** -0.5), _randn(rng, dev, D16, scale=0.02)
    g, b = 1 + _randn(rng, dev, D16, scale=0.1), _randn(rng, dev, D16, scale=0.05)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    return (a.bfloat16(), w.bfloat16(), bias.bfloat16(), res.bfloat16(), g, b, eps), vl, valid, s


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("site", list(BF16_K1B_D768_SITES))
@pytest.mark.parametrize("batch", list(BF16_K1B_D768_BATCHES))
def test_d768_wgmma_linear_residual_ln(dev, batch, site, save):
    args, vl, valid, s = _bf16_k1b_d768_inputs(dev, batch, site)
    name = "linear_residual_ln_fwd_bf16_d768"
    before = _launch.LAUNCHES[name]
    with torch.no_grad():
        out, again = (fused_block.linear_residual_ln(*args, vl, save=save) for _ in range(2))
    assert _launch.LAUNCHES[name] == before + 2
    torch.cuda.synchronize()
    outs, agains = (out, again) if save else ((out,), (again,))
    for o, ag in zip(outs, agains):
        assert torch.equal(o, ag), "a second call gives other bits"
    ref = fused_block.linear_residual_ln_reference(*args, save=save)
    refs = ref if save else (ref,)
    if save:  # out, the LN stats (mean, rstd) as one f32 tensor, r
        outs = (outs[0], torch.stack(outs[1:3], -1), outs[3])
        refs = (refs[0], torch.stack(refs[1:3], -1), refs[3])
    rows = [min(-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for n in valid]
    some = [i for i, n in enumerate(rows) if n]  # images with a computed tile
    for o, r in zip(outs, refs):
        _assert_bf16_close(o[some], r[some], [rows[i] for i in some])
        for i, n in enumerate(rows):  # the zero-filled tiles get exact zeros
            assert not o[i, n:].any().item(), (i, n)


@pytest.mark.parametrize("site", list(BF16_K1B_D768_SITES))
@pytest.mark.parametrize("batch", list(BF16_K1B_D768_BATCHES))
def test_d768_wgmma_linear_residual_ln_keeps_its_layernorm_order(dev, batch, site):
    args, vl, valid, s = _bf16_k1b_d768_inputs(dev, batch, site)
    with torch.no_grad():
        out, mean, rstd, r = fused_block.linear_residual_ln(*args, vl, save=True)
    torch.cuda.synchronize()
    g, b, eps = args[4:]
    ref = bf16_order.residual_ln_rows_order(r, g, b, eps, valid)
    for o, rf, what in zip((out, mean, rstd), ref, ("out", "mean", "rstd")):
        assert torch.equal(o, rf), (what, (o.float() - rf.float()).abs().max().item())


# the D 192 bf16 K1c and K2b outputs on scripts/bench_wgmma_bf16.py's seeded
# inputs (d192_digests), as the tree before the D 768 instances moved to
# wgmma computed them on an H100: the D 192 instances keep their bits
D192_K1C_K2B_SHA256 = "4a6ee6631f9fe68d8df472e48476b9b34a0eacd18c8f916ed7750f2b1f9a3434"


def test_d192_bf16_linear_relu_and_dgrad_keep_their_bits(dev):
    path = Path(__file__).resolve().parent.parent / "scripts" / "bench_wgmma_bf16.py"
    spec = importlib.util.spec_from_file_location("bench_wgmma_bf16", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert bench.d192_digests(fused_block, dev)["k1c_k2b"] == D192_K1C_K2B_SHA256


# ---- ChAdaViT-B/16's float32 K2b: the stream-K walk (csrc/fused_block_bwd.cu) ----
# linear_dgrad at D 768 in float32 at its four sites (the ReLU mask of hid,
# the residual dr2, the out-projection, QKV), on three seeds, against the
# plain float32 version (the gradient tolerance on the rows of the computed
# tiles, exact zeros past them) at chip_smoke.py's narrow float32 rows (phase
# 2c), at the rows of 4e (b)'s 3-channel bucket and at S 160 with images of
# no valid row, one row and whole sequences (shares that run from one image
# into the next); the rows of the tiles past the prefix are NaN in dy and in
# hid or dr2 (never read). One launch a call, under linear_dgrad_d768; a
# second call repeats the bits (a split tile's partials added in block
# order). The walk's grid is the blocks the card holds, as the runtime
# reports them.
F32_DGRAD_D768_BATCHES = {"narrow": K1A_BATCHES["narrow"],
                          "bucket": (640, [1 + 196 * c for c in (3, 2, 3, 2)]),
                          "straddle": (160, [1, 33, 0, 97, 160, 129])}
F32_DGRAD_D768_SITES = {"mask": (D16, F, "relu_of"), "ffn1": (F, D16, "residual"),
                        "out": (D16, D16, None), "qkv": (3 * D16, D16, None)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("site", list(F32_DGRAD_D768_SITES))
@pytest.mark.parametrize("batch", list(F32_DGRAD_D768_BATCHES))
def test_f32_d768_stream_dgrad_at_every_site(dev, batch, site, seed):
    s, valid = F32_DGRAD_D768_BATCHES[batch]
    k, n, epi = F32_DGRAD_D768_SITES[site]
    rng = np.random.default_rng(800 + 10 * seed + list(F32_DGRAD_D768_SITES).index(site))
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    bsz = len(valid)
    rows = [min(-(-m // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK, s) for m in valid]
    dy = _poison_padding(_randn(rng, dev, bsz, s, k), valid)
    w = _randn(rng, dev, k, n, scale=k ** -0.5)
    kw = {} if epi is None else {epi: _poison_padding(_randn(rng, dev, bsz, s, n), valid)}
    name = "linear_dgrad_d768"
    before = _launch.LAUNCHES[name]
    out, again = (fused_block.linear_dgrad(dy, w, vl, **kw) for _ in range(2))
    assert _launch.LAUNCHES[name] == before + 2
    assert out.dtype == torch.float32 and torch.equal(out, again), "a second call gives other bits"
    code = {None: 0, "relu_of": 1, "residual": 2}[epi]
    blocks = _build.library().linear_dgrad_d768_blocks(k, n, code)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert blocks >= sms and blocks % sms == 0, blocks  # whole SMs, as the runtime reports
    assert fused_block.dgrad_stream_blocks(k, n, code, out.device) == blocks  # the wrapper's grid
    _assert_computed_rows_close(out, fused_block.linear_dgrad_reference(dy, w, vl, **kw), rows)


# ---- ChAdaViT-B/16's float32 K4 on the tensor cores in 3xTF32 ---------------------
# prefix_attention_bwd at head 64 in float32 (csrc/prefix_attention_bwd.cu's
# tensor-core blocks, csrc/mma_tf32.cuh) at B/16's width (12 heads of 64,
# packed qkv rows of 2304) on the hub shapes and on ragged prefixes (1, 63,
# 64, 65, 197, 1961 and 2048 rows), against the plain float32 version (TF32
# off) with the gradient tolerance on the rows of the computed 64-row tiles,
# exact zeros past them, a second call repeating the bits; and its error
# against a float64 backward on the same inputs within three times that of
# the plain float32 version (the f32 class: one TF32 product alone misses it
# by 2^9).
def _backward_f64(q, k, v, o, lse, dout, vl, heads):
    b, s, d = q.shape
    hd = d // heads

    def split(t):
        return t.double().reshape(b, s, heads, hd).transpose(1, 2)

    qh, kh, vh, oh = map(split, (q, k, v, o))
    rows = fa.computed_rows(s, vl, q.device)[:, None, :, None]
    doh = torch.where(rows, split(dout), 0.0)
    key_ok = (torch.arange(s, device=q.device)[None, :] < vl[:, None])[:, None, None, :]
    p = torch.where(rows & key_ok, torch.exp2(qh @ kh.transpose(-1, -2) * (
        1.4426950408889634 / hd ** 0.5) - lse.double()[..., None]), 0.0)
    ds = p * (doh @ vh.transpose(-1, -2) - (doh * oh).sum(-1, keepdim=True))
    grads = (ds @ kh / hd ** 0.5, ds.transpose(-1, -2) @ qh / hd ** 0.5, p.transpose(-1, -2) @ doh)
    return torch.cat([t.transpose(1, 2).reshape(b, s, d) for t in grads], dim=-1)


@pytest.mark.parametrize("batch", ["hub", "ragged"])
def test_f32_head_64_backward_on_the_tensor_cores(dev, batch):
    s, valid = {"hub": (2048, _HUB), "ragged": (ATTN_S, ATTN_VALID)}[batch]
    d, heads = D16, H16
    rng = np.random.default_rng(64 + len(valid))
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    qkv = _randn(rng, dev, len(valid), s, 3 * d)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    rows = [min(-(-n // fa.SEQ_BLOCK) * fa.SEQ_BLOCK, s) for n in valid]
    out, lse = fa.attention_forward(q, k, v, vl, heads, with_lse=True)
    dout = _tail_cotangent(_randn(rng, dev, len(valid), s, d), valid, fa.SEQ_BLOCK)
    name = "prefix_attention_bwd_hd64"
    before = _launch.LAUNCHES[name]
    got, again = (fa.prefix_attention_bwd(q, k, v, out, lse, dout, vl, heads) for _ in range(2))
    assert _launch.LAUNCHES[name] == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again), "a second call gives other bits"
    ref = fa.prefix_flash_attention_backward_reference(q, k, v, out, lse, dout, vl, heads)
    exact = _backward_f64(q, k, v, out, lse, dout, vl, heads)
    for j in range(3):  # dq, dk, dv
        cols = slice(j * d, (j + 1) * d)
        _assert_computed_rows_close(got[..., cols], ref[..., cols], rows)
        err = max((got[i, :m, cols].double() - exact[i, :m, cols]).abs().max().item()
                  for i, m in enumerate(rows) if m)
        plain = max((ref[i, :m, cols].double() - exact[i, :m, cols]).abs().max().item()
                    for i, m in enumerate(rows) if m)
        assert err <= 3 * plain, ("dq dk dv"[3 * j:3 * j + 2], err, plain)


# ---- ChAdaViT-B/16's bf16 K3 at head 64 on wgmma with TMA ----------------------------
# attention_forward at head 64 in bfloat16 (csrc/prefix_attention_bf16.cu,
# attention_fwd_wgmma_kernel) at B/16's width (12 heads of 64, q, k, v the
# column slices of one packed qkv with rows of 2304) on the hub shapes, the
# 7-channel bucket (32 sequences of 1 373 valid rows padded to 1 408: 8
# blocks of three 64-query tiles, the last one a tile and two past the
# image) and odd tiles (S 320: two blocks, the second with a tile past the
# image; prefixes that leave a block with live and dead tiles, and an image
# with no valid row), with the lse and without (the route that writes none): out and lse
# against the plain bf16 version (bf16_err) on the computed 64-query tiles,
# zeros and lse 1e30 past them, a second call repeating the bits, one launch
# a call under prefix_attention_fwd_bf16_hd64.
K3_HD64_BATCHES = {"hub": (2048, _HUB), "bucket7": (1408, [1 + 196 * 7] * 32),
                   "odd_tiles": (320, [1, 60, 64, 65, 129, 193, 257, 320, 0])}


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("batch", list(K3_HD64_BATCHES))
def test_bf16_head_64_wgmma_forward(dev, batch, with_lse):
    s, valid = K3_HD64_BATCHES[batch]
    d, heads = D16, H16
    rng = np.random.default_rng(640 + len(valid) + with_lse)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    qkv = _randn(rng, dev, len(valid), s, 3 * d).bfloat16()
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    rows = [min(-(-n // fa.SEQ_BLOCK) * fa.SEQ_BLOCK, s) for n in valid]
    name = "prefix_attention_fwd_bf16_hd64"
    before = _launch.LAUNCHES[name]
    (out, lse), (again, lse_again) = (fa.attention_forward(q, k, v, vl, heads, with_lse)
                                      for _ in range(2))
    assert _launch.LAUNCHES[name] == before + 2
    assert torch.equal(out, again), "a second call gives other bits"
    some = [i for i, n in enumerate(rows) if n]
    ref, rlse = fa.prefix_flash_attention_reference(q, k, v, vl, heads, return_lse=True)
    _assert_bf16_close(out[some], ref[some], [rows[i] for i in some])
    for i, n in enumerate(rows):  # the query tiles past the prefix: zeros
        assert not out[i, n:].any().item()
    if with_lse:
        assert torch.equal(lse, lse_again) and lse.shape == (len(valid), heads, s)
        _assert_bf16_close(lse[some].transpose(1, 2), rlse[some].transpose(1, 2),
                           [rows[i] for i in some])
        for i, n in enumerate(rows):
            assert (lse[i, :, n:] == 1e30).all().item()
    else:
        assert lse is None and lse_again is None


# ---- ChAdaViT-B/16's bf16 K2a: the 16-byte row pass at D 768 ----------------------
# layernorm_bwd at D 768 in bfloat16 (layernorm_bwd_wide_bf16_kernel, then
# reduce_ln_splits_kernel<768>) at phase 2c's narrow bf16 rows, at the
# 7-channel bucket's and at S 160 with an image of no valid row (splits of
# one tile, of several, of none computed), with the site-1 residual and dgb
# summed into and without: dx against the plain version (bf16_err) on the
# rows of the computed 32-row tiles, exact zeros past them; dgamma and dbeta
# bit for bit the order that layernorm_bwd_kernel sums them in
# (tests/torch_ln_bwd_order.py::param_sums_order at the wrapper's split
# count), and a second call repeating every bit.
K2A_D768_BATCHES = {"narrow": (1408, [1 + 196 * c for c in (1, 3, 5, 7, 2, 7, 4, 6)]),
                    "bucket7": (1408, [1 + 196 * 7] * 32),
                    "straddle": (160, [1, 33, 0, 97, 160, 129])}


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("batch", list(K2A_D768_BATCHES))
def test_bf16_d768_layernorm_bwd_row_pass(dev, batch, residual):
    from chadavit_tpu_torch.ops.layernorm import layernorm_stats

    s, valid = K2A_D768_BATCHES[batch]
    d, bsz = D16, len(valid)
    rng = np.random.default_rng(768 + len(valid) + residual)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    xin = (_randn(rng, dev, bsz, s, d) * 2 + 0.5).bfloat16()
    dy = _tail_cotangent(_randn(rng, dev, bsz, s, d), valid, fused_block.ROW_BLOCK).bfloat16()
    res = _randn(rng, dev, bsz, s, d).bfloat16() if residual else None
    g = 1 + _randn(rng, dev, d, scale=0.1)
    mean, rstd = (t[..., 0].contiguous() for t in layernorm_stats(xin, 1e-5))
    dgb0 = _randn(rng, dev, 2 * d) if residual else None
    name = "layernorm_bwd_bf16_d768"
    before = _launch.LAUNCHES[name]
    runs = [fused_block.layernorm_bwd(dy, xin, mean, rstd, g, vl, residual=res,
                                      dgb=None if dgb0 is None else dgb0.clone())
            for _ in range(2)]
    assert _launch.LAUNCHES[name] == before + 2
    (dx, dgb), (dx2, dgb2) = runs
    assert torch.equal(dx, dx2) and torch.equal(dgb, dgb2), "a second call gives other bits"
    splits = fused_block.layernorm_bwd_splits(bsz, s, d)
    model = ln_bwd_order.param_sums_order(dy, xin, mean, rstd, vl, splits, dgb0)
    assert torch.equal(dgb, model), (dgb - model).abs().max().item()
    rdx, _ = fused_block.layernorm_bwd_reference(dy, xin, mean, rstd, g, vl, residual=res)
    rows = [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in valid]
    some = [i for i, n in enumerate(rows) if n]
    _assert_bf16_close(dx[some], rdx[some], [rows[i] for i in some])
    for i, n in enumerate(rows):
        assert not dx[i, n:].any().item()
