"""The gradient of the port's prefix attention (chadavit_tpu_torch/ops/
flash_attention.py: PrefixFlashAttention and prefix_attention_bwd) held
against the JAX package on the CPU: ``jax.vjp`` of the Pallas kernel in
interpret mode (its custom VJP, the TPU backward kernel), and torch autograd
through the plain forward. The cotangent is zero on query rows past
``valid_len``, as the model's (it reads only CLS); a cotangent on the tail
rows the forward computes is tested in tests/test_torch_bf16.py.

On the CPU the Function runs the plain versions; the CUDA kernels are held
against those on the card (test_torch_kernels_gpu.py, chip_smoke.py). The
CUDA route is driven here with the launch stubbed: with grad on it goes
through the Function, its backward reaches prefix_attention_bwd, and the
wrapper refuses head widths the kernel is not built for.

Tolerance: float32 on both sides, 3e-5 absolute and relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.ops.flash_attention import prefix_flash_attention as jax_flash
from chadavit_tpu_torch.ops import _launch, flash_attention
from tests.test_torch_fused_block_backward import fake_cuda  # noqa: F401 (a fixture)

B, S, D, H = 3, 256, 32, 2
VALID = [256, 130, 60]
TOL = dict(rtol=3e-5, atol=3e-5)
MOYEN_HD = 96  # ChAdaViT-moyen's head width (D 192, 2 heads)


def _inputs(seed=0, d=D):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, S, d)).astype(np.float32) for _ in range(4))
    for i, n in enumerate(VALID):
        g[i, n:] = 0.0  # the model's contract: no cotangent past the prefix
    return q, k, v, g, np.asarray(VALID, np.int32)


def _port_grads(q, k, v, g, vl, forward, heads=H):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = forward(qt, kt, vt, torch.from_numpy(vl), heads)
    return out, torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))


# (D, heads): head widths 32 and 16, a narrow head-64 model, and ChAdaViT-B/16's
# D 768 in 12 heads of 64, which the JAX kernel walks in two groups of 6 heads
@pytest.mark.parametrize("d, heads", [(32, 1), (32, 2), (128, 2), (768, 12)])
def test_matches_jax_vjp_of_the_pallas_kernel(d, heads):
    q, k, v, g, vl = _inputs(d=d)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, jnp.asarray(vl), heads, 128, True),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    out, grads = _port_grads(q, k, v, g, vl, flash_attention.prefix_flash_attention, heads)
    assert type(out.grad_fn).__name__ == "PrefixFlashAttentionBackward"
    for name, got, want in zip("qkv", grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"d{name}", **TOL)


def test_matches_autograd_of_the_plain_forward():
    q, k, v, g, vl = _inputs(1)
    _, grads = _port_grads(q, k, v, g, vl, flash_attention.prefix_flash_attention)
    _, ref = _port_grads(q, k, v, g, vl, flash_attention.prefix_flash_attention_reference)
    for name, got, want in zip("qkv", grads, ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=f"d{name}", **TOL)


def test_grads_past_the_prefix_are_zero():
    q, k, v, g, vl = _inputs(2)
    _, (dq, dk, dv) = _port_grads(q, k, v, g, vl, flash_attention.prefix_flash_attention)
    for i, n in enumerate(VALID):
        for t in (dq, dk, dv):
            assert not t[i, n:].any()


def test_unpadded_length_pads_and_slices():
    # S 200 is not a multiple of the kernel's 64-row tile: the Function takes
    # the padded tensors, the caller sees S 200 and its gradient
    q, k, v, g, vl = _inputs(3)
    q, k, v, g = (a[:, :200] for a in (q, k, v, g))
    vl = np.minimum(vl, 200)
    out, grads = _port_grads(q, k, v, g, vl, flash_attention.prefix_flash_attention)
    _, ref = _port_grads(q, k, v, g, vl, flash_attention.prefix_flash_attention_reference)
    assert out.shape == (B, 200, D)
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ---- the CUDA route, with the launch stubbed --------------------------------
def _qkv(d, requires_grad):
    return [torch.zeros(2, 128, d, requires_grad=requires_grad) for _ in range(3)]


def test_cuda_route_with_grad_is_the_function_and_its_backward_launches(fake_cuda):
    q, k, v = _qkv(2 * MOYEN_HD, True)
    vl = torch.tensor([128, 3], dtype=torch.int32)
    out = flash_attention.prefix_flash_attention(q, k, v, vl, 2)
    assert type(out.grad_fn).__name__ == "PrefixFlashAttentionBackward"
    assert fake_cuda.calls == ["prefix_attention_fwd"]
    before = _launch.LAUNCHES["prefix_attention_bwd"]
    out.backward(torch.zeros_like(out))
    assert fake_cuda.calls == ["prefix_attention_fwd", "prefix_attention_bwd"]
    assert _launch.LAUNCHES["prefix_attention_bwd"] == before + 1
    assert q.grad is not None and q.grad.shape == q.shape


def test_cuda_route_without_grad_takes_the_save_free_launch(fake_cuda):
    q, k, v = _qkv(2 * MOYEN_HD, True)
    vl = torch.tensor([128, 3], dtype=torch.int32)
    with torch.no_grad():
        out = flash_attention.prefix_flash_attention(q, k, v, vl, 2)
    assert out.grad_fn is None and fake_cuda.calls == ["prefix_attention_fwd"]


# head widths 16, 128 and 48: none is built (the kernels take 32, 64 and 96)
@pytest.mark.parametrize("d", [D, 2 * 128, 2 * 48])
def test_cuda_route_backward_refuses_other_head_widths(fake_cuda, d):
    q, k, v = _qkv(d, False)
    lse = torch.zeros(2, 2, 128)
    with pytest.raises(ValueError):
        flash_attention.prefix_attention_bwd(q, k, v, q, lse, q,
                                             torch.tensor([128, 3], dtype=torch.int32), 2)
    assert fake_cuda.calls == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [2, 12])
def test_cuda_route_head_64_reaches_the_kernels_with_its_width(fake_cuda, dtype, heads):
    # ChAdaViT-B/16's head width (D 768 in 12 heads) and a narrow model's
    q, k, v = (t.to(dtype).requires_grad_(True) for t in _qkv(64 * heads, False))
    vl = torch.tensor([128, 3], dtype=torch.int32)
    before = dict(_launch.LAUNCHES)
    out = flash_attention.prefix_flash_attention(q, k, v, vl, heads)
    out.backward(torch.zeros_like(out))
    tag = "" if dtype == torch.float32 else "_bf16"
    assert fake_cuda.calls == [f"prefix_attention_fwd{tag}", f"prefix_attention_bwd{tag}"]
    fwd, bwd = fake_cuda.args
    assert (fwd[9], fwd[10]) == (heads, 64) and (bwd[15], bwd[16]) == (heads, 64)
    assert fwd[12] == pytest.approx(flash_attention._qscale(64, dtype))
    assert bwd[19] == pytest.approx(1 / 8)
    for name in (f"prefix_attention_fwd{tag}", f"prefix_attention_bwd{tag}"):
        assert _launch.LAUNCHES[name + "_hd64"] == before.get(name + "_hd64", 0) + 1
        assert _launch.LAUNCHES[name] == before.get(name, 0)  # the head-96 count stays


# ---- the bf16 tensor-core kernels' operands (16-byte copies) ------------------
def _bf16_slices(row, offset, b=2, s=128):
    """q, k, v: column slices of rows of ``row`` bf16 elements, q's first
    column at ``offset``."""
    hd = MOYEN_HD
    buf = torch.zeros(b, s, row, dtype=torch.bfloat16)
    return [buf[..., offset + i * 2 * hd:offset + (i + 1) * 2 * hd] for i in range(3)]


def _bf16_call(which, q, k, v, o=None):
    vl = torch.tensor([128, 3], dtype=torch.int32)
    if which == "forward":
        with torch.no_grad():
            return flash_attention.prefix_flash_attention(q, k, v, vl, 2)
    o = torch.zeros_like(q, memory_format=torch.contiguous_format) if o is None else o
    return flash_attention.prefix_attention_bwd(q, k, v, o, torch.zeros(2, 2, 128), o, vl, 2)


@pytest.mark.parametrize("which", ["forward", "backward"])
@pytest.mark.parametrize("row, offset, what", [(580, 0, "multiple of 8"),
                                               (584, 4, "aligned")])
def test_cuda_route_bf16_refuses_rows_the_copies_cannot_take(fake_cuda, which, row, offset,
                                                            what):
    # a row stride of 580 elements, or q starting 8 bytes past a 16-byte boundary
    q, k, v = _bf16_slices(row, offset)
    with pytest.raises(ValueError, match=what):
        _bf16_call(which, q, k, v)
    assert fake_cuda.calls == []


def test_cuda_route_bf16_backward_refuses_a_misaligned_cotangent(fake_cuda):
    q, k, v = _bf16_slices(3 * 2 * MOYEN_HD, 0)
    flat = torch.zeros(q.numel() + 4, dtype=torch.bfloat16)
    o = flat[4:].view(q.shape)  # contiguous, 8 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        _bf16_call("backward", q, k, v, o)
    assert fake_cuda.calls == []


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_cuda_route_bf16_takes_the_packed_slices_as_they_are(fake_cuda, which):
    # the layer's packed qkv: rows of 576, q/k/v 384 bytes apart
    q, k, v = _bf16_slices(3 * 2 * MOYEN_HD, 0)
    _bf16_call(which, q, k, v)
    (args,) = fake_cuda.args
    assert fake_cuda.calls == [{"forward": "prefix_attention_fwd_bf16",
                                "backward": "prefix_attention_bwd_bf16"}[which]]
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), 576)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_cuda_route_takes_the_b16_packed_slices_as_they_are(fake_cuda, which, dtype):
    # ChAdaViT-B/16's packed qkv: rows of 2304, q/k/v 768 elements apart
    # (1536 bytes in bf16, 3072 in f32): both dtypes' kernels take them
    buf = torch.zeros(2, 128, 3 * 768, dtype=dtype)
    q, k, v = (buf[..., i * 768:(i + 1) * 768] for i in range(3))
    vl = torch.tensor([128, 3], dtype=torch.int32)
    if which == "forward":
        with torch.no_grad():
            flash_attention.prefix_flash_attention(q, k, v, vl, 12)
    else:
        o = torch.zeros(2, 128, 768, dtype=dtype)
        flash_attention.prefix_attention_bwd(q, k, v, o, torch.zeros(2, 12, 128), o, vl, 12)
    (args,) = fake_cuda.args
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), 2304)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_route_backward_allocates_its_scratch(fake_cuda, monkeypatch, dtype):
    # delta, then the scaled q in q's dtype right after it in the same buffer,
    # and for float32 then room for the images' order (one int32 an image)
    made = []

    def spy(*args):
        made.append(scratch(*args))
        return made[-1]

    scratch = flash_attention._bwd_scratch
    monkeypatch.setattr(flash_attention, "_bwd_scratch", spy)
    q, k, v = (t.to(dtype) for t in _bf16_slices(3 * 2 * MOYEN_HD, 0))
    _bf16_call("backward", q, k, v)
    ((delta, qs),) = made
    assert delta.dtype == torch.float32 and delta.shape == (2, 2, 128)
    assert fake_cuda.args[0][8] == delta.data_ptr()
    assert qs.dtype == dtype and qs.shape == q.shape
    assert qs.data_ptr() == delta.data_ptr() + 4 * delta.numel()
    assert qs.data_ptr() % 16 == 0
    if dtype == torch.float32:
        end = qs.data_ptr() + 4 * qs.numel() + 4 * q.shape[0]  # the order, one int32 an image
        storage = delta.untyped_storage()
        assert storage.data_ptr() + storage.nbytes() >= end


# ---- the float32 backward's operands (its 16-byte cp.async copies) ------------
def _f32_slices(row, offset, b=2, s=128):
    """q, k, v: float32 column slices of rows of ``row`` elements, q's first
    column at ``offset``."""
    hd = MOYEN_HD
    buf = torch.zeros(b, s, row)
    return [buf[..., offset + i * 2 * hd:offset + (i + 1) * 2 * hd] for i in range(3)]


@pytest.mark.parametrize("row, offset, copied", [(576, 0, False), (578, 0, True),
                                                 (580, 2, True)])
def test_cuda_route_f32_backward_copies_rows_its_copies_cannot_take(fake_cuda, row, offset,
                                                                    copied):
    # the packed qkv (rows of 576) goes as it is; a row stride that is not a
    # multiple of 4 elements, or q 8 bytes past a 16-byte boundary, is copied
    # into contiguous rows of 192
    q, k, v = _f32_slices(row, offset)
    _bf16_call("backward", q, k, v)
    (args,) = fake_cuda.args
    assert fake_cuda.calls == ["prefix_attention_bwd"]
    if copied:
        assert args[3] == q.shape[2] and q.data_ptr() not in args[:3]
        assert all(p % 16 == 0 for p in args[:3])
    else:
        assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), 576)


def test_cuda_route_f32_backward_refuses_a_misaligned_cotangent(fake_cuda):
    q, k, v = _f32_slices(3 * 2 * MOYEN_HD, 0)
    flat = torch.zeros(q.numel() + 2)
    o = flat[2:].view(q.shape)  # contiguous, 8 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        _bf16_call("backward", q, k, v, o)
    assert fake_cuda.calls == []
