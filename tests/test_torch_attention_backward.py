"""The gradient of the port's prefix attention (chadavit_tpu_torch/ops/
flash_attention.py: PrefixFlashAttention and prefix_attention_bwd) held
against the JAX package on the CPU: ``jax.vjp`` of the Pallas kernel in
interpret mode (its custom VJP, the TPU backward kernel), and torch autograd
through the plain forward. The cotangent is zero on query rows past
``valid_len``, the contract the model keeps (it reads only CLS).

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
from chadavit_tpu_torch.ops import flash_attention
from tests.test_torch_fused_block_backward import fake_cuda  # noqa: F401 (a fixture)

B, S, D, H = 3, 256, 32, 2
VALID = [256, 130, 60]
TOL = dict(rtol=3e-5, atol=3e-5)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(4))
    for i, n in enumerate(VALID):
        g[i, n:] = 0.0  # the model's contract: no cotangent past the prefix
    return q, k, v, g, np.asarray(VALID, np.int32)


def _port_grads(q, k, v, g, vl, forward):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = forward(qt, kt, vt, torch.from_numpy(vl), H)
    return out, torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))


def test_matches_jax_vjp_of_the_pallas_kernel():
    q, k, v, g, vl = _inputs()
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, jnp.asarray(vl), H, 128, True),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    out, grads = _port_grads(q, k, v, g, vl, flash_attention.prefix_flash_attention)
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
    q, k, v = _qkv(2 * flash_attention.HEAD_DIM, True)
    vl = torch.tensor([128, 3], dtype=torch.int32)
    out = flash_attention.prefix_flash_attention(q, k, v, vl, 2)
    assert type(out.grad_fn).__name__ == "PrefixFlashAttentionBackward"
    assert fake_cuda.calls == ["prefix_attention_fwd"]
    before = flash_attention.prefix_attention_bwd.launches
    out.backward(torch.zeros_like(out))
    assert fake_cuda.calls == ["prefix_attention_fwd", "prefix_attention_bwd"]
    assert flash_attention.prefix_attention_bwd.launches == before + 1
    assert q.grad is not None and q.grad.shape == q.shape


def test_cuda_route_without_grad_takes_the_save_free_launch(fake_cuda):
    q, k, v = _qkv(2 * flash_attention.HEAD_DIM, True)
    vl = torch.tensor([128, 3], dtype=torch.int32)
    with torch.no_grad():
        out = flash_attention.prefix_flash_attention(q, k, v, vl, 2)
    assert out.grad_fn is None and fake_cuda.calls == ["prefix_attention_fwd"]


@pytest.mark.parametrize("d", [D, 2 * 64])
def test_cuda_route_backward_refuses_other_head_widths(fake_cuda, d):
    q, k, v = _qkv(d, False)
    lse = torch.zeros(2, 2, 128)
    with pytest.raises(ValueError):
        flash_attention.prefix_attention_bwd(q, k, v, q, lse, q,
                                             torch.tensor([128, 3], dtype=torch.int32), 2)
    assert fake_cuda.calls == []
