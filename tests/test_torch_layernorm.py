"""The port's LayerNorm kernel path (``ops/layernorm.py``: ``layernorm(impl=
"pallas")`` through ``FusedLayerNorm`` / ``FusedLayerNormResidual``, whose
forward and backward take the plain versions of K5 and K6 on CPU tensors)
held against the JAX package's ``fused_layernorm`` and
``fused_layernorm_residual`` in interpret mode (their Pallas kernels and
custom VJPs), on the CPU.

Cases: float32 and bfloat16; eps 1e-5 (the layers) and 1e-6 (the final
norm); with and without the residual; rows (7, 11, 64), 77 rows that are not
a multiple of 8, (3, 50, 192), ChAdaViT-moyen's width, and (2, 1100, 192),
2200 rows: more than one of the JAX kernel's 2048-row blocks and no multiple
of it, so its dgamma and dbeta are summed over several blocks. The loss is
``sum((y - t)^2)`` (not LN-invariant); the gradients are those of x, of the
residual (the same array as x's), and of scale and bias (float32).

Tolerances, a few times the worst reading on this data:
- float32: outputs and stats 3e-6 absolute (read 7.2e-7); gradients 2e-6 of
  their largest entry (read 3.8e-7).
- bfloat16: y within 3e-2 or two bfloat16 steps of the JAX value at the
  entry's magnitude, whichever is larger (the bound of ``tests/test_torch_bf16.py``);
  dx within two steps at its largest entry (read one); float32 outputs
  (stats, dgamma, dbeta) within 1e-2 of their largest entry (read 2.9e-3). On the CPU, XLA's excess
  precision skips the JAX kernel's rounding of x + r to bfloat16, which moves
  every entry of a row through its mean and rstd: read 3.125e-2 at |y| 4.1
  (one step there). With ``XLA_FLAGS=--xla_allow_excess_precision=false``
  the port's y equals the JAX kernel's bit for bit on this data.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.ops.layernorm import fused_layernorm, fused_layernorm_residual
from chadavit_tpu_torch.ops import layernorm as ln

F32_ABS, F32_GRAD_REL = 3e-6, 2e-6
BF16_ABS, BF16_STEPS, BF16_F32_REL = 3e-2, 2, 1e-2
SHAPES = [(7, 11, 64), (3, 50, 192), (2, 1100, 192)]


def _bf16_step(a: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 values at |a| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _inputs(shape, dtype, residual, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32) if residual else None
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.05 * rng.standard_normal(d)).astype(np.float32)
    t = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":  # one set of bf16 values for both packages
        x = torch.from_numpy(x).bfloat16().float().numpy()
        r = None if r is None else torch.from_numpy(r).bfloat16().float().numpy()
    return x, r, g, b, t


def _jax(x, r, g, b, t, eps, dtype):
    jdt = getattr(jnp, dtype)
    args = [jnp.asarray(x, jdt)] + ([jnp.asarray(r, jdt)] if r is not None else []) \
        + [jnp.asarray(g), jnp.asarray(b)]

    def f(*a):
        if r is not None:
            return fused_layernorm_residual(*a, eps, True)
        return fused_layernorm(*a, eps, True)

    def loss(*a):
        return jnp.sum((f(*a).astype(jnp.float32) - jnp.asarray(t)) ** 2)

    y = f(*args)
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    return (np.asarray(y.astype(jnp.float32)),
            [np.asarray(gr.astype(jnp.float32)) for gr in grads])


def _port(x, r, g, b, t, eps, dtype):
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    rt = None if r is None else torch.from_numpy(r).to(tdt).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = ln.layernorm(xt, gt, bt, eps, impl="pallas", residual=rt)
    leaves = [xt] + ([rt] if rt is not None else []) + [gt, bt]
    grads = torch.autograd.grad(((y.float() - torch.from_numpy(t)) ** 2).sum(), leaves)
    assert y.dtype == tdt and grads[0].dtype == tdt
    assert grads[-1].dtype == grads[-2].dtype == torch.float32
    return y.float().detach().numpy(), [gr.float().numpy() for gr in grads]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_pallas_layernorm(dtype, eps, residual, shape):
    x, r, g, b, t = _inputs(shape, dtype, residual, seed=shape[1] + residual)
    ref_y, ref_g = _jax(x, r, g, b, t, eps, dtype)
    y, grads = _port(x, r, g, b, t, eps, dtype)
    if residual:  # one cotangent for both addends (the JAX _flr_bwd's dx, dx)
        np.testing.assert_array_equal(grads[0], grads[1])
    names = ["dx"] + (["dr"] if residual else []) + ["dgamma", "dbeta"]
    if dtype == "float32":
        np.testing.assert_allclose(y, ref_y, rtol=0, atol=F32_ABS)
        for name, gr, rg in zip(names, grads, ref_g):
            tol = F32_GRAD_REL * np.abs(rg).max()
            assert np.abs(gr - rg).max() <= tol, (name, np.abs(gr - rg).max(), tol)
        return
    tol_y = np.maximum(BF16_ABS, BF16_STEPS * _bf16_step(ref_y))
    assert np.all(np.abs(y - ref_y) <= tol_y), np.abs(y - ref_y).max()
    for name, gr, rg in zip(names, grads, ref_g):
        if name in ("dx", "dr"):
            tol = BF16_STEPS * _bf16_step(np.abs(rg).max())
        else:
            tol = BF16_F32_REL * np.abs(rg).max()
        assert np.abs(gr - rg).max() <= tol, (name, np.abs(gr - rg).max(), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stats_match_the_jax_kernel(dtype):
    # the saved mean and rstd (the JAX kernel's 8-lane rows; lane 0 here)
    from chadavit_tpu.ops.layernorm import _ln_fwd_impl

    x, r, g, b, _ = _inputs((7, 11, 64), dtype, True, seed=3)
    jdt = getattr(jnp, dtype)
    y, mu, rstd, _, _ = _ln_fwd_impl(jnp.asarray(x, jdt), jnp.asarray(r, jdt),
                                      jnp.asarray(g), jnp.asarray(b), 1e-6, True)
    py, pmu, prstd = ln.ln_fwd(torch.from_numpy(x).to(getattr(torch, dtype)),
                               torch.from_numpy(r).to(getattr(torch, dtype)),
                               torch.from_numpy(g), torch.from_numpy(b), 1e-6)
    assert pmu.shape == (7, 11) and pmu.dtype == prstd.dtype == torch.float32
    m = 7 * 11
    for got, ref in ((pmu, mu), (prstd, rstd)):
        ref = np.asarray(ref)[0, :m, 0]
        tol = F32_ABS if dtype == "float32" else BF16_F32_REL * np.abs(ref).max()
        np.testing.assert_allclose(got.reshape(-1).numpy(), ref, rtol=0, atol=tol)


def test_scale_and_bias_are_rounded_to_the_input_dtype():
    # the kernel path rounds gamma and beta to bf16 (layernorm.py:126), the
    # plain path keeps them f32: in float32 the two agree, in bfloat16 they
    # differ where the rounding shows
    x, _, g, b, _ = _inputs((3, 50, 192), "bfloat16", False, seed=5)
    g = g + np.float32(2.0 ** -12)  # not a bf16 value
    xt = torch.from_numpy(x)
    for dt in (torch.float32, torch.bfloat16):
        gt, bt = torch.from_numpy(g), torch.from_numpy(b)
        kernel = ln.layernorm(xt.to(dt), gt, bt, 1e-6, impl="pallas")
        plain = ln.layernorm(xt.to(dt), gt, bt, 1e-6, impl="xla")
        exact = ln.layernorm(xt.to(dt), gt.to(dt).float(), bt.to(dt).float(), 1e-6,
                             impl="xla")
        if dt == torch.float32:
            assert torch.allclose(kernel, plain, rtol=0, atol=F32_ABS)
        else:
            assert torch.equal(kernel, exact) and not torch.equal(kernel, plain)


def test_kernel_wrappers_count_no_launch_on_the_cpu():
    from chadavit_tpu_torch.ops import _launch

    before = dict(_launch.LAUNCHES)
    x = torch.randn(4, 64, requires_grad=True)
    g = torch.ones(64, requires_grad=True)
    ln.layernorm(x, g, torch.zeros(64), 1e-5, impl="pallas").sum().backward()
    assert dict(_launch.LAUNCHES) == before and g.grad is not None
    assert not math.isnan(float(x.grad.sum()))


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        ln.layernorm(torch.zeros(2, 8), torch.ones(8), torch.zeros(8), 1e-5, impl="cudnn")

