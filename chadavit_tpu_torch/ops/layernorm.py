"""LayerNorm with the JAX package's numerics: the plain path and the kernels.

Counterpart of ``chadavit_tpu/ops/layernorm.py``: ``layernorm`` (:218) and
its two Pallas paths, ``fused_layernorm`` (:174) and
``fused_layernorm_residual`` (:196), whose custom VJPs run the forward kernel
``_ln_fwd_kernel`` (:38, through ``_ln_fwd_impl`` :95) and the backward kernel
``_ln_bwd_kernel`` (:55, through ``_ln_bwd_impl`` :130).

``layernorm(..., impl)`` dispatches as the JAX function: ``"auto"`` and
``"xla"`` take the plain path (the residual add in the input dtype, f32
stats, fast variance ``mean(x^2) - mean(x)^2`` clamped at 0, f32 scale and
bias, the output cast to the input dtype); ``"pallas"`` takes
:class:`FusedLayerNorm` / :class:`FusedLayerNormResidual`, whose forward is
:func:`ln_fwd` and whose backward is :func:`ln_bwd`. On CUDA tensors those
launch the kernels of ``csrc/layernorm.cu`` (C entry points ``ln_fwd``,
``ln_bwd`` and their ``_bf16`` twins); on CPU tensors they run their plain
versions, :func:`ln_fwd_reference` and :func:`ln_bwd_reference`.

The kernel path keeps the Pallas path's numerics, which differ from the
plain path in one point: scale and bias are rounded to x's dtype before the
kernel (``layernorm.py:126``, ``:166``), so in bfloat16 ``"pallas"`` and
``"xla"`` differ by design; in float32 they agree. The mean and rstd are
saved as f32 rows of x's leading shape; the gradients of scale and bias come
back in the parameters' dtype (float32), and ``LN(x + r)`` hands its one
cotangent back to both addends (``_flr_bwd``, ``layernorm.py:209-212``).
"""

from __future__ import annotations

from typing import Optional

import torch

from chadavit_tpu_torch.ops import _build, _launch

LN_MAX_D = 1024  # the widest row the kernels take; D must also be a multiple of 4
# The backward kernel cuts the M rows into ln_bwd_splits(M) contiguous
# splits, one block each: LN_BWD_SPLIT_ROWS rows a split at most, and never
# more than LN_BWD_MAX_SPLITS splits. A function of M alone, so dgamma and
# dbeta are the same bits on every card and run, and the (splits, 2 D) f32
# partial sums stay at most 2 MB (384 KB at D 192) whatever the batch. At the
# hub's 16 384 rows that is 256 splits of 64 rows, two blocks an SM; more rows
# make the 256 splits longer (scripts/bench_layernorm_bwd.py times other
# choices).
LN_BWD_SPLIT_ROWS = 64
LN_BWD_MAX_SPLITS = 256


def ln_bwd_splits(m: int) -> int:
    """Row splits of the backward kernel for ``m`` rows: one block each."""
    return max(1, min(LN_BWD_MAX_SPLITS, -(-m // LN_BWD_SPLIT_ROWS)))


def ln_bwd_split_rows(m: int, splits: int) -> list:
    """The rows each split of the backward kernel walks, as the kernel
    assigns them: split ``i`` takes ``[i * m // splits, (i + 1) * m // splits)``
    and writes one partial row of ``[dgamma, dbeta]``."""
    return [range(i * m // splits, (i + 1) * m // splits) for i in range(splits)]


def ln_bwd_scratch(m: int, d: int, device) -> torch.Tensor:
    """The backward kernel's partial sums for ``m`` rows of width ``d``:
    ``(ln_bwd_splits(m), 2 d)`` f32, one row ``[dgamma, dbeta]`` a split."""
    return torch.empty((ln_bwd_splits(m), 2 * d), dtype=torch.float32, device=device)


def layernorm_stats(x: torch.Tensor, eps: float):
    """f32 row stats over the last dim: ``(mean, rstd)``, each keeping a
    trailing dim of 1."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return mu, torch.rsqrt(var + eps)


def plain_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``LN(x)``, or ``LN(x + residual)``, over the last dim: the XLA path."""
    if residual is not None:
        x = x + residual
    mu, rstd = layernorm_stats(x, eps)
    y = (x.float() - mu) * rstd
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------- plain versions ----
def ln_fwd_reference(x, residual, gamma, beta, eps: float):
    """Plain version of the forward kernel: ``(y, mean, rstd)`` of
    ``LN(x [+ residual])``, gamma and beta rounded to x's dtype first; mean
    and rstd f32 of shape ``x.shape[:-1]``."""
    if residual is not None:
        x = x + residual  # the input-dtype add
    mu, rstd = layernorm_stats(x, eps)
    xhat = (x.float() - mu) * rstd
    y = xhat * gamma.to(x.dtype).float() + beta.to(x.dtype).float()
    return y.to(x.dtype), mu[..., 0], rstd[..., 0]


def ln_bwd_reference(x, residual, gamma, mean, rstd, dy):
    """Plain version of the backward kernel: ``(dx, dgamma, dbeta)`` from the
    saved stats; dx in x's dtype (also the residual's gradient), dgamma and
    dbeta f32 sums over every row."""
    if residual is not None:
        x = x + residual
    d = x.shape[-1]
    xhat = (x.float() - mean[..., None]) * rstd[..., None]
    dyf = dy.float()
    dxhat = dyf * gamma.to(x.dtype).float()
    m1 = dxhat.sum(-1, keepdim=True) / d
    m2 = (dxhat * xhat).sum(-1, keepdim=True) / d
    dx = rstd[..., None] * (dxhat - m1 - xhat * m2)
    return (dx.to(x.dtype), (dyf * xhat).reshape(-1, d).sum(0),
            dyf.reshape(-1, d).sum(0))


# ------------------------------------------------------- kernel wrappers ----
def _rows_of(name: str, t: torch.Tensor, shape, dtype) -> int:
    if t.shape != shape:
        raise ValueError(f"{name}: want {tuple(shape)}, got {tuple(t.shape)}")
    return _launch.vector_operand(t, name, dtype)


def _check_width(name: str, d: int) -> None:
    if d > LN_MAX_D or d % 4:
        raise ValueError(f"{name}: the kernel takes rows of at most {LN_MAX_D} elements, "
                         f"a multiple of 4; got {d}")


def ln_fwd(x, residual, gamma, beta, eps: float):
    """``(y, mean, rstd)`` of ``LN(x [+ residual])`` over the last dim (kernel
    ``ln_fwd`` on CUDA). x and residual of one dtype, float32 or bfloat16;
    gamma and beta of any float dtype, rounded to x's; mean and rstd f32 of
    shape ``x.shape[:-1]``."""
    if _launch.on_cpu(x, gamma, beta):
        return ln_fwd_reference(x, residual, gamma, beta, eps)
    dt, d = x.dtype, x.shape[-1]
    _check_width("ln_fwd", d)
    m = x.numel() // d
    g, b = gamma.to(dt).contiguous(), beta.to(dt).contiguous()
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    name = _launch.entry_point("ln_fwd", dt)
    status = getattr(_build.library(), name)(
        _rows_of("x", x, x.shape, dt),
        None if residual is None else _rows_of("residual", residual, x.shape, dt),
        _rows_of("gamma", g, (d,), dt), _rows_of("beta", b, (d,), dt), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), m, d, eps, _launch.stream(x.device))
    _build.check(status, name)
    _launch.counted(name)
    return y, mean, rstd


def ln_bwd(x, residual, gamma, mean, rstd, dy):
    """``(dx, dgamma, dbeta)`` of ``LN(x [+ residual])`` from its saved stats
    (kernel ``ln_bwd`` on CUDA); dgamma and dbeta are f32, summed over the
    rows in a fixed order (one partial row a split of :func:`ln_bwd_splits`,
    then a second pass in split order)."""
    if _launch.on_cpu(x, gamma, mean, rstd, dy):
        return ln_bwd_reference(x, residual, gamma, mean, rstd, dy)
    dt, d = x.dtype, x.shape[-1]
    _check_width("ln_bwd", d)
    m = x.numel() // d
    if m == 0:
        raise ValueError("ln_bwd: no rows")
    g = gamma.to(dt).contiguous()
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    partial = ln_bwd_scratch(m, d, x.device)
    splits = partial.shape[0]
    dgb = torch.empty(2 * d, dtype=torch.float32, device=x.device)
    name = _launch.entry_point("ln_bwd", dt)
    status = getattr(_build.library(), name)(
        _rows_of("x", x, x.shape, dt),
        None if residual is None else _rows_of("residual", residual, x.shape, dt),
        _rows_of("gamma", g, (d,), dt), _rows_of("mean", mean, x.shape[:-1], torch.float32),
        _rows_of("rstd", rstd, x.shape[:-1], torch.float32),
        _rows_of("dy", dy, x.shape, dt), dx.data_ptr(), partial.data_ptr(), dgb.data_ptr(),
        m, d, splits, _launch.stream(x.device))
    _build.check(status, name)
    _launch.counted(name)
    return dx, dgb[:d], dgb[d:]


class FusedLayerNorm(torch.autograd.Function):
    """``LN(x)``: forward :func:`ln_fwd`, backward :func:`ln_bwd` (the JAX
    ``fused_layernorm`` and its custom VJP)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = ln_fwd(x, None, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dg, db = ln_bwd(x, None, gamma, mean, rstd, dy.contiguous())
        return dx, dg.to(gamma.dtype), db.to(gamma.dtype), None


class FusedLayerNormResidual(torch.autograd.Function):
    """``LN(x + r)`` with the add inside the kernel: forward :func:`ln_fwd`,
    backward :func:`ln_bwd`, whose dx is the gradient of both addends (the
    JAX ``fused_layernorm_residual`` and its custom VJP)."""

    @staticmethod
    def forward(ctx, x, r, gamma, beta, eps):
        y, mean, rstd = ln_fwd(x, r, gamma, beta, eps)
        ctx.save_for_backward(x, r, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, r, gamma, mean, rstd = ctx.saved_tensors
        dx, dg, db = ln_bwd(x, r, gamma, mean, rstd, dy.contiguous())
        return dx, dx, dg.to(gamma.dtype), db.to(gamma.dtype), None


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
              impl: str = "auto", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``LN(x)``, or ``LN(x + residual)``, over the last dim. ``impl``:
    ``"auto"`` and ``"xla"`` the plain path (the JAX ``"auto"`` resolves to
    XLA too), ``"pallas"`` the kernels."""
    if impl in ("auto", "xla"):
        return plain_layernorm(x, scale, bias, eps, residual)
    if impl != "pallas":
        raise ValueError(f"layernorm impl {impl!r}: want 'auto', 'xla' or 'pallas'")
    x = x.contiguous()
    if residual is not None:
        return FusedLayerNormResidual.apply(x, residual.contiguous(), scale, bias, eps)
    return FusedLayerNorm.apply(x, scale, bias, eps)
