"""One ChAdaViT encoder layer, forward and backward, as chains of CUDA kernels.

Counterpart of ``chadavit_tpu/ops/fused_block.py`` (``_stats`` :68,
``_fwd_kernel`` :91, ``_bwd_kernel`` :211, ``_run_fwd`` :519,
``fused_encoder_block`` :572 with its custom VJP ``_vjp_fwd`` :587 and
``_vjp_bwd`` :597). The TPU kernels hold a whole layer of one image in VMEM,
which does not fit a Hopper block's shared memory, so the forward is the chain

    qkv = ln_linear(x)                       LN1, then x @ Wqkv^T + bqkv
    a   = prefix_flash_attention(qkv)         ops/flash_attention.py
    x2  = linear_residual_ln(a, Wout, x)      LN1(x + a @ Wout^T + bout)
    hid = linear_relu(x2)                     relu(x2 @ W1^T + b1)
    y   = linear_residual_ln(hid, W2, x2)     LN2(x2 + hid @ W2^T + b2)

behind :func:`fused_encoder_block`, whose signature follows the JAX function.
When autograd records the call it runs :class:`FusedEncoderBlock`, whose
forward also saves the JAX residual set (``x``, ``attn``, ``x2``, ``r2``, the
base-2 lse and the three pairs of LN stats) and whose backward is the chain of
``csrc/fused_block_bwd.cu`` (:func:`layernorm_bwd`, :func:`linear_dgrad`,
:func:`linear_wgrad`) around ``prefix_attention_bwd``; it recomputes h, qkv
and the FFN hidden as the TPU kernel does, and saves none of them. The
teacher's forward runs under ``torch.no_grad()`` and takes the save-free
launches.

Weights are in torch ``nn.Linear`` layout, ``(out, in)``: the transpose of the
JAX kernels. The GEMM kernels are ``csrc/fused_block.cu`` and
``csrc/fused_block_bwd.cu``. Each step has a plain version here; a CPU tensor
takes it, a CUDA tensor the kernel.

Row tiles wholly past ``valid_len`` are skipped and written as zeros, as the
TPU kernel skips its fully-invalid sequence blocks. Rows past ``valid_len``
are not contractual (``chadavit_tpu/models/chada_vit.py:461-465``). The
backward keeps the contract the model needs: the cotangent is zero on rows
``>= valid_len`` (the model reads only CLS). Under it, dx on rows
``< valid_len`` and all 12 parameter gradients equal autograd through the
plain forward, and dx on rows ``>= valid_len`` is zero.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from chadavit_tpu_torch.ops import _build, _launch
from chadavit_tpu_torch.ops import flash_attention as fa
from chadavit_tpu_torch.ops.layernorm import layernorm_stats

ROW_BLOCK = 32  # the GEMM kernels' row tile and K slice
SEQ_PAD = 128   # the chain pads sequences to this multiple, as the model does
# The widths of ChAdaViT-moyen, the one model the kernels are built for; on
# CUDA tensors the wrappers raise on any other.
D_MODEL = 192
D_FFN = 2048
WGRAD_CHUNK = 1024  # the most rows one block of linear_wgrad sums


# ---------------------------------------------------------- plain versions ----
def _ln(x, mu, rstd, g, b):
    return ((x.float() - mu) * rstd * g.float() + b.float()).to(x.dtype)


def _row_mask(x: torch.Tensor, valid_len) -> torch.Tensor:
    """``(B, S, 1)`` bool: row ``< valid_len`` of its image."""
    s = x.shape[1]
    return (torch.arange(s, device=x.device)[None, :]
            < valid_len.to(x.device)[:, None])[..., None]


def ln_linear_reference(x, g, b, eps, w, bias, valid_len=None, save: bool = False):
    """``LN(x) @ w^T + bias``; x ``(B, S, K)``, w ``(N, K)``. With ``save``
    also the LN row mean and rstd, ``(B, S)`` each."""
    mu, rstd = layernorm_stats(x, eps)
    out = torch.matmul(_ln(x, mu, rstd, g, b), w.t()) + bias
    return (out, mu[..., 0], rstd[..., 0]) if save else out


def linear_relu_reference(x, w, bias, valid_len=None):
    """``relu(x @ w^T + bias)``."""
    return torch.relu(torch.matmul(x, w.t()) + bias)


def linear_residual_ln_reference(a, w, bias, residual, g, b, eps, valid_len=None,
                                 save: bool = False):
    """``LN(residual + (a @ w^T + bias))``: the residual add in the input
    dtype, then f32 LayerNorm (the double-norm1 site and the LN2 site). With
    ``save`` also the LN row mean and rstd ``(B, S)`` and the pre-LN sum r."""
    r = residual + (torch.matmul(a, w.t()) + bias)
    mu, rstd = layernorm_stats(r, eps)
    out = _ln(r, mu, rstd, g, b)
    return (out, mu[..., 0], rstd[..., 0], r) if save else out


def layernorm_bwd_reference(dy, xin, mean, rstd, g, valid_len, residual=None,
                            dgb=None):
    """Backward of ``y = LN(xin) g + beta`` from the saved row stats
    (``fused_block.py:242-252``): ``dx = rstd (dy g - mean(dy g) - xhat
    mean(dy g xhat))`` plus ``residual``, and ``dgb = [dgamma, dbeta]``
    ``(2 D,)``, summed into ``dgb`` when it is given. Rows ``>= valid_len``
    give nothing and get ``dx = 0``. Returns ``(dx, dgb)``."""
    ok = _row_mask(dy, valid_len)
    d = dy.shape[-1]
    dyf = torch.where(ok, dy.float(), 0.0)
    xhat = torch.where(ok, (xin.float() - mean[..., None]) * rstd[..., None], 0.0)
    dyg = dyf * g.float()
    m1 = dyg.sum(-1, keepdim=True) / d
    m2 = (dyg * xhat).sum(-1, keepdim=True) / d
    dx = rstd[..., None] * (dyg - m1 - xhat * m2)
    if residual is not None:
        dx = dx + residual
    dx = torch.where(ok, dx, 0.0).to(dy.dtype)
    sums = torch.cat([(dyf * xhat).sum((0, 1)), dyf.sum((0, 1))])
    if dgb is None:
        return dx, sums
    return dx, dgb.add_(sums)


def linear_dgrad_reference(dy, w, valid_len, relu_of=None, residual=None):
    """``dX = dY @ W`` (W in Linear layout ``(N_out, N_in)``), masked by
    ``relu_of > 0`` or plus ``residual``; rows ``>= valid_len`` are zero."""
    out = torch.matmul(dy, w)
    if relu_of is not None:
        out = torch.where(relu_of > 0, out, 0.0)
    if residual is not None:
        out = residual + out
    return torch.where(_row_mask(dy, valid_len), out, 0.0)


def linear_wgrad_reference(dy, x, valid_len, ln=None):
    """``(dW, db) = (dY^T X', colsum dY)`` over the rows ``< valid_len``;
    ``X' = LN(X)`` with ``ln = (mean, rstd, g, beta)``, else X."""
    ok = _row_mask(dy, valid_len)
    if ln is not None:
        mean, rstd, g, b = ln
        x = _ln(x, mean[..., None], rstd[..., None], g, b)
    dyf = torch.where(ok, dy, 0.0).reshape(-1, dy.shape[-1])
    xf = torch.where(ok, x, 0.0).reshape(-1, x.shape[-1])
    return torch.matmul(dyf.t(), xf), dyf.sum(0)


# ---------------------------------------------------------------- kernels ----
def _check(name: str, a, w, ks, n: int):
    """Shape checks of a GEMM step: a ``(B, S, K)`` with S a multiple of
    :data:`ROW_BLOCK` and K in ``ks``, w ``(n, K)``. Returns ``(B, S, K)``."""
    if (a.dim() != 3 or a.shape[1] % ROW_BLOCK or a.shape[2] not in ks
            or w.shape != (n, a.shape[2])):
        raise ValueError(
            f"{name}: the kernel takes a (B, S, K) with S a multiple of {ROW_BLOCK} and "
            f"K in {ks}, w ({n}, K); got {tuple(a.shape)} and {tuple(w.shape)}")
    return a.shape


def _stats_out(save: bool, bsz: int, s: int, like: torch.Tensor):
    if not save:
        return None, None
    return (torch.empty((bsz, s), dtype=torch.float32, device=like.device),
            torch.empty((bsz, s), dtype=torch.float32, device=like.device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def ln_linear(x, g, b, eps: float, w, bias, valid_len, save: bool = False):
    """``LN(x) @ w^T + bias`` (kernel ``ln_linear_fwd`` on CUDA); with
    ``save`` also the LN row mean and rstd. Forward only: raises where
    autograd would record the call."""
    _launch.refuse_grad("ln_linear", x, g, b, w, bias)
    if _launch.on_cpu(x, g, b, w, bias, valid_len):
        return ln_linear_reference(x, g, b, eps, w, bias, valid_len, save)
    n = 3 * D_MODEL
    bsz, s, k = _check("ln_linear", x, w, (D_MODEL,), n)
    if g.shape != (k,) or b.shape != (k,) or bias.shape != (n,):
        raise ValueError(f"ln_linear: g {tuple(g.shape)}, b {tuple(b.shape)}, "
                         f"bias {tuple(bias.shape)}")
    out = torch.empty((bsz, s, n), dtype=x.dtype, device=x.device)
    mean, rstd = _stats_out(save, bsz, s, x)
    status = _build.library().ln_linear_fwd(
        _launch.float_operand(x, "x"), _launch.float_operand(g, "g"),
        _launch.float_operand(b, "b"), eps, _launch.float_operand(w, "w"),
        _launch.float_operand(bias, "bias"), _launch.float_operand(out, "out"),
        _ptr(mean), _ptr(rstd), _launch.valid_len_operand(valid_len, bsz, x.device),
        bsz * s, k, n, s, _launch.stream(x.device))
    _build.check(status, "ln_linear_fwd")
    ln_linear.launches += 1
    return (out, mean, rstd) if save else out


def linear_relu(x, w, bias, valid_len):
    """``relu(x @ w^T + bias)`` (kernel ``linear_relu_fwd`` on CUDA).
    Forward only: raises where autograd would record the call."""
    _launch.refuse_grad("linear_relu", x, w, bias)
    if _launch.on_cpu(x, w, bias, valid_len):
        return linear_relu_reference(x, w, bias, valid_len)
    n = D_FFN
    bsz, s, k = _check("linear_relu", x, w, (D_MODEL,), n)
    if bias.shape != (n,):
        raise ValueError(f"linear_relu: bias {tuple(bias.shape)}")
    out = torch.empty((bsz, s, n), dtype=x.dtype, device=x.device)
    status = _build.library().linear_relu_fwd(
        _launch.float_operand(x, "x"), _launch.float_operand(w, "w"),
        _launch.float_operand(bias, "bias"), _launch.float_operand(out, "out"),
        _launch.valid_len_operand(valid_len, bsz, x.device), bsz * s, k, n, s,
        _launch.stream(x.device))
    _build.check(status, "linear_relu_fwd")
    linear_relu.launches += 1
    return out


def linear_residual_ln(a, w, bias, residual, g, b, eps: float, valid_len,
                       save: bool = False):
    """``LN(residual + (a @ w^T + bias))`` (kernel ``linear_residual_ln_fwd``
    on CUDA; one block owns whole output rows, so the LayerNorm is local).
    With ``save`` also the LN row mean and rstd and the pre-LN sum r. Forward
    only: raises where autograd would record the call."""
    _launch.refuse_grad("linear_residual_ln", a, w, bias, residual, g, b)
    if _launch.on_cpu(a, w, bias, residual, g, b, valid_len):
        return linear_residual_ln_reference(a, w, bias, residual, g, b, eps, valid_len,
                                            save)
    n = D_MODEL
    bsz, s, k = _check("linear_residual_ln", a, w, (D_MODEL, D_FFN), n)
    if (bias.shape != (n,) or residual.shape != (bsz, s, n) or g.shape != (n,)
            or b.shape != (n,)):
        raise ValueError(f"linear_residual_ln: residual {tuple(residual.shape)}, "
                         f"bias {tuple(bias.shape)}")
    out = torch.empty((bsz, s, n), dtype=a.dtype, device=a.device)
    mean, rstd = _stats_out(save, bsz, s, a)
    r = torch.empty_like(out) if save else None
    status = _build.library().linear_residual_ln_fwd(
        _launch.float_operand(a, "a"), _launch.float_operand(w, "w"),
        _launch.float_operand(bias, "bias"),
        _launch.float_operand(residual, "residual"),
        _launch.float_operand(g, "g"), _launch.float_operand(b, "b"), eps,
        _launch.float_operand(out, "out"), _ptr(mean), _ptr(rstd), _ptr(r),
        _launch.valid_len_operand(valid_len, bsz, a.device), bsz * s, k, n, s,
        _launch.stream(a.device))
    _build.check(status, "linear_residual_ln_fwd")
    linear_residual_ln.launches += 1
    return (out, mean, rstd, r) if save else out


def _rows(name: str, t, bsz: int, s: int, n: int) -> int:
    """Pointer of a contiguous f32 ``(bsz, s, n)`` CUDA tensor."""
    if t.shape != (bsz, s, n):
        raise ValueError(f"{name}: want ({bsz}, {s}, {n}), got {tuple(t.shape)}")
    return _launch.float_operand(t, name)


def _row_stats(name: str, t, bsz: int, s: int) -> int:
    if t.shape != (bsz, s):
        raise ValueError(f"{name}: want ({bsz}, {s}), got {tuple(t.shape)}")
    return _launch.float_operand(t, name)


def layernorm_bwd(dy, xin, mean, rstd, g, valid_len, residual=None, dgb=None):
    """Backward of a LayerNorm site from its saved row stats (kernel
    ``layernorm_bwd`` on CUDA): ``(dx, dgb)`` with ``dgb = [dgamma, dbeta]``
    ``(2 D,)``, summed into ``dgb`` in place when it is given (the two norm1
    sites). See :func:`layernorm_bwd_reference`."""
    if _launch.on_cpu(dy, xin, mean, rstd, g, valid_len):
        return layernorm_bwd_reference(dy, xin, mean, rstd, g, valid_len, residual, dgb)
    if dy.dim() != 3 or dy.shape[2] != D_MODEL or dy.shape[1] % ROW_BLOCK:
        raise ValueError(f"layernorm_bwd: the kernel takes (B, S, {D_MODEL}) with S a "
                         f"multiple of {ROW_BLOCK}, got {tuple(dy.shape)}")
    bsz, s, d = dy.shape
    if g.shape != (d,):
        raise ValueError(f"layernorm_bwd: g {tuple(g.shape)}")
    dx = torch.empty_like(dy)
    if dgb is None:
        dgb, accumulate = torch.empty(2 * d, dtype=torch.float32, device=dy.device), 0
    else:
        if dgb.shape != (2 * d,):
            raise ValueError(f"layernorm_bwd: dgb {tuple(dgb.shape)}")
        accumulate = 1
    partial = torch.empty((bsz * s // ROW_BLOCK, 2 * d), dtype=torch.float32,
                          device=dy.device)
    status = _build.library().layernorm_bwd(
        _rows("dy", dy, bsz, s, d), _rows("xin", xin, bsz, s, d),
        _row_stats("mean", mean, bsz, s), _row_stats("rstd", rstd, bsz, s),
        _launch.float_operand(g, "g"),
        None if residual is None else _rows("residual", residual, bsz, s, d),
        dx.data_ptr(), partial.data_ptr(), _launch.float_operand(dgb, "dgb"), accumulate,
        _launch.valid_len_operand(valid_len, bsz, dy.device), bsz * s, d, s,
        _launch.stream(dy.device))
    _build.check(status, "layernorm_bwd")
    layernorm_bwd.launches += 1
    return dx, dgb


_EPILOGUE_NONE, _EPILOGUE_RELU_MASK, _EPILOGUE_RESIDUAL = 0, 1, 2
_DGRAD_SITES = {  # (K, N, epilogue) of the layer's four data-gradient GEMMs
    (D_MODEL, D_FFN, _EPILOGUE_RELU_MASK), (D_FFN, D_MODEL, _EPILOGUE_RESIDUAL),
    (D_MODEL, D_MODEL, _EPILOGUE_NONE), (3 * D_MODEL, D_MODEL, _EPILOGUE_NONE)}


def linear_dgrad(dy, w, valid_len, relu_of=None, residual=None):
    """``dX = dY @ W`` (W in Linear layout), masked by ``relu_of > 0`` or plus
    ``residual`` (kernel ``linear_dgrad`` on CUDA, at the layer's four sites
    only). See :func:`linear_dgrad_reference`."""
    if _launch.on_cpu(dy, w, valid_len):
        return linear_dgrad_reference(dy, w, valid_len, relu_of, residual)
    if relu_of is not None and residual is not None:
        raise ValueError("linear_dgrad: one epilogue at a time")
    aux = relu_of if relu_of is not None else residual
    epilogue = (_EPILOGUE_RELU_MASK if relu_of is not None
                else _EPILOGUE_RESIDUAL if residual is not None else _EPILOGUE_NONE)
    if dy.dim() != 3 or dy.shape[1] % ROW_BLOCK or w.dim() != 2 or w.shape[0] != dy.shape[2] \
            or (w.shape[0], w.shape[1], epilogue) not in _DGRAD_SITES:
        raise ValueError(f"linear_dgrad: dy {tuple(dy.shape)}, w {tuple(w.shape)}, "
                         f"epilogue {epilogue}: not a site the kernel is built for")
    bsz, s, k = dy.shape
    n = w.shape[1]
    out = torch.empty((bsz, s, n), dtype=dy.dtype, device=dy.device)
    status = _build.library().linear_dgrad(
        _rows("dy", dy, bsz, s, k), _launch.float_operand(w, "w"),
        None if aux is None else _rows("aux", aux, bsz, s, n), out.data_ptr(), epilogue,
        _launch.valid_len_operand(valid_len, bsz, dy.device), bsz * s, k, n, s,
        _launch.stream(dy.device))
    _build.check(status, "linear_dgrad")
    linear_dgrad.launches += 1
    return out


_WGRAD_SHAPES = {(3 * D_MODEL, D_MODEL), (D_MODEL, D_MODEL), (D_FFN, D_MODEL),
                 (D_MODEL, D_FFN)}


def wgrad_chunk(s_pad: int) -> int:
    """Rows per block of ``linear_wgrad``: the largest power of two up to
    :data:`WGRAD_CHUNK` that divides ``s_pad``."""
    chunk = WGRAD_CHUNK
    while s_pad % chunk:
        chunk //= 2
    return chunk


def linear_wgrad(dy, x, valid_len, ln=None):
    """``(dW, db) = (dY^T X', colsum dY)`` over the rows ``< valid_len``, with
    ``X' = LN(X)`` from ``ln = (mean, rstd, g, beta)`` applied as X is staged
    (kernel ``linear_wgrad`` on CUDA, at the layer's four weight shapes only).
    See :func:`linear_wgrad_reference`."""
    if _launch.on_cpu(dy, x, valid_len):
        return linear_wgrad_reference(dy, x, valid_len, ln)
    if dy.dim() != 3 or x.dim() != 3 or dy.shape[:2] != x.shape[:2] \
            or dy.shape[1] % ROW_BLOCK or (dy.shape[2], x.shape[2]) not in _WGRAD_SHAPES:
        raise ValueError(f"linear_wgrad: dy {tuple(dy.shape)}, x {tuple(x.shape)}: not a "
                         "weight shape the kernel is built for")
    bsz, s, n = dy.shape
    k = x.shape[2]
    chunk = wgrad_chunk(s)
    dwb = torch.empty(n * k + n, dtype=torch.float32, device=dy.device)
    partial = torch.empty((bsz * s // chunk, n * k + n), dtype=torch.float32,
                          device=dy.device)
    if ln is None:
        ln_ptrs = (None,) * 4
    else:
        mean, rstd, g, b = ln
        if g.shape != (k,) or b.shape != (k,):
            raise ValueError(f"linear_wgrad: g {tuple(g.shape)}, b {tuple(b.shape)}")
        ln_ptrs = (_row_stats("mean", mean, bsz, s), _row_stats("rstd", rstd, bsz, s),
                   _launch.float_operand(g, "g"), _launch.float_operand(b, "b"))
    status = _build.library().linear_wgrad(
        _rows("dy", dy, bsz, s, n), _rows("x", x, bsz, s, k), *ln_ptrs,
        partial.data_ptr(), dwb.data_ptr(),
        _launch.valid_len_operand(valid_len, bsz, dy.device), bsz * s, n, k, s, chunk,
        _launch.stream(dy.device))
    _build.check(status, "linear_wgrad")
    linear_wgrad.launches += 1
    return dwb[:n * k].view(n, k), dwb[n * k:]


ln_linear.launches = 0
linear_relu.launches = 0
linear_residual_ln.launches = 0
layernorm_bwd.launches = 0
linear_dgrad.launches = 0
linear_wgrad.launches = 0


# ------------------------------------------------------------- the layer ----
# The steps of the layer: the wrappers (kernels on CUDA tensors, plain versions
# on CPU tensors) or the plain versions on any device.
KERNEL_STEPS = SimpleNamespace(
    ln_linear=ln_linear, linear_relu=linear_relu, linear_residual_ln=linear_residual_ln,
    attention=fa.attention_forward, attention_bwd=fa.prefix_attention_bwd,
    layernorm_bwd=layernorm_bwd, linear_dgrad=linear_dgrad, linear_wgrad=linear_wgrad)


def _plain_attention(q, k, v, valid_len, num_heads, with_lse):
    out = fa.prefix_flash_attention_reference(q, k, v, valid_len, num_heads, with_lse)
    return out if with_lse else (out, None)


PLAIN_STEPS = SimpleNamespace(
    ln_linear=ln_linear_reference, linear_relu=linear_relu_reference,
    linear_residual_ln=linear_residual_ln_reference, attention=_plain_attention,
    attention_bwd=fa.prefix_flash_attention_backward_reference,
    layernorm_bwd=layernorm_bwd_reference, linear_dgrad=linear_dgrad_reference,
    linear_wgrad=linear_wgrad_reference)


def _pad_seq(x: torch.Tensor) -> torch.Tensor:
    s = x.shape[1]
    s_pad = -(-s // SEQ_PAD) * SEQ_PAD
    return x if s == s_pad else F.pad(x, (0, 0, 0, s_pad - s))


def layer_forward(steps, x, valid_len, weights, num_heads, eps1, eps2, save):
    """``y``, and with ``save`` the residuals ``(attn, x2, r2, lse, stats)``,
    stats the (mean, rstd) pairs of LN1, the site-2 norm1 and LN2."""
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = weights
    d = x.shape[2]
    if not save:
        qkv = steps.ln_linear(x, g1, b1, eps1, wqkv, bqkv, valid_len)
        a, _ = steps.attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                               valid_len, num_heads, False)
        x2 = steps.linear_residual_ln(a, wout, bout, x, g1, b1, eps1, valid_len)
        hid = steps.linear_relu(x2, w1, b1f, valid_len)
        return steps.linear_residual_ln(hid, w2, b2f, x2, g2, b2, eps2, valid_len)
    qkv, mu1, rstd1 = steps.ln_linear(x, g1, b1, eps1, wqkv, bqkv, valid_len, save=True)
    a, lse = steps.attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                             valid_len, num_heads, True)
    x2, mu2, rstd2, _ = steps.linear_residual_ln(a, wout, bout, x, g1, b1, eps1,
                                                 valid_len, save=True)
    hid = steps.linear_relu(x2, w1, b1f, valid_len)
    y, mu3, rstd3, r2 = steps.linear_residual_ln(hid, w2, b2f, x2, g2, b2, eps2,
                                                 valid_len, save=True)
    return y, (a, x2, r2, lse, (mu1, rstd1, mu2, rstd2, mu3, rstd3))


def layer_backward(steps, dy, x, valid_len, attn, x2, r2, lse, stats, weights,
                    num_heads, eps1):
    """``(dx, 12 parameter grads)`` of the layer from the saved residuals, the
    TPU kernel's phases B', C' and D' (``fused_block.py:254-432``) as a chain;
    h, qkv and the FFN hidden are recomputed, not saved."""
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = weights
    mu1, rstd1, mu2, rstd2, mu3, rstd3 = stats
    d = x.shape[2]
    # B': LN2, the FFN, then the site-2 norm1
    dr2, dgb2 = steps.layernorm_bwd(dy, r2, mu3, rstd3, g2, valid_len)
    hid = steps.linear_relu(x2, w1, b1f, valid_len)
    dw2, db2f = steps.linear_wgrad(dr2, hid, valid_len)
    dz1 = steps.linear_dgrad(dr2, w2, valid_len, relu_of=hid)
    del hid
    dw1, db1f = steps.linear_wgrad(dz1, x2, valid_len)
    dx2 = steps.linear_dgrad(dz1, w1, valid_len, residual=dr2)
    del dz1
    # the site-2 pre-LN sum x + (a @ Wout^T + bout), recomputed
    r = steps.linear_residual_ln(attn, wout, bout, x, g1, b1, eps1, valid_len, save=True)[3]
    dr, dgb1 = steps.layernorm_bwd(dx2, r, mu2, rstd2, g1, valid_len)
    del r, dx2
    dwout, dbout = steps.linear_wgrad(dr, attn, valid_len)
    da = steps.linear_dgrad(dr, wout, valid_len)
    # C': the attention, from recomputed q, k, v
    qkv = steps.ln_linear(x, g1, b1, eps1, wqkv, bqkv, valid_len)
    dqkv = steps.attention_bwd(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                               attn, lse, da, valid_len, num_heads)
    del qkv, da
    # D': the QKV projection with LN1 applied as x is staged, then the site-1
    # LN1, whose dgamma/dbeta add into site 2's
    dwqkv, dbqkv = steps.linear_wgrad(dqkv, x, valid_len, ln=(mu1, rstd1, g1, b1))
    dh = steps.linear_dgrad(dqkv, wqkv, valid_len)
    dx, dgb1 = steps.layernorm_bwd(dh, x, mu1, rstd1, g1, valid_len, residual=dr, dgb=dgb1)
    return (dx, dwqkv, dbqkv, dwout, dbout, dgb1[:d], dgb1[d:], dgb2[:d], dgb2[d:],
            dw1, db1f, dw2, db2f)


class FusedEncoderBlock(torch.autograd.Function):
    """The layer with a gradient. Forward: the chain with the save outputs on;
    it saves exactly the JAX residual set (``fused_block.py:587-595``).
    Backward: :func:`layer_backward` through the kernel wrappers. Takes x
    already padded to :data:`SEQ_PAD`."""

    @staticmethod
    def forward(ctx, x, valid_len, num_heads, eps1, eps2, *weights):
        y, (attn, x2, r2, lse, stats) = layer_forward(
            KERNEL_STEPS, x, valid_len, weights, num_heads, eps1, eps2, save=True)
        ctx.save_for_backward(x, valid_len, attn, x2, r2, lse, *stats, *weights)
        ctx.num_heads, ctx.eps1 = num_heads, eps1
        return y

    @staticmethod
    def backward(ctx, dy):
        x, valid_len, attn, x2, r2, lse, *rest = ctx.saved_tensors
        stats, weights = rest[:6], rest[6:]
        dx, *grads = layer_backward(KERNEL_STEPS, dy.contiguous(), x, valid_len, attn,
                                     x2, r2, lse, stats, weights, ctx.num_heads, ctx.eps1)
        return (dx, None, None, None, None,
                *(gr.reshape(w.shape) for gr, w in zip(grads, weights)))


def fused_encoder_block(x, valid_len, wqkv, bqkv, wout, bout, g1, b1, g2, b2,
                        w1, b1f, w2, b2f, num_heads: int, eps1: float = 1e-5,
                        eps2: float = 1e-5) -> torch.Tensor:
    """One ChAdaViT encoder layer. x ``(B, S, D)``; returns ``(B, S, D)``.

    Weights in ``nn.Linear`` layout: wqkv ``(3D, D)``, wout ``(D, D)``,
    w1 ``(F, D)``, w2 ``(D, F)``. On CUDA every step is a kernel launch, at
    D = :data:`D_MODEL`, F = :data:`D_FFN` and 2 heads only. When autograd
    records the call (grad mode on and an input that requires grad) it runs
    :class:`FusedEncoderBlock`; otherwise (the teacher, serving) the chain
    without the save outputs.
    """
    if valid_len is None:
        raise ValueError("fused_encoder_block needs valid_len")
    weights = (wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f)
    s = x.shape[1]
    xp = _pad_seq(x)
    if _launch.needs_grad(x, *weights):
        y = FusedEncoderBlock.apply(xp, valid_len, num_heads, eps1, eps2, *weights)
    else:
        y = layer_forward(KERNEL_STEPS, xp, valid_len, weights, num_heads, eps1, eps2,
                           save=False)
    return y if y.shape[1] == s else y[:, :s]


def fused_encoder_block_reference(x, valid_len, wqkv, bqkv, wout, bout, g1, b1,
                                  g2, b2, w1, b1f, w2, b2f, num_heads: int,
                                  eps1: float = 1e-5, eps2: float = 1e-5):
    """The same layer through the plain versions only, on any device, with
    plain autograd."""
    weights = (wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f)
    return layer_forward(PLAIN_STEPS, x, valid_len, weights, num_heads, eps1, eps2,
                          save=False)


def fused_encoder_block_backward_reference(dy, x, valid_len, attn, x2, r2, lse, stats,
                                           weights, num_heads: int, eps1: float = 1e-5):
    """The backward chain through the plain version of every step, on any
    device: ``(dx, 12 parameter grads)`` from the residuals that
    :class:`FusedEncoderBlock` saves (``stats`` the six LN stat rows,
    ``weights`` the 12 parameters)."""
    return layer_backward(PLAIN_STEPS, dy, x, valid_len, attn, x2, r2, lse, stats,
                           weights, num_heads, eps1)
