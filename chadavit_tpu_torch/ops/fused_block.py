"""One ChAdaViT encoder layer, forward, as a chain of CUDA kernels.

Counterpart of ``chadavit_tpu/ops/fused_block.py`` (``_stats`` :68,
``_fwd_kernel`` :91, ``_run_fwd`` :519, ``fused_encoder_block`` :572). The TPU
kernel holds a whole layer of one image in VMEM, which does not fit a Hopper
block's shared memory, so the layer is the chain

    qkv = ln_linear(x)                       LN1, then x @ Wqkv^T + bqkv
    a   = prefix_flash_attention(qkv)         ops/flash_attention.py
    x2  = linear_residual_ln(a, Wout, x)      LN1(x + a @ Wout^T + bout)
    hid = linear_relu(x2)                     relu(x2 @ W1^T + b1)
    y   = linear_residual_ln(hid, W2, x2)     LN2(x2 + hid @ W2^T + b2)

behind :func:`fused_encoder_block`, whose signature follows the JAX function.
Weights are in torch ``nn.Linear`` layout, ``(out, in)``: the transpose of the
JAX kernels. The GEMM kernels are ``csrc/fused_block.cu``. Each step has a
plain version here; a CPU tensor takes it, a CUDA tensor the kernel.

Row tiles wholly past ``valid_len`` are skipped and written as zeros, as the
TPU kernel skips its fully-invalid sequence blocks. Rows past ``valid_len``
are not contractual (``chadavit_tpu/models/chada_vit.py:461-465``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from chadavit_tpu_torch.ops import _build, _launch
from chadavit_tpu_torch.ops.flash_attention import (
    prefix_flash_attention,
    prefix_flash_attention_reference,
)
from chadavit_tpu_torch.ops.layernorm import layernorm

ROW_BLOCK = 32  # the GEMM kernels' row tile and K slice
SEQ_PAD = 128   # the chain pads sequences to this multiple, as the model does
# The widths of ChAdaViT-moyen, the one model the kernels are built for; on
# CUDA tensors the wrappers raise on any other.
D_MODEL = 192
D_FFN = 2048


# ---------------------------------------------------------- plain versions ----
def ln_linear_reference(x, g, b, eps, w, bias, valid_len=None):
    """``LN(x) @ w^T + bias``; x ``(B, S, K)``, w ``(N, K)``."""
    return torch.matmul(layernorm(x, g, b, eps), w.t()) + bias


def linear_relu_reference(x, w, bias, valid_len=None):
    """``relu(x @ w^T + bias)``."""
    return torch.relu(torch.matmul(x, w.t()) + bias)


def linear_residual_ln_reference(a, w, bias, residual, g, b, eps, valid_len=None):
    """``LN(residual + (a @ w^T + bias))``: the residual add in the input
    dtype, then f32 LayerNorm (the double-norm1 site and the LN2 site)."""
    return layernorm(residual + (torch.matmul(a, w.t()) + bias), g, b, eps)


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


def ln_linear(x, g, b, eps: float, w, bias, valid_len):
    """``LN(x) @ w^T + bias`` (kernel ``ln_linear_fwd`` on CUDA)."""
    if _launch.on_cpu(x, g, b, w, bias, valid_len):
        return ln_linear_reference(x, g, b, eps, w, bias, valid_len)
    n = 3 * D_MODEL
    bsz, s, k = _check("ln_linear", x, w, (D_MODEL,), n)
    if g.shape != (k,) or b.shape != (k,) or bias.shape != (n,):
        raise ValueError(f"ln_linear: g {tuple(g.shape)}, b {tuple(b.shape)}, "
                         f"bias {tuple(bias.shape)}")
    out = torch.empty((bsz, s, n), dtype=x.dtype, device=x.device)
    status = _build.library().ln_linear_fwd(
        _launch.float_operand(x, "x"), _launch.float_operand(g, "g"),
        _launch.float_operand(b, "b"), eps, _launch.float_operand(w, "w"),
        _launch.float_operand(bias, "bias"), _launch.float_operand(out, "out"),
        _launch.valid_len_operand(valid_len, bsz, x.device), bsz * s, k, n, s,
        _launch.stream(x.device))
    _build.check(status, "ln_linear_fwd")
    ln_linear.launches += 1
    return out


def linear_relu(x, w, bias, valid_len):
    """``relu(x @ w^T + bias)`` (kernel ``linear_relu_fwd`` on CUDA)."""
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


def linear_residual_ln(a, w, bias, residual, g, b, eps: float, valid_len):
    """``LN(residual + (a @ w^T + bias))`` (kernel ``linear_residual_ln_fwd``
    on CUDA; one block owns whole output rows, so the LayerNorm is local)."""
    if _launch.on_cpu(a, w, bias, residual, g, b, valid_len):
        return linear_residual_ln_reference(a, w, bias, residual, g, b, eps, valid_len)
    n = D_MODEL
    bsz, s, k = _check("linear_residual_ln", a, w, (D_MODEL, D_FFN), n)
    if (bias.shape != (n,) or residual.shape != (bsz, s, n) or g.shape != (n,)
            or b.shape != (n,)):
        raise ValueError(f"linear_residual_ln: residual {tuple(residual.shape)}, "
                         f"bias {tuple(bias.shape)}")
    out = torch.empty((bsz, s, n), dtype=a.dtype, device=a.device)
    status = _build.library().linear_residual_ln_fwd(
        _launch.float_operand(a, "a"), _launch.float_operand(w, "w"),
        _launch.float_operand(bias, "bias"),
        _launch.float_operand(residual, "residual"),
        _launch.float_operand(g, "g"), _launch.float_operand(b, "b"), eps,
        _launch.float_operand(out, "out"),
        _launch.valid_len_operand(valid_len, bsz, a.device), bsz * s, k, n, s,
        _launch.stream(a.device))
    _build.check(status, "linear_residual_ln_fwd")
    linear_residual_ln.launches += 1
    return out


ln_linear.launches = 0
linear_relu.launches = 0
linear_residual_ln.launches = 0


# ------------------------------------------------------------- the layer ----
def _pad_seq(x: torch.Tensor) -> torch.Tensor:
    s = x.shape[1]
    s_pad = -(-s // SEQ_PAD) * SEQ_PAD
    return x if s == s_pad else F.pad(x, (0, 0, 0, s_pad - s))


def fused_encoder_block(x, valid_len, wqkv, bqkv, wout, bout, g1, b1, g2, b2,
                        w1, b1f, w2, b2f, num_heads: int, eps1: float = 1e-5,
                        eps2: float = 1e-5) -> torch.Tensor:
    """One ChAdaViT encoder layer. x ``(B, S, D)``; returns ``(B, S, D)``.

    Weights in ``nn.Linear`` layout: wqkv ``(3D, D)``, wout ``(D, D)``,
    w1 ``(F, D)``, w2 ``(D, F)``. On CUDA every step is a kernel launch, at
    D = :data:`D_MODEL`, F = :data:`D_FFN` and 2 heads only.
    """
    if valid_len is None:
        raise ValueError("fused_encoder_block needs valid_len")
    s = x.shape[1]
    d = x.shape[2]
    xp = _pad_seq(x)
    qkv = ln_linear(xp, g1, b1, eps1, wqkv, bqkv, valid_len)
    a = prefix_flash_attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                               valid_len, num_heads)
    x2 = linear_residual_ln(a, wout, bout, xp, g1, b1, eps1, valid_len)
    hid = linear_relu(x2, w1, b1f, valid_len)
    y = linear_residual_ln(hid, w2, b2f, x2, g2, b2, eps2, valid_len)
    return y[:, :s]


def fused_encoder_block_reference(x, valid_len, wqkv, bqkv, wout, bout, g1, b1,
                                  g2, b2, w1, b1f, w2, b2f, num_heads: int,
                                  eps1: float = 1e-5, eps2: float = 1e-5):
    """The same layer through the plain versions only, on any device."""
    d = x.shape[2]
    qkv = ln_linear_reference(x, g1, b1, eps1, wqkv, bqkv)
    a = prefix_flash_attention_reference(qkv[..., :d], qkv[..., d:2 * d],
                                         qkv[..., 2 * d:], valid_len, num_heads)
    x2 = linear_residual_ln_reference(a, wout, bout, x, g1, b1, eps1)
    hid = linear_relu_reference(x2, w1, b1f)
    return linear_residual_ln_reference(hid, w2, b2f, x2, g2, b2, eps2)
