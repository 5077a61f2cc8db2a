"""Plain LayerNorm with the JAX package's numerics.

Counterpart of the XLA branch of ``chadavit_tpu/ops/layernorm.py::layernorm``
(``impl="auto"`` and ``"xla"``) and of ``chadavit_tpu/ops/fused_block.py::_stats``:
the residual add in the input dtype, f32 stats, fast variance
``mean(x^2) - mean(x)^2`` clamped at 0, f32 scale and bias, the output cast
to the input dtype (float32 or bfloat16 in, the same out). It serves the
final norm (eps 1e-6), the unfused encoder layer and the plain versions of
the layer's kernels. The Pallas LayerNorm kernels (``impl="pallas"``) are
opt-in in the JAX package, on no path of the port yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def layernorm_stats(x: torch.Tensor, eps: float):
    """f32 row stats over the last dim: ``(mean, rstd)``, each keeping a
    trailing dim of 1."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return mu, torch.rsqrt(var + eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``LN(x)``, or ``LN(x + residual)``, over the last dim."""
    if residual is not None:
        x = x + residual
    mu, rstd = layernorm_stats(x, eps)
    y = (x.float() - mu) * rstd
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)
