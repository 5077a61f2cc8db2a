"""Plain float32 LayerNorm with the JAX package's numerics.

Counterpart of the XLA branch of ``chadavit_tpu/ops/layernorm.py::layernorm``:
the residual add in the input dtype, f32 stats, fast variance
``mean(x^2) - mean(x)^2`` clamped at 0. It serves the final norm (eps 1e-6)
and the unfused encoder layer. The Pallas LayerNorm kernel is opt-in in the
JAX package and not on the port's path.
"""

from __future__ import annotations

from typing import Optional

import torch


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``LN(x)``, or ``LN(x + residual)``, over the last dim."""
    if residual is not None:
        x = x + residual
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)
