"""Masked multi-head attention for padded variable-channel sequences.

Counterpart of ``chadavit_tpu/ops/attention.py`` (``split_heads``,
``merge_heads``, ``xla_masked_attention`` :44-84, ``masked_multihead_attention``
:138). ``xla_masked_attention`` keeps its JAX name: it is the plain path, an
explicit masked softmax, and the reference the kernels are held against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from chadavit_tpu_torch.ops import flash_attention


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)  # (B, H, S, hd)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def xla_masked_attention(q, k, v, key_padding_mask: Optional[torch.Tensor],
                         num_heads: int, return_weights: bool = False
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain masked MHA. q/k/v ``(B, S, D)``; key_padding_mask ``(B, S)`` bool,
    True = masked key. Returns ``(out (B, S, D), weights (B, H, S, S) or None)``."""
    hd = q.shape[-1] // num_heads
    qh = split_heads(q, num_heads) * (1.0 / hd ** 0.5)
    scores = torch.matmul(qh.float(), split_heads(k, num_heads).float().transpose(-1, -2))
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    out = torch.matmul(weights.to(v.dtype), split_heads(v, num_heads)).float()
    out = merge_heads(out).to(q.dtype)
    return out, (weights if return_weights else None)


def masked_multihead_attention(q, k, v, key_padding_mask: Optional[torch.Tensor],
                               num_heads: int, impl: str = "auto",
                               return_weights: bool = False,
                               valid_len: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatching masked MHA. ``impl="auto"`` with no weights requested takes
    :func:`flash_attention.prefix_flash_attention`, which on CUDA launches the
    kernel or raises (no ``valid_len``, a head width it is not built for). The
    plain path serves ``impl="xla"``, the weights, and CPU calls without
    ``valid_len``."""
    if impl not in ("auto", "xla"):
        raise ValueError(f"attention impl {impl!r}: want 'auto' or 'xla'")
    if impl == "auto" and not return_weights and (valid_len is not None or q.is_cuda):
        return flash_attention.prefix_flash_attention(q, k, v, valid_len, num_heads), None
    return xla_masked_attention(q, k, v, key_padding_mask, num_heads, return_weights)
