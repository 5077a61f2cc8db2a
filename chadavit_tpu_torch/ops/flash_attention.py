"""Prefix-masked multi-head attention: the CUDA kernel and its plain version.

Counterpart of ``chadavit_tpu/ops/flash_attention.py`` (``pick_block`` :79,
``_fwd_kernel`` :103, ``_fwd_impl`` :281, ``prefix_flash_attention`` :324).
The valid tokens of image ``b`` are exactly the prefix ``valid_len[b] =
1 + 196 * c``; keys past it are masked, queries are not. The kernel is
``csrc/prefix_attention.cu``; it tiles queries and keys by :data:`SEQ_BLOCK`
and skips query tiles wholly past the prefix, which it writes as zeros. Rows
past ``valid_len`` are not contractual.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chadavit_tpu_torch.ops import _build, _launch

_LOG2E = 1.4426950408889634
SEQ_BLOCK = 64  # the kernel's query and key tile
HEAD_DIM = 96   # ChAdaViT-moyen (D 192, 2 heads), the one width the kernel is built for

def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def prefix_flash_attention_reference(q, k, v, valid_len, num_heads: int):
    """Plain version: f32 scores, keys ``>= valid_len`` masked, an explicit
    softmax. q/k/v ``(B, S, D)``; returns ``(B, S, D)`` in q's dtype."""
    b, s, d = q.shape
    scale = 1.0 / math.sqrt(d // num_heads)
    qh = _split(q, num_heads).float() * scale
    scores = torch.matmul(qh, _split(k, num_heads).float().transpose(-1, -2))
    key_ok = torch.arange(s, device=q.device)[None, :] < valid_len.to(q.device)[:, None]
    scores = scores.masked_fill(~key_ok[:, None, None, :], float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, _split(v, num_heads).float())
    return out.transpose(1, 2).reshape(b, s, d).to(q.dtype)


def _packed_rows(q, k, v):
    """Row stride shared by q, k and v when each is a column slice of rows
    with unit inner stride (as the q/k/v thirds of one packed qkv tensor
    are), else None."""
    b, s, d = q.shape
    ld = q.stride(1)
    if ld % 4:
        return None
    for t in (q, k, v):
        if (t.stride(2) != 1 or t.stride(1) != ld or t.stride(0) != s * ld
                or t.data_ptr() % 16):
            return None
    return ld


def prefix_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Masked MHA where key ``j`` of image ``b`` is valid iff ``j < valid_len[b]``.

    q/k/v: ``(B, S, D)`` float32; valid_len ``(B,)`` int32. On CUDA tensors
    it launches ``prefix_attention_fwd``, whose head width is :data:`HEAD_DIM`,
    and raises on any other; on CPU tensors it runs
    :func:`prefix_flash_attention_reference`.
    """
    if valid_len is None:
        raise ValueError("prefix_flash_attention needs valid_len")
    if _launch.on_cpu(q, k, v, valid_len):
        return prefix_flash_attention_reference(q, k, v, valid_len, num_heads)
    b, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or d % num_heads:
        raise ValueError(f"q/k/v shapes {q.shape} {k.shape} {v.shape}, heads {num_heads}")
    hd = d // num_heads
    if hd != HEAD_DIM:
        raise ValueError(f"head dim {hd}: the kernel is built for {HEAD_DIM}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    s_pad = -(-s // SEQ_BLOCK) * SEQ_BLOCK
    if s_pad != s:
        q, k, v = (F.pad(t, (0, 0, 0, s_pad - s)) for t in (q, k, v))
    ld = _packed_rows(q, k, v)
    if ld is None:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ld = d
    vl = _launch.valid_len_operand(valid_len, b, q.device)
    out = torch.empty((b, s_pad, d), dtype=q.dtype, device=q.device)
    status = _build.library().prefix_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, vl,
        _launch.float_operand(out, "out"), d, b, num_heads, hd, s_pad,
        _LOG2E / math.sqrt(hd), _launch.stream(q.device))
    _build.check(status, "prefix_attention_fwd")
    prefix_flash_attention.launches += 1
    return out if s_pad == s else out[:, :s]


prefix_flash_attention.launches = 0
