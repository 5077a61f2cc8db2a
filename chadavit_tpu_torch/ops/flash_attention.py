"""Prefix-masked multi-head attention: the CUDA kernels and their plain versions.

Counterpart of ``chadavit_tpu/ops/flash_attention.py`` (``pick_block`` :79,
``_fwd_kernel`` :103, ``_bwd_kernel`` :157, ``_fwd_impl`` :281,
``prefix_flash_attention`` :324 with its custom VJP :339-416). The valid
tokens of image ``b`` are exactly the prefix ``valid_len[b] = 1 + 196 * c``;
keys past it are masked, queries are not. The forward kernel is
``csrc/prefix_attention.cu``; it tiles queries and keys by :data:`SEQ_BLOCK`
and skips query tiles wholly past the prefix, which it writes as zeros. Rows
past ``valid_len`` are not contractual.

With grad enabled, :func:`prefix_flash_attention` runs
:class:`PrefixFlashAttention`: its forward also writes the base-2 lse of each
query row, and its backward is ``csrc/prefix_attention_bwd.cu``
(:func:`prefix_attention_bwd`), with the TPU kernel's explicit-lse and
``delta = rowsum(do * o)`` formulation. The backward keeps the model's
contract: the cotangent is zero on query rows ``>= valid_len`` (the model
reads only CLS), so those rows contribute nothing and their dq, dk and dv are
zero.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chadavit_tpu_torch.ops import _build, _launch

_LOG2E = 1.4426950408889634
SEQ_BLOCK = 64  # the kernels' query and key tile
HEAD_DIM = 96   # ChAdaViT-moyen (D 192, 2 heads), the one width the kernels are built for


def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def _masked_scores(q, k, valid_len, num_heads):
    """Base-2 scores ``q k^T scale log2(e)`` (B, H, S, S) in f32, keys
    ``>= valid_len`` set to -inf."""
    b, s, d = q.shape
    qscale = _LOG2E / math.sqrt(d // num_heads)
    scores = torch.matmul(_split(q, num_heads).float() * qscale,
                          _split(k, num_heads).float().transpose(-1, -2))
    key_ok = torch.arange(s, device=q.device)[None, :] < valid_len.to(q.device)[:, None]
    return scores.masked_fill(~key_ok[:, None, None, :], float("-inf"))


def prefix_flash_attention_reference(q, k, v, valid_len, num_heads: int,
                                     return_lse: bool = False):
    """Plain version: f32 scores, keys ``>= valid_len`` masked, an explicit
    softmax in base 2. q/k/v ``(B, S, D)``; returns ``(B, S, D)`` in q's dtype,
    and with ``return_lse`` also the base-2 lse ``(B, H, S)``."""
    scores = _masked_scores(q, k, valid_len, num_heads)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp2(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = _merge(torch.matmul(p / l, _split(v, num_heads).float())).to(q.dtype)
    if return_lse:
        return out, (m + torch.log2(l))[..., 0]
    return out


def prefix_flash_attention_backward_reference(q, k, v, o, lse, do, valid_len,
                                              num_heads: int):
    """Plain version of the backward (the TPU kernel's formulation,
    ``flash_attention.py:157-230,353-407``): ``delta = rowsum(do * o)`` per
    head, ``p = exp2(q k^T scale log2(e) - lse)``, ``ds = p (do v^T - delta)``,
    ``dq = ds k scale``, ``dk = ds^T q scale``, ``dv = p^T do``. Query rows
    ``>= valid_len`` are taken as zero cotangent (the model's contract).
    Returns ``dqkv = [dq, dk, dv]``, ``(B, S, 3 D)``."""
    b, s, d = q.shape
    scale = 1.0 / math.sqrt(d // num_heads)
    row_ok = (torch.arange(s, device=q.device)[None, :]
              < valid_len.to(q.device)[:, None])[:, None, :, None]  # (B, 1, S, 1)
    doh = torch.where(row_ok, _split(do, num_heads).float(), 0.0)
    oh = _split(o, num_heads).float()
    delta = (doh * oh).sum(-1, keepdim=True)
    p = torch.where(row_ok, torch.exp2(_masked_scores(q, k, valid_len, num_heads)
                                       - lse[..., None]), 0.0)
    vh, kh, qh = (_split(t, num_heads).float() for t in (v, k, q))
    dv = torch.matmul(p.transpose(-1, -2), doh)
    ds = p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    return torch.cat([_merge(t) for t in (dq, dk, dv)], dim=-1).to(q.dtype)


# ---------------------------------------------------------------- kernels ----
def _packed_rows(*ts):
    """Row stride shared by the tensors when each is a column slice of rows
    with unit inner stride (as the q/k/v thirds of one packed qkv tensor
    are), else None."""
    b, s, d = ts[0].shape
    ld = ts[0].stride(1)
    if ld % 4:
        return None
    for t in ts:
        if (t.stride(2) != 1 or t.stride(1) != ld or t.stride(0) != s * ld
                or t.data_ptr() % 16):
            return None
    return ld


def _check_heads(q, k, v, num_heads):
    b, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or d % num_heads:
        raise ValueError(f"q/k/v shapes {q.shape} {k.shape} {v.shape}, heads {num_heads}")
    hd = d // num_heads
    if hd != HEAD_DIM:
        raise ValueError(f"head dim {hd}: the kernel is built for {HEAD_DIM}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    return b, s, d, hd


def attention_forward(q, k, v, valid_len, num_heads: int, with_lse: bool):
    """``(out, lse or None)``: the plain version on CPU tensors, else
    ``prefix_attention_fwd`` (which writes the lse only when asked)."""
    if _launch.on_cpu(q, k, v, valid_len):
        if with_lse:
            return prefix_flash_attention_reference(q, k, v, valid_len, num_heads, True)
        return prefix_flash_attention_reference(q, k, v, valid_len, num_heads), None
    b, s, d, hd = _check_heads(q, k, v, num_heads)
    s_pad = -(-s // SEQ_BLOCK) * SEQ_BLOCK
    if s_pad != s:
        q, k, v = (F.pad(t, (0, 0, 0, s_pad - s)) for t in (q, k, v))
    ld = _packed_rows(q, k, v)
    if ld is None:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ld = d
    vl = _launch.valid_len_operand(valid_len, b, q.device)
    out = torch.empty((b, s_pad, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, num_heads, s_pad), dtype=torch.float32, device=q.device)
           if with_lse else None)
    status = _build.library().prefix_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, vl,
        _launch.float_operand(out, "out"), d,
        None if lse is None else lse.data_ptr(), b, num_heads, hd, s_pad,
        _LOG2E / math.sqrt(hd), _launch.stream(q.device))
    _build.check(status, "prefix_attention_fwd")
    prefix_flash_attention.launches += 1
    if s_pad != s:
        out = out[:, :s]
        lse = None if lse is None else lse[..., :s]
    return out, lse


def prefix_attention_bwd(q, k, v, o, lse, do, valid_len, num_heads: int):
    """``dqkv = [dq, dk, dv]`` ``(B, S, 3 D)`` of the masked attention: kernel
    ``prefix_attention_bwd`` on CUDA tensors (S a multiple of
    :data:`SEQ_BLOCK`), :func:`prefix_flash_attention_backward_reference` on
    CPU tensors."""
    if _launch.on_cpu(q, k, v, o, lse, do, valid_len):
        return prefix_flash_attention_backward_reference(q, k, v, o, lse, do, valid_len,
                                                         num_heads)
    b, s, d, hd = _check_heads(q, k, v, num_heads)
    if s % SEQ_BLOCK or o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (b, num_heads, s):
        raise ValueError(f"prefix_attention_bwd: S {s} must be a multiple of {SEQ_BLOCK}; "
                         f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)}")
    ld = _packed_rows(q, k, v)
    if ld is None:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ld = d
    o, do = o.contiguous(), do.contiguous()
    vl = _launch.valid_len_operand(valid_len, b, q.device)
    dqkv = torch.empty((b, s, 3 * d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, num_heads, s), dtype=torch.float32, device=q.device)
    status = _build.library().prefix_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, _launch.float_operand(o, "o"),
        _launch.float_operand(do, "do"), d, _launch.float_operand(lse, "lse"),
        delta.data_ptr(), vl, dqkv.data_ptr(), dqkv.data_ptr() + 4 * d,
        dqkv.data_ptr() + 8 * d, 3 * d, b, num_heads, hd, s,
        _LOG2E / math.sqrt(hd), 1.0 / math.sqrt(hd), _launch.stream(q.device))
    _build.check(status, "prefix_attention_bwd")
    prefix_attention_bwd.launches += 1
    return dqkv


class PrefixFlashAttention(torch.autograd.Function):
    """The attention with a gradient: forward ``prefix_attention_fwd`` with
    the lse, backward ``prefix_attention_bwd`` (plain versions on CPU
    tensors). Takes q/k/v whose S is a multiple of :data:`SEQ_BLOCK`."""

    @staticmethod
    def forward(ctx, q, k, v, valid_len, num_heads: int):
        out, lse = attention_forward(q, k, v, valid_len, num_heads, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, valid_len)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, valid_len = ctx.saved_tensors
        dqkv = prefix_attention_bwd(q, k, v, out, lse, dout.contiguous(), valid_len,
                                    ctx.num_heads)
        d = q.shape[2]
        return dqkv[..., :d], dqkv[..., d:2 * d], dqkv[..., 2 * d:], None, None


def prefix_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Masked MHA where key ``j`` of image ``b`` is valid iff ``j < valid_len[b]``.

    q/k/v: ``(B, S, D)`` float32; valid_len ``(B,)`` int32. On CUDA tensors
    it launches ``prefix_attention_fwd``, whose head width is :data:`HEAD_DIM`,
    and raises on any other; on CPU tensors it runs
    :func:`prefix_flash_attention_reference`. When autograd records the call
    it goes through :class:`PrefixFlashAttention`, whose backward is
    ``prefix_attention_bwd``.
    """
    if valid_len is None:
        raise ValueError("prefix_flash_attention needs valid_len")
    if not _launch.needs_grad(q, k, v):
        return attention_forward(q, k, v, valid_len, num_heads, with_lse=False)[0]
    s = q.shape[1]
    s_pad = -(-s // SEQ_BLOCK) * SEQ_BLOCK
    if s_pad != s:
        q, k, v = (F.pad(t, (0, 0, 0, s_pad - s)) for t in (q, k, v))
    out = PrefixFlashAttention.apply(q, k, v, valid_len, num_heads)
    return out if s_pad == s else out[:, :s]


prefix_flash_attention.launches = 0
prefix_attention_bwd.launches = 0
