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
``delta = rowsum(do * o)`` formulation. The backward keeps the TPU kernel's
contract (``flash_attention.py:166-172``): the forward computes every query
row of a :data:`SEQ_BLOCK` (64-row) tile that holds a valid query for real,
also the rows past ``valid_len``, and the backward is exact for any
cotangent on those rows. Query tiles wholly past the prefix (zero-filled,
lse 1e30) give nothing and get dq = 0; keys past ``valid_len`` stay masked,
so their dk and dv are 0. The JAX kernel's tile is its 128/256 block, the
port's is 64.

Both kernels exist for float32 and bfloat16 q/k/v (one dtype per call; the
lse is float32). The bfloat16 instances and plain versions round where the
JAX kernels cast to the input dtype: the scaled q (the scale itself rounded
to bfloat16, as JAX multiplies by a weak-typed scalar), the probabilities
before ``P V`` and ``dv = p^T do``, ``ds`` before ``dk`` and ``dq``, and every
output; scores, softmax statistics, ``delta`` and every sum stay float32.

The float32 instances run on CUDA cores (the two files above); the bfloat16
ones are tensor-core kernels of their own, ``csrc/prefix_attention_bf16.cu``,
whose 16-byte copies need q/k/v rows of a stride that is a multiple of 8
elements and every operand 16-byte aligned: the bfloat16 wrappers raise
``ValueError`` on anything else (the packed qkv's column slices qualify:
ld 576 and offsets of 384 bytes at ChAdaViT-moyen, ld 2304 and offsets of
1536 bytes at ChAdaViT-B/16). The float32 backward copies 16 bytes at a
time too (rows of a stride that is a multiple of 4, starts 16-byte aligned:
:func:`_operand_rows` copies anything else). Both backwards take a scratch
for the scaled q (:func:`_bwd_scratch`).

Every kernel is built for the head widths :data:`HEAD_DIMS`: 96
(ChAdaViT-moyen, D 192 in 2 heads), 64 (ChAdaViT-B/16, D 768 in 12 heads)
and 32 (the smoke configs, D 64 in 2 heads), one C entry point each that
takes the head width as an argument; on CUDA tensors the wrappers raise
``ValueError`` at any other width (JAX pads a head width that is not a
multiple of 8 to 128 lanes; no such instance is built). One launch covers
every head: the JAX kernels' walk over groups of at most
``MAX_GROUP_LANES`` = 384 lanes (``flash_attention.py:29``, ``:275``) bounds
their VMEM and is not part of the function. Launches are counted per
instance (:func:`instance`): the head-96 ones under the entry point's name,
the head-64 and head-32 ones with ``_hd64`` and ``_hd32`` after it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chadavit_tpu_torch.ops import _build, _launch

_LOG2E = 1.4426950408889634
SEQ_BLOCK = 64  # the kernels' query and key tile
# the head widths the kernels are built for: the smoke configs' (D 64, 2
# heads), ChAdaViT-B/16's (D 768, 12 heads) and ChAdaViT-moyen's (D 192, 2 heads)
HEAD_DIMS = (32, 64, 96)


def instance(entry_point: str, head_dim: int) -> str:
    """The name a launch of C entry point ``entry_point`` at ``head_dim`` is
    counted under (``_launch.LAUNCHES``): the entry point's own at head 96,
    with ``_hd64`` or ``_hd32`` after it at head 64 or 32."""
    return entry_point if head_dim == 96 else f"{entry_point}_hd{head_dim}"


def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def _qscale(head_dim: int, dtype: torch.dtype) -> float:
    """``log2(e) / sqrt(head_dim)``, the factor folded into q; for a bfloat16 q
    rounded to bfloat16, as the JAX kernels multiply a bfloat16 q by a
    weak-typed Python scalar (``flash_attention.py:123-125``)."""
    qscale = _LOG2E / math.sqrt(head_dim)
    return qscale if dtype == torch.float32 else torch.tensor(qscale, dtype=dtype).item()


def _scaled_q(q, num_heads):
    """``q scale log2(e)`` per head ``(B, H, S, hd)`` in f32, rounded to q's
    dtype when that is narrower."""
    qs = _split(q, num_heads).float() * _qscale(q.shape[-1] // num_heads, q.dtype)
    return qs if q.dtype == torch.float32 else qs.to(q.dtype).float()


def computed_rows(s: int, valid_len, device) -> torch.Tensor:
    """``(B, S)`` bool: row ``r`` lies in a :data:`SEQ_BLOCK` query tile that
    holds a valid query, so the forward computes it for real."""
    start = torch.arange(s, device=device) // SEQ_BLOCK * SEQ_BLOCK
    return start[None, :] < valid_len.to(device)[:, None]


def _masked_scores(q, k, valid_len, num_heads):
    """Base-2 scores ``q k^T scale log2(e)`` (B, H, S, S) in f32, keys
    ``>= valid_len`` set to -inf."""
    s = q.shape[1]
    scores = torch.matmul(_scaled_q(q, num_heads),
                          _split(k, num_heads).float().transpose(-1, -2))
    key_ok = torch.arange(s, device=q.device)[None, :] < valid_len.to(q.device)[:, None]
    return scores.masked_fill(~key_ok[:, None, None, :], float("-inf"))


def prefix_flash_attention_reference(q, k, v, valid_len, num_heads: int,
                                     return_lse: bool = False):
    """Plain version: f32 scores, keys ``>= valid_len`` masked, an explicit
    softmax in base 2. q/k/v ``(B, S, D)``; returns ``(B, S, D)`` in q's dtype,
    and with ``return_lse`` also the base-2 lse ``(B, H, S)``. For bfloat16 the
    scaled q and the probabilities are rounded to bfloat16 before their
    products, and the sum ``l`` is of the unrounded probabilities
    (``flash_attention.py:123-136``)."""
    scores = _masked_scores(q, k, valid_len, num_heads)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp2(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    vh = _split(v, num_heads).float()
    if q.dtype == torch.float32:
        out = _merge(torch.matmul(p / l, vh)).to(q.dtype)
    else:
        out = _merge(torch.matmul(p.to(q.dtype).float(), vh) / l).to(q.dtype)
    if return_lse:
        return out, (m + torch.log2(l))[..., 0]
    return out


def prefix_flash_attention_backward_reference(q, k, v, o, lse, do, valid_len,
                                              num_heads: int):
    """Plain version of the backward (the TPU kernel's formulation,
    ``flash_attention.py:157-230,353-407``): ``delta = rowsum(do * o)`` per
    head, ``p = exp2(q k^T scale log2(e) - lse)``, ``ds = p (do v^T - delta)``,
    ``dq = ds k scale``, ``dk = ds^T q scale``, ``dv = p^T do``. Every query row
    the forward computes (:func:`computed_rows`) takes part with its
    cotangent; the rows of query tiles wholly past the prefix give nothing
    and get dq = 0. For bfloat16, p is rounded before ``dv``, ds before ``dk``
    and ``dq``, and ``dk`` is taken against the rounded scaled q, as the TPU
    kernel does. Returns ``dqkv = [dq, dk, dv]``, ``(B, S, 3 D)``."""
    b, s, d = q.shape
    scale = 1.0 / math.sqrt(d // num_heads)
    row_ok = computed_rows(s, valid_len, q.device)[:, None, :, None]  # (B, 1, S, 1)
    doh = torch.where(row_ok, _split(do, num_heads).float(), 0.0)
    oh = _split(o, num_heads).float()
    delta = (doh * oh).sum(-1, keepdim=True)
    p = torch.where(row_ok, torch.exp2(_masked_scores(q, k, valid_len, num_heads)
                                       - lse[..., None]), 0.0)
    vh, kh = (_split(t, num_heads).float() for t in (v, k))
    if q.dtype == torch.float32:
        qh = _split(q, num_heads).float()
        dv = torch.matmul(p.transpose(-1, -2), doh)
        ds = p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta)
        dq = torch.matmul(ds, kh) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    else:
        dt = q.dtype
        dv = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
        ds = (p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta)).to(dt).float()
        dq = torch.matmul(ds, kh) * scale
        dk = torch.matmul(ds.transpose(-1, -2), _scaled_q(q, num_heads)) * (1.0 / _LOG2E)
    return torch.cat([_merge(t) for t in (dq, dk, dv)], dim=-1).to(q.dtype)


# ---------------------------------------------------------------- kernels ----
# bytes every operand is aligned to: the float32 kernels load four elements,
# the bf16 tensor-core kernels copy 16 bytes, at a time
_ALIGN = 16


def _row_stride(*ts):
    """Row stride (in elements) shared by the tensors when each is a column
    slice of rows with unit inner stride (as the q/k/v thirds of one packed
    qkv tensor are), else None."""
    b, s, d = ts[0].shape
    ld = ts[0].stride(1)
    for t in ts:
        if t.stride(2) != 1 or t.stride(1) != ld or t.stride(0) != s * ld:
            return None
    return ld


def _operand_rows(q, k, v):
    """``(q, k, v, ld)`` as the kernels take them: the tensors themselves
    when they share a row layout, else contiguous copies. float32 also copies
    rows that its loads of four elements cannot read (a stride that is not a
    multiple of 4, a start not 16-byte aligned). bfloat16 raises
    ``ValueError`` on a stride that is not a multiple of 8 or a start that is
    not 16-byte aligned: the tensor-core kernels copy 16 bytes at a time."""
    d = q.shape[2]
    ld = _row_stride(q, k, v)
    if q.dtype == torch.float32:
        if ld is None or ld % 4 or any(t.data_ptr() % _ALIGN for t in (q, k, v)):
            return q.contiguous(), k.contiguous(), v.contiguous(), d
        return q, k, v, ld
    if ld is None:
        q, k, v, ld = q.contiguous(), k.contiguous(), v.contiguous(), d
    if ld % 8:
        raise ValueError(f"q/k/v: the bf16 kernels copy 16 bytes at a time, so the row "
                         f"stride must be a multiple of 8 elements, got {ld}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"{name}: must be aligned to {_ALIGN} bytes")
    return q, k, v, ld


def _bwd_scratch(b: int, num_heads: int, s: int, d: int, dtype: torch.dtype, device):
    """``(delta, qs)``: the backward's scratch, one buffer that the C entry
    point finds through delta: delta ``(B, heads, S)`` float32, then the scaled
    q ``(B, S, D)`` in q's dtype, written by the kernel's prep pass and read by
    its dk/dv and dq kernels; for float32 then also ``B`` int32, the order in
    which those kernels take the images (longest first), written by the prep
    pass."""
    n_delta = b * num_heads * s
    if dtype == torch.float32:
        buf = torch.empty(n_delta + b * s * d + b, dtype=torch.float32, device=device)
        return (buf[:n_delta].view(b, num_heads, s),
                buf[n_delta:n_delta + b * s * d].view(b, s, d))
    buf = torch.empty(n_delta + b * s * d // 2, dtype=torch.float32, device=device)
    return (buf[:n_delta].view(b, num_heads, s),
            buf[n_delta:].view(torch.bfloat16).view(b, s, d))


def _check_heads(q, k, v, num_heads):
    b, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or d % num_heads:
        raise ValueError(f"q/k/v shapes {q.shape} {k.shape} {v.shape}, heads {num_heads}")
    hd = d // num_heads
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernels are built for {HEAD_DIMS}")
    if q.dtype not in _launch.KERNEL_DTYPES:
        raise TypeError(f"q: the kernels take float32 or bfloat16, got {q.dtype}")
    for t, name in ((k, "k"), (v, "v")):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {t.dtype}, q {q.dtype}: one dtype per call")
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
    q, k, v, ld = _operand_rows(q, k, v)
    dt = q.dtype
    vl = _launch.valid_len_operand(valid_len, b, q.device)
    out = torch.empty((b, s_pad, d), dtype=dt, device=q.device)
    lse = (torch.empty((b, num_heads, s_pad), dtype=torch.float32, device=q.device)
           if with_lse else None)
    name = _launch.entry_point("prefix_attention_fwd", dt)
    status = getattr(_build.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, vl,
        _launch.vector_operand(out, "out", dt, align=_ALIGN), d,
        None if lse is None else lse.data_ptr(), b, num_heads, hd, s_pad,
        _qscale(hd, dt), _launch.stream(q.device))
    _build.check(status, name)
    _launch.counted(instance(name, hd))
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
    q, k, v, ld = _operand_rows(q, k, v)
    dt = q.dtype
    o, do = o.contiguous(), do.contiguous()
    vl = _launch.valid_len_operand(valid_len, b, q.device)
    dqkv = torch.empty((b, s, 3 * d), dtype=dt, device=q.device)
    delta, _ = _bwd_scratch(b, num_heads, s, d, dt, q.device)
    third = d * dqkv.element_size()  # bytes from dq to dk to dv in a packed row
    name = _launch.entry_point("prefix_attention_bwd", dt)
    status = getattr(_build.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld,
        _launch.vector_operand(o, "o", dt, align=_ALIGN),
        _launch.vector_operand(do, "do", dt, align=_ALIGN), d,
        _launch.vector_operand(lse, "lse"),
        delta.data_ptr(), vl, dqkv.data_ptr(), dqkv.data_ptr() + third,
        dqkv.data_ptr() + 2 * third, 3 * d, b, num_heads, hd, s,
        _qscale(hd, dt), 1.0 / math.sqrt(hd), _launch.stream(q.device))
    _build.check(status, name)
    _launch.counted(instance(name, hd))
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

    q/k/v: ``(B, S, D)`` float32 or bfloat16; valid_len ``(B,)`` int32. On
    CUDA tensors it launches ``prefix_attention_fwd`` (``_bf16`` for bfloat16),
    whose head widths are :data:`HEAD_DIMS`,
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


