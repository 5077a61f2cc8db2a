"""Plain models of the float32 summation orders of ``layernorm_bwd`` (K2a,
``chadavit_tpu_torch/csrc/fused_block_bwd.cu``), so that its kernels can be
held to them on the card (``tests/test_torch_kernels_gpu.py``) and the models
to the plain version on the CPU (``tests/test_torch_ln_bwd_order.py``). They
run on the tensors' device, in float32 where the kernels round and in float64
where they fuse (``fmaf``, ``tests/torch_f32_order.py``).

- :func:`param_sums_order`: dgamma and dbeta as every ``layernorm_bwd`` first
  pass sums them since the split plan (``layernorm_bwd_kernel`` at every
  width, and the bfloat16 row pass at D 768, which keeps its bits): split
  ``i`` walks the 32-row tiles ``[i T / splits, (i + 1) T / splits)`` in
  order and skips those that hold no valid row; in a tile, warp ``w`` of 8
  takes the rows ``w, w + 8, w + 16, w + 24`` in order, and its partial of a
  column adds ``fmaf(dy, xhat, pg)`` and ``pb + dy`` row by row; the split's
  partial adds the 8 warps' in warp order; then ``reduce_ln_splits_kernel``
  adds, for each output, the splits ``w, w + 32, ...`` in order for each of
  its 32 warps ``w``, then the 32 warps' sums in order.
- :func:`wide_row_pass_order`: the bfloat16 row pass at D 768
  (``layernorm_bwd_wide_bf16_kernel``) lane by lane: lane ``l`` of a warp
  holds the 16-byte chunks ``l, l + 32, l + 64`` of a row (columns ``8 c ..
  8 c + 7``), keeps its partials in shared-memory slots ``[kind][chunk //
  32][half][lane]`` of float4 (``lnw_slot``), read back by the column's slot
  (the kernel's ``at``); dx's two row sums add the lane's columns chunk by
  chunk, then the warp's lanes by the xor butterfly.

``xhat = (x - mean) * rstd`` is rounded after the difference and after the
product, as the kernels compute it.
"""

from __future__ import annotations

import torch

from tests.torch_f32_order import ROW_BLOCK, computed, fmaf, warp_sums

WARPS = 8       # layernorm_bwd's warps a block (NT 256)
RED_WARPS = 32  # reduce_ln_splits_kernel's warps
CHUNK = 8       # bf16 columns of a 16-byte chunk


def _rows(dy, xin, mean, rstd):
    bsz, s_pad, d = dy.shape
    m = bsz * s_pad
    dyf = dy.reshape(m, d).float()
    xh = (xin.reshape(m, d).float() - mean.reshape(m, 1)) * rstd.reshape(m, 1)
    return dyf, xh


def split_warp_partials(dy, xin, mean, rstd, valid_len, splits):
    """``(splits, WARPS, 2 D)``: each split's warps' dgamma, then dbeta
    partials, summed row by row in the kernels' order."""
    bsz, s_pad, d = dy.shape
    tiles = bsz * s_pad // ROW_BLOCK
    dyf, xh = _rows(dy, xin, mean, rstd)
    ok = computed(valid_len, bsz, s_pad, dy.device).reshape(tiles, ROW_BLOCK)[:, 0].cpu()
    lists = []
    for i in range(splits):
        t0, t1 = i * tiles // splits, (i + 1) * tiles // splits
        lists.append([t for t in range(t0, t1) if bool(ok[t])])
    most = max((len(t) for t in lists), default=0)
    pg = torch.zeros(splits, WARPS, d, device=dy.device)
    pb = torch.zeros_like(pg)
    zero = torch.zeros(splits, WARPS, d, device=dy.device)
    warp = torch.arange(WARPS, device=dy.device)
    for j in range(most):
        tile = torch.tensor([t[j] if j < len(t) else -1 for t in lists], device=dy.device)
        live = (tile >= 0)[:, None, None]
        for r in range(ROW_BLOCK // WARPS):
            rows = (tile.clamp(min=0)[:, None] * ROW_BLOCK + warp[None, :] + WARPS * r)
            dsel = torch.where(live, dyf[rows], zero)
            xsel = torch.where(live, xh[rows], zero)
            pg = fmaf(dsel, xsel, pg)
            pb = pb + dsel
    return torch.cat([pg, pb], -1)


def reduce_splits(partial, dgb=None):
    """``reduce_ln_splits_kernel`` on ``(splits, 2 D)`` partials: for each
    output, warp w adds the splits w, w + 32, ... in order, then the warps'
    sums are added in order; summed into ``dgb`` when it is given."""
    splits, n = partial.shape
    t = torch.zeros(n, device=partial.device)
    for w in range(RED_WARPS):
        s = torch.zeros(n, device=partial.device)
        for sp in range(w, splits, RED_WARPS):
            s = s + partial[sp]
        t = t + s
    return t if dgb is None else dgb + t


def param_sums_order(dy, xin, mean, rstd, valid_len, splits, dgb=None):
    """``[dgamma, dbeta]`` ``(2 D,)`` as layernorm_bwd's two passes sum them
    (module docstring); ``dgb`` the sums they add into, or None."""
    parts = split_warp_partials(dy, xin, mean, rstd, valid_len, splits)
    partial = torch.zeros(parts.shape[0], parts.shape[2], device=dy.device)
    for w in range(WARPS):
        partial = partial + parts[:, w]
    return reduce_splits(partial, dgb)


def lnw_slot(k, half, lane):
    """The kernel's float4 slot of chunk ``lane + 32 k``'s half ``half``."""
    return (k * 2 + half) * 32 + lane


def wide_row_pass_order(dy, xin, mean, rstd, g, valid_len, splits, residual=None, dgb=None):
    """``(dx, [dgamma, dbeta])`` of the bfloat16 row pass at D 768, lane by
    lane (module docstring): the warps' partials staged in the kernel's
    shared-memory layout and read back by its column index; dx from the
    lanes' chunked row sums, rounded once to bf16 (zeros on the rows of tiles
    that hold no valid row)."""
    bsz, s_pad, d = dy.shape
    m = bsz * s_pad
    lanes = d // CHUNK // 32  # chunks a lane (3 at D 768)
    dev = dy.device
    # the partials, scattered to the kernel's slots and gathered back by `at`
    parts = split_warp_partials(dy, xin, mean, rstd, valid_len, splits)
    col = torch.arange(d, device=dev)
    chunk = col // CHUNK
    slot = lnw_slot(chunk // 32, col % CHUNK // 4, chunk % 32)
    staged = torch.full_like(parts, float("nan"))
    for kind in range(2):
        staged[..., kind * d + 4 * slot + col % 4] = parts[..., kind * d + col]
    c = torch.arange(2 * d, device=dev)
    kind, cc = c // d, c % d
    at = kind * d + 4 * lnw_slot(cc // CHUNK // 32, cc % CHUNK // 4, cc // CHUNK % 32) + cc % 4
    partial = torch.zeros(parts.shape[0], 2 * d, device=dev)
    for w in range(WARPS):
        partial = partial + staged[:, w, at]
    sums = reduce_splits(partial, dgb)
    # dx: lane l's columns in the kernel's order, then the butterfly
    dyf, xh = _rows(dy, xin, mean, rstd)
    dyg = dyf * g.float()
    order = torch.stack([torch.arange(lanes * CHUNK, device=dev) // CHUNK * 32 * CHUNK
                         + lane * CHUNK + torch.arange(lanes * CHUNK, device=dev) % CHUNK
                         for lane in range(32)])  # (32, columns of a lane)
    s1 = torch.zeros(m, 32, device=dev)
    s2 = torch.zeros(m, 32, device=dev)
    for j in range(lanes * CHUNK):
        s1 = s1 + dyg[:, order[:, j]]
        s2 = fmaf(dyg[:, order[:, j]], xh[:, order[:, j]], s2)
    m1 = warp_sums(s1) / d
    m2 = warp_sums(s2) / d
    r = rstd.reshape(m, 1)
    dxf = r * (dyg - m1[:, None] - xh * m2[:, None])
    if residual is not None:
        dxf = dxf + residual.reshape(m, d).float()
    keep = computed(valid_len, bsz, s_pad, dev)[:, None]
    dx = torch.where(keep, dxf, 0.0).to(dy.dtype).reshape(bsz, s_pad, d)
    return dx, sums
