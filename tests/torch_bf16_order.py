"""A plain model of the float32 summation order that the bfloat16
out-projection / FFN2 + residual + LayerNorm step (K1b) keeps at D 768, so
that its LayerNorm row pass can be held to it bit for bit on the card, on the
kernel's own pre-LN sum r (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py`` phase 2c, ``scripts/bench_wgmma_bf16.py``), and the model
itself to the JAX package's LayerNorm of a bfloat16 r on the CPU
(``tests/test_torch_wgmma_bf16.py``). It runs on the tensors' device, in
float32 where the kernel rounds and in float64 where it fuses (fmaf,
``tests/torch_f32_order.py``).

- :func:`residual_ln_rows_order`: the LayerNorm of r as the four-block column
  cluster of the first D 768 kernel summed it: for each 192-column part q,
  lane l < 24 of a warp sums the eight columns 192 q + 8 l .. 192 q + 8 l + 7
  in order (s += r; ss = fmaf(r, r, ss)), lanes 24-31 hold zeros, the warp
  adds the lanes by the xor butterfly; the parts' sums are added for q = 0 ..
  3 in order; mu = s / D, var = max(fmaf(-mu, mu, ss / D), 0), rstd =
  rsqrtf(var + eps); out = bf16(fmaf((r - mu) * rstd, g, beta)).

Rows of the 32-row tiles that hold no valid row come out as zeros, as the
kernels write them.
"""

from __future__ import annotations

import torch

from tests.torch_f32_order import PART, _stats, computed, fmaf, warp_sums

LANE_COLS = 8  # the columns of a part that one lane sums


def residual_ln_rows_order(r, g, beta, eps, valid_len=None):
    """``(out, mean, rstd)`` of the bfloat16 K1b's LayerNorm at D 768 on its
    pre-LN sum ``r`` ``(B, S, D)`` bfloat16, in the order of the module
    docstring; g and beta float32 ``(D,)``. With ``valid_len`` only the rows
    of the 32-row tiles that hold a valid row are computed, the others are
    zeros."""
    bsz, s_pad, d = r.shape
    m = bsz * s_pad
    keep = (torch.ones(m, dtype=torch.bool, device=r.device) if valid_len is None
            else computed(valid_len, bsz, s_pad, r.device))
    rr = r.reshape(m, d)[keep].float()
    lanes = PART // LANE_COLS  # 24 lanes hold a part's columns
    parts = rr.reshape(-1, d // PART, lanes, LANE_COLS)
    t = tt = None
    for q in range(d // PART):
        s = torch.zeros(rr.shape[0], 32, device=r.device)
        ss = torch.zeros_like(s)
        for e in range(LANE_COLS):
            v = parts[:, q, :, e]
            s[:, :lanes] = s[:, :lanes] + v
            ss[:, :lanes] = fmaf(v, v, ss[:, :lanes])
        s, ss = warp_sums(s), warp_sums(ss)
        t, tt = (s, ss) if q == 0 else (t + s, tt + ss)
    mu, rstd = _stats(t, tt, d, eps, fused=True)
    y = fmaf((rr - mu[:, None]) * rstd[:, None], g.float().expand_as(rr),
             beta.float().expand_as(rr)).to(r.dtype)
    out = torch.zeros(m, d, dtype=r.dtype, device=r.device)
    mean, rs = torch.zeros(m, device=r.device), torch.zeros(m, device=r.device)
    out[keep], mean[keep], rs[keep] = y, mu, rstd
    return out.reshape(bsz, s_pad, d), mean.reshape(bsz, s_pad), rs.reshape(bsz, s_pad)
