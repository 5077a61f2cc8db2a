"""Plain models of the float32 summation orders that the port's layer-chain
kernels keep, so that a kernel can be held to them bit for bit on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py`` phase 2c) and the
models themselves to the plain versions and the JAX package on the CPU
(``tests/test_torch_f32_order_d768.py``). Each runs on the tensors' device,
in float32 where the kernel rounds and in float64 where it fuses (fmaf).

- :func:`ln_linear_order`: the LN1 + QKV step (K1a) as the first port's
  kernel summed it, which every float32 K1a since keeps: row_stats' lane
  sums and warp butterfly, the prologue, the fmaf chain over k, the bias.
- :func:`linear_relu_order`: the FFN1 + ReLU step (K1c) as the first port's
  kernel summed it, which every float32 K1c since keeps (the D 768 one on
  the 128-row GEMM with a ReLU epilogue): the fmaf chain over k, the bias,
  then the max with 0.
- :func:`linear_residual_ln_order`: the out-projection / FFN2 + residual +
  LayerNorm step (K1b) at D 768 as its first kernel summed it (a cluster of
  four 192-column blocks whose partial LayerNorm sums were added in rank
  order): the fmaf chain over k, the bias, the residual, four partial sums
  over 192 columns added in order, the variance's mu * mu and the
  LayerNorm's product by g fused.

Rows of the 32-row tiles that hold no valid row come out as zeros, as the
kernels write them.
"""

from __future__ import annotations

import math

import torch

ROW_BLOCK = 32   # the kernels' row tile
PART = 192       # K1b at D 768: the columns of one partial LayerNorm sum


def fmaf(a, b, c):
    """CUDA's fmaf on float32 tensors: a * b + c rounded once, computed exactly
    in float64 (the product is exact there; the sum's rounding error is
    recovered by TwoSum, and a float64 sum that lies halfway between two
    float32 values is rounded to the side that error lies on)."""
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    f = s.float()
    back = f.double()
    other = torch.nextafter(f, torch.where(s > back, math.inf, -math.inf).float())
    tie = (s != back) & (s - back == (other.double() - back) / 2)
    return torch.where(tie & (e != 0) & ((e > 0) == (other.double() > back)), other, f)


def computed(valid_len, bsz: int, s_pad: int, device) -> torch.Tensor:
    """``(B * S,)`` bool: the row lies in a 32-row tile that holds a valid row."""
    start = torch.arange(s_pad, device=device) // ROW_BLOCK * ROW_BLOCK
    vl = torch.as_tensor(valid_len, device=device).reshape(-1)
    return (start[None, :] < vl[:, None]).reshape(bsz * s_pad)


def warp_sums(lanes):
    """The xor butterfly 16, 8, 4, 2, 1 over the last axis (32 lanes): every
    lane ends with the same sum, in the order the warp adds them."""
    idx = torch.arange(32, device=lanes.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    return lanes[..., 0]


def product(a, w):
    """``a @ w^T`` as the kernels sum it: each output from k = 0 upward,
    acc = fmaf(a[k], w[n, k], acc) from 0; a ``(M, K)``, w ``(N, K)``."""
    m, k = a.shape
    n = w.shape[0]
    acc = torch.zeros(m, n, device=a.device)
    for j in range(k):
        acc = fmaf(a[:, j:j + 1].expand(m, n), w[:, j].expand(m, n), acc)
    return acc


def _stats(s, ss, width: int, eps: float, fused: bool):
    """mu = s / width, var = max(ss / width - mu * mu, 0), rstd = rsqrt(var +
    eps), all float32; with ``fused`` the difference is fmaf(-mu, mu, ss /
    width), else the product is rounded on its own."""
    kk = torch.full_like(s, float(width))
    mu = s / kk
    var = fmaf(-mu, mu, ss / kk) if fused else ss / kk - mu * mu
    return mu, torch.rsqrt(torch.clamp(var, min=0.0) + eps)


def ln_linear_order(x, g, b, eps, w, bias, valid_len=None):
    """``(qkv, mean, rstd)`` in the order of the first port's ln_linear_fwd
    as nvcc compiles it: lane l sums columns l, l + 32, ... in order (s += v;
    ss = fmaf(v, v, ss)), the warp adds the lanes by the xor butterfly 16, 8,
    4, 2, 1, mu = s / K, var = max(ss / K - mu * mu, 0) with the product
    rounded on its own (nvcc fuses no fmaf there), rstd = rsqrtf(var + eps);
    h = fmaf((x - mu) * rstd, g, beta); qkv = the fmaf chain over k from 0,
    then + bias. (Which products nvcc fuses was read on the card, against
    the first port's own kernel.) With ``valid_len`` only the rows of the
    32-row tiles that hold a valid row are computed, the others are zeros."""
    bsz, s_pad, k = x.shape
    m, n = bsz * s_pad, w.shape[0]
    keep = (torch.ones(m, dtype=torch.bool, device=x.device) if valid_len is None
            else computed(valid_len, bsz, s_pad, x.device))
    xr = x.reshape(m, k)[keep]
    lanes = xr.reshape(-1, k // 32, 32)  # column lane + 32 c
    s = torch.zeros(xr.shape[0], 32, device=x.device)
    ss = torch.zeros_like(s)
    for c in range(k // 32):
        s = s + lanes[:, c]
        ss = fmaf(lanes[:, c], lanes[:, c], ss)
    mu, rstd = _stats(warp_sums(s), warp_sums(ss), k, eps, fused=False)
    h = fmaf((xr - mu[:, None]) * rstd[:, None], g.expand_as(xr), b.expand_as(xr))
    qkv, mean, rs = (torch.zeros(m, n, device=x.device), torch.zeros(m, device=x.device),
                     torch.zeros(m, device=x.device))
    qkv[keep], mean[keep], rs[keep] = product(h, w) + bias, mu, rstd
    return qkv.reshape(bsz, s_pad, n), mean.reshape(bsz, s_pad), rs.reshape(bsz, s_pad)


def linear_relu_order(x, w, bias, valid_len=None):
    """hid = max(the fmaf chain over k from 0 + bias, 0), ``(B, S, N)``, in
    the order of the first port's linear_relu_fwd, which the float32 K1c
    keeps at every width (hid sits on the ReLU kink, and the layer's backward
    reads its mask from it). With ``valid_len`` only the rows of the 32-row
    tiles that hold a valid row are computed, the others are zeros."""
    bsz, s_pad, k = x.shape
    m, n = bsz * s_pad, w.shape[0]
    keep = (torch.ones(m, dtype=torch.bool, device=x.device) if valid_len is None
            else computed(valid_len, bsz, s_pad, x.device))
    hid = torch.zeros(m, n, device=x.device)
    hid[keep] = torch.clamp(product(x.reshape(m, k)[keep], w) + bias, min=0.0)
    return hid.reshape(bsz, s_pad, n)


def linear_residual_ln_order(a, w, bias, res, g, beta, eps, valid_len=None):
    """``(out, mean, rstd, r)`` of the float32 linear_residual_ln at D 768 in
    the order of its first kernel (a cluster of four 192-column blocks):
    r = res + (the fmaf chain over k from 0 + bias); for each 192-column
    part q, lane l sums columns 192 q + l + 32 c, c < 6, in order (s += r;
    ss = fmaf(r, r, ss)) and the warp adds the lanes by the xor butterfly;
    the four parts' sums are added for q = 0 .. 3 in order; mu = s / D, var =
    max(fmaf(-mu, mu, ss / D), 0) (nvcc fused this product there, after a
    division by the constant D, where K1a's row_stats divides by a runtime
    width and rounds it on its own), rstd = rsqrtf(var + eps); out =
    fmaf((r - mu) * rstd, g, beta). With
    ``valid_len`` only the rows of the 32-row tiles that hold a valid row are
    computed, the others are zeros."""
    bsz, s_pad, k = a.shape
    m, d = bsz * s_pad, w.shape[0]
    keep = (torch.ones(m, dtype=torch.bool, device=a.device) if valid_len is None
            else computed(valid_len, bsz, s_pad, a.device))
    r = res.reshape(m, d)[keep] + (product(a.reshape(m, k)[keep], w) + bias)
    parts = r.reshape(-1, d // PART, PART // 32, 32)  # column 192 q + lane + 32 c
    t = tt = None
    for q in range(d // PART):
        s = torch.zeros(r.shape[0], 32, device=a.device)
        ss = torch.zeros_like(s)
        for c in range(PART // 32):
            s = s + parts[:, q, c]
            ss = fmaf(parts[:, q, c], parts[:, q, c], ss)
        s, ss = warp_sums(s), warp_sums(ss)
        t, tt = (s, ss) if q == 0 else (t + s, tt + ss)
    mu, rstd = _stats(t, tt, d, eps, fused=True)
    y = fmaf((r - mu[:, None]) * rstd[:, None], g.expand_as(r), beta.expand_as(r))
    out, rfull = torch.zeros(m, d, device=a.device), torch.zeros(m, d, device=a.device)
    mean, rs = torch.zeros(m, device=a.device), torch.zeros(m, device=a.device)
    out[keep], rfull[keep], mean[keep], rs[keep] = y, r, mu, rstd
    return (out.reshape(bsz, s_pad, d), mean.reshape(bsz, s_pad), rs.reshape(bsz, s_pad),
            rfull.reshape(bsz, s_pad, d))
