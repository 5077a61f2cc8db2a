"""A numpy model of the 3xTF32 products that the float32 attention backward
at head 64 forms on the tensor cores (``chadavit_tpu_torch/csrc/mma_tf32.cuh``,
``attention_f32.cuh::scores_tf32`` / ``second_tf32``), so that its error can be
held on the CPU against the JAX package's backward
(``tests/test_torch_attention_tf32.py``).

- :func:`tf32`: ``cvt.rna.tf32.f32``, float32 rounded to 10 mantissa bits, to
  nearest with ties away from zero.
- :func:`split`: ``x = big + small``, ``big = tf32(x)``, ``small = tf32(x -
  big)``.
- :func:`matmul_3xtf32`: ``a @ b`` as the kernel forms it: for each step of 8
  along K (one ``mma.m16n8k8``), ``a_small b_big``, then ``a_big b_small``,
  then ``a_big b_big`` into a float32 fragment of zeros, each 8-term product
  exact (a TF32 product is exact in float64) and rounded once as it is added,
  and the fragment added into the float32 sum.
- :func:`attention_backward`: the kernel's five products in that form: ``S =
  qs K^T``, ``P = exp2(S - lse)`` (0 for keys past ``valid_len``), ``dP = dO
  V^T``, ``dS = P (dP - delta)``, ``dV = P^T dO``, ``dK = dS^T qs / log2(e)``,
  ``dq = dS K scale``, qs = q log2(e) / sqrt(hd), over the query rows of the
  64-row tiles that hold a valid query.
"""

from __future__ import annotations

import math

import numpy as np

LOG2E = math.log2(math.e)
SEQ_BLOCK = 64  # the kernels' query and key tile


def tf32(x) -> np.ndarray:
    """float32 ``x`` rounded to TF32 (``cvt.rna``), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def split(x):
    """``(big, small)``, both TF32 values, ``big + small`` within 2^-22 of ``x``."""
    x = np.asarray(x, np.float32)
    big = tf32(x)
    return big, tf32(x - big)


def matmul_3xtf32(a, b) -> np.ndarray:
    """``a (..., M, K) @ b (..., K, N)`` in float32 by 3xTF32, K a multiple of 8."""
    (ab, asm), (bb, bsm) = split(a), split(b)
    acc = np.zeros(np.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (a.shape[-2], b.shape[-1]),
                   np.float32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        step = np.zeros_like(acc)
        for x, y in ((asm, bb), (ab, bsm), (ab, bb)):
            step = (step.astype(np.float64) + x[..., ks].astype(np.float64)
                    @ y[..., ks, :].astype(np.float64)).astype(np.float32)
        acc = acc + step
    return acc


def attention_backward(q, k, v, o, lse, do, valid_len, num_heads: int) -> np.ndarray:
    """``dqkv = [dq, dk, dv]`` ``(B, S, 3 D)`` float32 of the prefix attention,
    the kernel's products in 3xTF32; q, k, v, o, do ``(B, S, D)`` and the
    forward's base-2 lse ``(B, H, S)``, float32."""
    b, s, d = q.shape
    hd = d // num_heads

    def heads(t):
        return np.asarray(t, np.float32).reshape(b, s, num_heads, hd).transpose(0, 2, 1, 3)

    vl = np.asarray(valid_len).reshape(b)
    rows = (np.arange(s) // SEQ_BLOCK * SEQ_BLOCK)[None, :] < vl[:, None]   # (B, S)
    keys = np.arange(s)[None, :] < vl[:, None]
    row_ok, key_ok = rows[:, None, :, None], keys[:, None, None, :]
    qh, kh, vh, oh = map(heads, (q, k, v, o))
    doh = np.where(row_ok, heads(do), np.float32(0))
    qs = (qh * np.float32(LOG2E / math.sqrt(hd))).astype(np.float32)
    scores = matmul_3xtf32(qs, kh.transpose(0, 1, 3, 2))
    p = np.where(row_ok & key_ok,
                 np.exp2(scores - np.asarray(lse, np.float32)[..., None]), 0).astype(np.float32)
    delta = (doh * oh).sum(-1, keepdims=True, dtype=np.float32)
    ds = (p * (matmul_3xtf32(doh, vh.transpose(0, 1, 3, 2)) - delta)).astype(np.float32)
    dv = matmul_3xtf32(p.transpose(0, 1, 3, 2), doh)
    dk = matmul_3xtf32(ds.transpose(0, 1, 3, 2), qs) * np.float32(1 / LOG2E)
    dq = matmul_3xtf32(ds, kh) * np.float32(1 / math.sqrt(hd))

    def merge(t):
        return t.transpose(0, 2, 1, 3).reshape(b, s, d)

    return np.concatenate([merge(t) for t in (dq, dk, dv)], axis=-1).astype(np.float32)
