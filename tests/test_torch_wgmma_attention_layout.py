"""Lane-level numpy models of the register and shared-memory layouts that the
head-64 attention backward's wgmma kernels rely on
(``chadavit_tpu_torch/csrc/prefix_attention_bf16.cu``,
``attention_dkdv_wgmma_kernel`` / ``attention_dq_wgmma_kernel``, and the
helpers of ``csrc/wgmma_bf16.cuh``), checked against plain matrix products
on the CPU. The card cannot be asked here, so these models are what the
kernels' indexing was written against:

- the m64nNk16 accumulator lies as mma.sync's m16n8 C fragments (warp q of
  the warpgroup rows 16 q.., lane l = 4 g + t: d[4 j + e] at row 16 q + g +
  8 (e // 2), column 8 j + 2 t + e % 2);
- the RS form's A operand is, per warp, mma.sync m16n8k16's A fragment, so
  ``a_from_acc`` (the sums of n8 blocks 2 kk and 2 kk + 1, rounded to bf16
  and packed in pairs) is the A operand of k16 step kk: P^T and dS^T feed
  dV += P^T dO and dK += dS^T qs, and dS feeds dQ += dS K, without leaving
  the registers;
- a TMA box of 64 rows of 64 bf16 in the 128-byte swizzle (chunk c of row r
  at chunk c ^ (r % 8)), read by wgmma through ``desc_k64`` (K-major: a row
  is 64 K values; the k16 step moves 32 bytes) and ``desc_mn64`` (MN-major,
  the transposed B: a row is 64 N values of one K; the k16 step moves 16
  rows, SBO 1024 between groups of 8 K rows), the swizzle applied to the
  address bits as the hardware does (bits 4-6 XOR bits 7-9);
- ``store_tile``'s staging: the fragments' 4-byte writes in the same swizzle
  hit 32 different banks, and the 16-byte chunks read back are the rows'.

bf16 rounding is modelled by round-to-nearest-even on the float32 bits.
"""

import numpy as np
import pytest

TILE = 64
WARPS, LANES = 4, 32


def bf16(x):
    """float32 rounded to bf16 (nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def acc_coords(n=TILE):
    """(row, col) of accumulator register i of warp q, lane l: arrays of
    shape (4, 32, n // 2)."""
    q = np.arange(WARPS)[:, None, None]
    lane = np.arange(LANES)[None, :, None]
    i = np.arange(n // 2)[None, None, :]
    g, t = lane // 4, lane % 4
    row = 16 * q + g + 8 * ((i % 4) // 2)
    col = 8 * (i // 4) + 2 * t + i % 2
    return np.broadcast_to(row, (WARPS, LANES, n // 2)), np.broadcast_to(col, (WARPS, LANES,
                                                                                 n // 2))


def a_coords(kk):
    """(row, k) of the two bf16 halves of A register r (0..3) of warp q,
    lane l in the k16 step kk: arrays of shape (4, 32, 4, 2)."""
    q = np.arange(WARPS)[:, None, None, None]
    lane = np.arange(LANES)[None, :, None, None]
    r = np.arange(4)[None, None, :, None]
    h = np.arange(2)[None, None, None, :]
    g, t = lane // 4, lane % 4
    row = 16 * q + g + 8 * (r % 2)
    k = 16 * kk + 2 * t + 8 * (r // 2) + h
    shape = (WARPS, LANES, 4, 2)
    return np.broadcast_to(row, shape), np.broadcast_to(k, shape)


def a_from_acc(d, kk):
    """The kernel's a_from_acc on every thread's registers d (4, 32, 32):
    a[i] = bf16 pair (d[8 kk + 2 i], d[8 kk + 2 i + 1])."""
    a = np.empty((WARPS, LANES, 4, 2), np.float32)
    for i in range(4):
        a[:, :, i, 0] = bf16(d[:, :, 8 * kk + 2 * i])
        a[:, :, i, 1] = bf16(d[:, :, 8 * kk + 2 * i + 1])
    return a


def registers_of(mat):
    """The accumulator registers (4, 32, 32) that hold the 64 x 64 ``mat``."""
    row, col = acc_coords()
    return mat[row, col]


def matrix_of_a(a, kk):
    """The 64 x 16 block (rows, k 16 kk ..) that A fragments ``a`` hold."""
    row, k = a_coords(kk)
    out = np.full((TILE, 16), np.nan, np.float32)
    out[row, k - 16 * kk] = a
    return out


def rs_product(d, b):
    """sum over the k16 steps of A(kk) B[16 kk .. 16 kk + 16], A from the
    registers d by a_from_acc: the RS wgmma chain as the kernels issue it."""
    return sum(matrix_of_a(a_from_acc(d, kk), kk).astype(np.float64)
               @ b[16 * kk:16 * kk + 16].astype(np.float64) for kk in range(TILE // 16))


@pytest.mark.parametrize("seed", [0, 1])
def test_accumulator_registers_are_the_rs_a_operand(seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((TILE, TILE)).astype(np.float32)
    d = registers_of(s)
    for kk in range(TILE // 16):  # every register of A lands on its element, once
        block = matrix_of_a(a_from_acc(d, kk), kk)
        assert not np.isnan(block).any()
        np.testing.assert_array_equal(block, bf16(s[:, 16 * kk:16 * kk + 16]))
    # dV += bf16(P^T) dO: the chain over the four k16 steps is the plain product
    do = bf16(rng.standard_normal((TILE, TILE)).astype(np.float32))
    np.testing.assert_allclose(rs_product(d, do), bf16(s).astype(np.float64) @ do, rtol=1e-12,
                               atol=1e-12)


def test_scores_to_dk_and_dv_through_the_registers():
    """One warpgroup's 64 keys against one 64-query tile, as
    attention_dkdv_wgmma_kernel computes it with the register layouts above,
    against the plain formulas (f32 sums, bf16 rounding of p and ds)."""
    rng = np.random.default_rng(7)
    k, v, qs, do = (bf16(rng.standard_normal((TILE, 64)).astype(np.float32) * 0.5)
                    for _ in range(4))
    lse = (rng.standard_normal(TILE) + 4).astype(np.float32)
    delta = rng.standard_normal(TILE).astype(np.float32)
    vl_keys = 45  # keys past it give p = 0
    st = k.astype(np.float64) @ qs.T.astype(np.float64)  # S^T: keys x queries
    dpt = v.astype(np.float64) @ do.T.astype(np.float64)
    row, col = acc_coords()
    sc, dp = registers_of(st.astype(np.float32)), registers_of(dpt.astype(np.float32))
    p = np.where(row < vl_keys, np.exp2(sc - lse[col]), 0.0).astype(np.float32)
    ds = (p * (dp - delta[col])).astype(np.float32)
    dv = rs_product(p, do)
    dk = rs_product(ds, qs)
    p_ref = np.where(np.arange(TILE)[:, None] < vl_keys,
                     np.exp2(st.astype(np.float32) - lse[None, :]), 0.0).astype(np.float32)
    ds_ref = (p_ref * (dpt.astype(np.float32) - delta[None, :])).astype(np.float32)
    np.testing.assert_allclose(dv, bf16(p_ref).astype(np.float64) @ do, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dk, bf16(ds_ref).astype(np.float64) @ qs, rtol=1e-6, atol=1e-6)
    assert not dv[vl_keys:].any() and not dk[vl_keys:].any()


# ---- shared memory: the TMA box and the wgmma descriptors --------------------------
def swizzle(addr):
    """The 128-byte swizzle on a byte address (1024-byte aligned tiles): the
    16-byte chunk bits 4-6 XOR the row bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_box(tile):
    """The bytes a TMA load of a 64 x 64 bf16 box writes (CU_TENSOR_MAP_SWIZZLE_128B),
    as an array of 4096 bf16 indexed by (byte offset) / 2."""
    smem = np.full(TILE * 64, np.nan, np.float32)
    r, c = np.meshgrid(np.arange(TILE), np.arange(64), indexing="ij")
    smem[(r * 128 + ((c // 8) ^ (r % 8)) * 16 + (c % 8) * 2) // 2] = tile
    return smem


def read_k_major(smem, kk):
    """The 64 x 16 (M or N, K) operand that desc_k64(tile, kk) describes:
    element (mn, k) at start + (mn % 8) 128 + (mn // 8) SBO + 2 k, start =
    32 kk, SBO 1024, then swizzled."""
    mn, k = np.meshgrid(np.arange(TILE), np.arange(16), indexing="ij")
    addr = 32 * kk + (mn % 8) * 128 + (mn // 8) * 1024 + 2 * k
    return smem[swizzle(addr) // 2]


def read_mn_major(smem, kk):
    """The 16 x 64 (K, N) operand that desc_mn64(tile, kk) describes: element
    (k, n) at start + 2 n + (k % 8) 128 + (k // 8) SBO, start = 2048 kk, SBO
    1024 (n < 64: one atom, LBO not stepped), then swizzled."""
    k, n = np.meshgrid(np.arange(16), np.arange(64), indexing="ij")
    addr = 2048 * kk + 2 * n + (k % 8) * 128 + (k // 8) * 1024
    return smem[swizzle(addr) // 2]


@pytest.mark.parametrize("kk", range(TILE // 16))
def test_descriptors_read_the_tma_box(kk):
    rng = np.random.default_rng(kk)
    tile = rng.standard_normal((TILE, 64)).astype(np.float32)  # rows x head columns
    smem = tma_box(tile)
    assert not np.isnan(smem).any()  # the box fills its 8 KB
    # K-major: rows are M (or N) indices, the head columns the contraction
    np.testing.assert_array_equal(read_k_major(smem, kk), tile[:, 16 * kk:16 * kk + 16])
    # MN-major (the transposed B: dO, qs, K as the second factor): rows are
    # the contraction (queries or keys), the head columns N
    np.testing.assert_array_equal(read_mn_major(smem, kk), tile[16 * kk:16 * kk + 16, :])


def test_products_from_the_descriptors_are_the_kernels_products():
    """S^T = K qs^T from two K-major reads and dK += dS^T qs from an MN-major
    read, summed over the k16 steps, against the plain products."""
    rng = np.random.default_rng(3)
    k, qs = (rng.standard_normal((TILE, 64)).astype(np.float32) for _ in range(2))
    ks, qss = tma_box(k), tma_box(qs)
    st = sum(read_k_major(ks, kk).astype(np.float64) @ read_k_major(qss, kk).T.astype(np.float64)
             for kk in range(4))
    np.testing.assert_allclose(st, k.astype(np.float64) @ qs.T.astype(np.float64), rtol=1e-12)
    ds = rng.standard_normal((TILE, TILE))
    dk = sum(ds[:, 16 * kk:16 * kk + 16] @ read_mn_major(qss, kk).astype(np.float64)
             for kk in range(4))
    np.testing.assert_allclose(dk, ds @ qs.astype(np.float64), rtol=1e-12)


def test_store_tile_staging_is_conflict_free_and_round_trips():
    """store_tile: each (n8 block j, half) of a warp's fragment writes lands
    in 32 different banks, and the 16-byte chunks read back hold the rows."""
    lane = np.arange(LANES)
    g, t = lane // 4, lane % 4
    for q in range(WARPS):
        for j in range(8):
            for half in range(2):
                r = 16 * q + g + 8 * half
                addr = r * 128 + ((j ^ (r % 8)) << 4) + 4 * t
                assert len(set((addr // 4) % 32)) == 32, (q, j, half)
    rng = np.random.default_rng(5)
    mat = rng.standard_normal((TILE, TILE)).astype(np.float32)
    smem = np.full(TILE * 64, np.nan, np.float32)
    row, col = acc_coords()
    smem[(row * 128 + (((col // 8) ^ (row % 8)) << 4) + (col % 8) * 2) // 2] = mat[row, col]
    for r in range(TILE):
        for cc in range(8):
            start = (r * 128 + ((cc ^ (r % 8)) << 4)) // 2
            np.testing.assert_array_equal(smem[start:start + 8], mat[r, 8 * cc:8 * cc + 8])

