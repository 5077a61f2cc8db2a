"""Lane-level numpy models of the register and shared-memory layouts that the
head-64 attention's wgmma kernels rely on
(``chadavit_tpu_torch/csrc/prefix_attention_bf16.cu``,
``attention_fwd_wgmma_kernel``, ``attention_dkdv_wgmma_kernel`` /
``attention_dq_wgmma_kernel``, and the helpers of ``csrc/wgmma_bf16.cuh``),
checked against plain matrix products on the CPU, and the forward's model
against a model of the ``mma.sync`` forward's order, bit for bit. The card
cannot be asked here, so these models are what the kernels' indexing was
written against:

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



# ---- the head-64 forward (attention_fwd_wgmma_kernel) ------------------------------
# A lane-level model of one 64-query tile of the wgmma forward: q by TMA into
# the 128-byte swizzle, scaled by qscale and rounded to bf16 in place (16-byte
# chunks), read as the K-major A operand (desc_k64), each K tile read K-major
# as B; the scores in the accumulator registers; the online softmax thread by
# thread in the mma.sync forward's order (its s[nt][e] is d[4 nt + e]); P by
# a_from_acc into the RS product with V read MN-major (desc_mn64); O / l
# through store_tile's staging. Against a model of the mma.sync forward's
# order (operands straight from the rows, ldmatrix's fragments being the
# same m16n8 layout): the same bits; and against plain attention on the same
# bf16 qs within bf16 rounding. A k16 step of either product is modelled as
# its bf16 products summed exactly and added to the float32 sum, rounded
# once, in k16 order, as both kernels take their steps.
def k16_chain(c, a, b):
    """c (+)= a b over the k16 steps in order; a (M, K), b (K, N)."""
    for kk in range(a.shape[1] // 16):
        c = (c.astype(np.float64) + a[:, 16 * kk:16 * kk + 16].astype(np.float64)
             @ b[16 * kk:16 * kk + 16].astype(np.float64)).astype(np.float32)
    return c


def fma32(a, b, c):
    """fmaf in float32: a b + c rounded once."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def quad_xor(x, o):
    """The value lane ^ o holds, over the lanes axis (1) of (4, 32, ...)."""
    return x[:, np.arange(LANES) ^ o]


def online_softmax(sc, m, l, kt, vl):
    """One key tile's softmax on the registers sc (4, 32, 32) in place of
    the mma.sync kernel's s[nt][e]: the ragged tile's keys past vl -inf, the
    row max over j in order, the quad's shuffles, exp2 against it, the
    thread's sum over the unrounded p in j, e order, l = l alpha + sum.
    Returns (p, m, l, alpha); m, l, alpha (4, 32, 2) per row half."""
    _, col = acc_coords()
    sc = np.where(kt * TILE + col >= vl, np.float32(-np.inf), sc).astype(np.float32)
    mx = m.copy()
    for j in range(TILE // 8):
        for half in range(2):
            mx[..., half] = np.maximum(mx[..., half], np.maximum(sc[..., 4 * j + 2 * half],
                                                                 sc[..., 4 * j + 2 * half + 1]))
    for o in (1, 2):
        mx = np.maximum(mx, quad_xor(mx, o))
    with np.errstate(invalid="ignore"):
        alpha = np.exp2(m - mx).astype(np.float32)
    p = np.empty_like(sc)
    sums = np.zeros_like(l)
    for j in range(TILE // 8):
        for e in range(4):
            i = 4 * j + e
            p[..., i] = np.exp2(sc[..., i] - mx[..., e // 2]).astype(np.float32)
            sums[..., e // 2] = (sums[..., e // 2] + p[..., i]).astype(np.float32)
    return p, mx, fma32(l, alpha, sums), alpha


def forward_tile(q, k, v, vl, qscale, wgmma):
    """(out (64, 64) bf16 values, lse (64,)) of one live 64-query tile over
    the keys below vl, by the wgmma kernel's layouts (``wgmma``) or by the
    mma.sync kernel's (operands straight from the rows)."""
    if wgmma:  # TMA box, scaled in place chunk by chunk, read through desc_k64
        box = tma_box(q)
        box = bf16(box * np.float32(qscale))
        qs_k = [read_k_major(box, kk) for kk in range(4)]
        qs = np.concatenate(qs_k, axis=1)
    else:
        qs = bf16(q * np.float32(qscale))
    o = np.zeros((WARPS, LANES, TILE // 2), np.float32)
    m = np.full((WARPS, LANES, 2), -np.inf, np.float32)
    l = np.zeros((WARPS, LANES, 2), np.float32)
    row, _ = acc_coords()
    for kt in range(-(-vl // TILE)):
        kt_rows = slice(kt * TILE, (kt + 1) * TILE)
        if wgmma:
            kbox, vbox = tma_box(k[kt_rows]), tma_box(v[kt_rows])
            kb = np.concatenate([read_k_major(kbox, kk) for kk in range(4)], axis=1).T
            vb = np.concatenate([read_mn_major(vbox, kk) for kk in range(4)], axis=0)
        else:
            kb, vb = k[kt_rows].T, v[kt_rows]
        sc = registers_of(k16_chain(np.zeros((TILE, TILE), np.float32), qs, kb))
        p, m, l, alpha = online_softmax(sc, m, l, kt, vl)
        o = (o * alpha[..., (np.arange(TILE // 2) % 4) // 2]).astype(np.float32)
        if wgmma:  # a_from_acc: the RS A operand of each k16 step
            pm = np.concatenate([matrix_of_a(a_from_acc(p, kk), kk) for kk in range(4)], axis=1)
        else:  # a_from_c: the same fragments, rounded from s[nt][e]
            pm = np.full((TILE, TILE), np.nan, np.float32)
            _, col = acc_coords()
            pm[row, col] = bf16(p)
        om = np.full((TILE, TILE), np.nan, np.float32)
        _, col = acc_coords()
        om[row, col] = o
        o = registers_of(k16_chain(om, pm, vb))
    for o_ in (1, 2):  # the quad's shares of the row sum
        l = (l + quad_xor(l, o_)).astype(np.float32)
    inv = (np.float32(1) / l).astype(np.float32)
    scaled = (o * inv[..., (np.arange(TILE // 2) % 4) // 2]).astype(np.float32)
    out = np.full((TILE, TILE), np.nan, np.float32)
    _, col = acc_coords()
    if wgmma:  # store_tile: staged in the swizzle, read back 16 bytes a row chunk
        smem = np.full(TILE * 64, np.nan, np.float32)
        smem[(row * 128 + (((col // 8) ^ (row % 8)) << 4) + (col % 8) * 2) // 2] = bf16(scaled)
        for r in range(TILE):
            for cc in range(8):
                start = (r * 128 + ((cc ^ (r % 8)) << 4)) // 2
                out[r, 8 * cc:8 * cc + 8] = smem[start:start + 8]
    else:
        out[row, col] = bf16(scaled)
    lse_t = (m + np.log2(l)).astype(np.float32)  # (4, 32, 2): rows 16 q + g (+ 8)
    lse = np.full(TILE, np.nan, np.float32)
    g = np.arange(LANES) // 4
    for half in range(2):
        lse[(16 * np.arange(WARPS)[:, None] + g[None, :] + 8 * half)] = lse_t[..., half]
    return out, lse


def forward_block(q, k, v, vl, qscale, q0, s_pad, consumers):
    """A block of the wgmma forward: its ``consumers`` 64-query tiles from q0,
    each tested against vl on its own; a dead tile writes zeros and lse
    1e30, a tile past s_pad nothing (None)."""
    outs = []
    for c in range(consumers):
        qt0 = q0 + c * TILE
        if qt0 >= s_pad:
            outs.append(None)
        elif qt0 >= vl:
            outs.append((np.zeros((TILE, TILE), np.float32), np.full(TILE, 1e30, np.float32)))
        else:
            outs.append(forward_tile(q[qt0:qt0 + TILE], k, v, vl, qscale, True))
    return outs


QSCALE_64 = float(bf16(np.float32(1.4426950408889634 / 8.0)))  # log2(e) / sqrt(64) in bf16


@pytest.mark.parametrize("vl", [197, 64, 130])
def test_forward_tile_keeps_the_mma_sync_bits(vl):
    """A ragged last key tile (197, 130) and a whole one (64)."""
    rng = np.random.default_rng(vl)
    s_pad = -(-vl // TILE) * TILE
    q, k, v = (bf16(rng.standard_normal((s_pad, 64)).astype(np.float32) * 1.5)
               for _ in range(3))
    for q0 in range(0, vl, TILE):
        got = forward_tile(q[q0:q0 + TILE], k, v, vl, QSCALE_64, True)
        ref = forward_tile(q[q0:q0 + TILE], k, v, vl, QSCALE_64, False)
        for a, b in zip(got, ref):
            assert not np.isnan(a).any()
            np.testing.assert_array_equal(a, b)
        # plain attention on the same bf16 qs: within bf16 rounding of out
        qs = bf16(q[q0:q0 + TILE] * np.float32(QSCALE_64)).astype(np.float64)
        sc = qs @ k[:vl].astype(np.float64).T
        mx = sc.max(1, keepdims=True)
        p = np.exp2(sc - mx)
        plain = (p / p.sum(1, keepdims=True)) @ v[:vl].astype(np.float64)
        np.testing.assert_allclose(got[0], plain, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got[1], (mx[:, 0] + np.log2(p.sum(1))), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("consumers", [2, 3])
def test_forward_block_with_a_dead_tile_and_one_past_the_image(consumers):
    """vl 60 in an image of s_pad 64 (consumers + 1): block 0 holds a live tile
    and dead ones (zeros, lse 1e30); block 1 a dead tile and tiles past the
    image, which store nothing."""
    rng = np.random.default_rng(11)
    s_pad, vl = TILE * (consumers + 1), 60
    q, k, v = (bf16(rng.standard_normal((s_pad, 64)).astype(np.float32)) for _ in range(3))
    b0 = forward_block(q, k, v, vl, QSCALE_64, 0, s_pad, consumers)
    b1 = forward_block(q, k, v, vl, QSCALE_64, TILE * consumers, s_pad, consumers)
    ref = forward_tile(q[:TILE], k, v, vl, QSCALE_64, False)
    for a, b in zip(b0[0], ref):
        np.testing.assert_array_equal(a, b)
    for dead in (*b0[1:], b1[0]):
        assert not dead[0].any() and (dead[1] == 1e30).all()
    assert all(t is None for t in b1[1:])
