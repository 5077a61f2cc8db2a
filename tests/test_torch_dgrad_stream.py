"""The plan of ChAdaViT-B/16's float32 data gradient (K2b) at D 768, the
stream-K walk of ``csrc/fused_block_bwd.cu::linear_dgrad_stream_kernel``,
held on the CPU: ``fused_block.dgrad_stream_plan`` covers every (computed
32-row tile, column slice, slab of K) unit once, uses at most tiles + blocks
- 1 slots (tile + block, one a split tile's segment), and
``dgrad_stream_fixups`` lists each split tile's slots in block order, the
kernel's arithmetic; a numpy model of the walk's sum order (each segment's
slabs in K order, a split tile's segments added in block order, then the
ReLU mask or the residual) drives the layer's backward at D 768, depth 1,
on two images of the narrow float32 rows (S_pad 640, 3 and 1 channels),
against ``jax.vjp`` of the JAX package's fused Pallas layer kernel in
interpret mode (as ``tests/test_torch_fused_block_d768.py`` runs it); and
the wrapper hands the walk its scratch. On the card the kernel is held to
the plain version (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``
phase 2c).

Tolerance of the layer: its float32 gradients within 1e-4 of their largest
entry (at least 1), the bound of the port's other float32 gradient tests.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.ops.fused_block import fused_encoder_block as jax_fused
from chadavit_tpu_torch.ops import fused_block
from tests.test_torch_fused_block_backward import fake_cuda  # noqa: F401 (a fixture)

D, F, H = 768, 2048, 12
SITES = {"mask": (D, F), "ffn1": (F, D), "out": (D, D), "qkv": (3 * D, D)}  # (K, N)
BLOCKS = 3 * 132  # three blocks on each of the H100's 132 SMs
NARROW = (640, [1 + 196 * c for c in (3, 1, 2, 3, 1, 2, 3, 2)])  # chip_smoke.py's phase 2c
EPS1, EPS2 = 1e-5, 1e-6
F32_REL = 1e-4


def _computed(valid_len, s_pad):
    return [b * s_pad + t for b, n in enumerate(valid_len) for t in range(0, s_pad, 32)
            if t < n]


@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("s_pad, valid_len, blocks", [
    (*NARROW, BLOCKS),  # the narrow float32 rows
    (640, [1 + 196 * c for c in (3, 2, 3, 2)], BLOCKS),  # the 3-channel bucket's rows
    (160, [1, 33, 0, 97, 160, 129], BLOCKS),  # ragged, a padded image, shares across images
    (128, [0, 0, 0], BLOCKS),  # nothing to walk
    (64, [64, 1], BLOCKS),  # fewer units than blocks at the out-projection
    (640, [1 + 196 * c for c in (3, 1, 2)], 7),  # shares of many whole tiles
])
def test_dgrad_stream_plan_covers_every_unit_once_in_order(site, s_pad, valid_len, blocks):
    k, n = SITES[site]
    slices, slabs = n // fused_block.DGRAD_F32_COLUMNS[n], k // fused_block.DGRAD_F32_SLAB
    plan = fused_block.dgrad_stream_plan(valid_len, s_pad, k, n, blocks)
    computed = _computed(valid_len, s_pad)
    tiles = len(computed) * slices
    assert len(plan) == blocks
    walked, slots, by_tile = [], [], {t: [] for t in range(tiles)}
    for blk, segments in enumerate(plan):
        assert [t for t, _, _ in segments] == sorted({t for t, _, _ in segments})
        for t, slot, units in segments:
            walked += units
            by_tile[t].append((blk, slot, units))
            if slot is not None:
                assert slot == t + blk
                slots.append(slot)
    # every unit once, tile-major: (row tile, slice) in order, each tile's slabs in order
    assert walked == [(r, j, q) for r in computed for j in range(slices) for q in range(slabs)]
    assert len(slots) == len(set(slots)) and all(0 <= s < tiles + blocks - 1 for s in slots)
    shares = [sum(len(u) for _, _, u in segments) for segments in plan]
    assert max(shares) - min(shares) <= 1  # near-equal shares
    for t in range(tiles):
        segs = by_tile[t]
        alone = len(segs) == 1
        assert (segs[0][1] is None) == alone  # a tile one block sums is written by it
        fix = fused_block.dgrad_stream_fixups(t, slabs, tiles, blocks)
        assert fix == ([] if alone else [slot for _, slot, _ in segs])  # block order


@pytest.mark.parametrize("m, n", [(8 * 640, F), (8 * 640, D), (32, D)])
def test_dgrad_stream_scratch_holds_every_tile_and_the_grid(m, n):
    tiles = m // 32 * (n // fused_block.DGRAD_F32_COLUMNS[n])
    for blocks in (1, BLOCKS, 4 * 132):
        slots = fused_block.dgrad_stream_slots(m, n, blocks)
        assert slots == tiles + blocks - 1
        # the plan's slots (tile + block) stay below it
        s_pad = min(m, 640)
        vl = [s_pad] * (m // s_pad)
        k = D if n == F else F
        assert all(slot is None or slot < slots for segments in
                   fused_block.dgrad_stream_plan(vl, s_pad, k, n, blocks)
                   for _, slot, _ in segments)


def dgrad_walk_model(dy, w, valid_len, relu_of=None, residual=None, blocks=BLOCKS):
    """``linear_dgrad`` at D 768 as the walk sums it (numpy, float32): each
    segment of the plan its slabs in K order, the segments of a split tile
    added in block order, then the epilogue; zeros on the zero-filled tiles."""
    bsz, s, k = dy.shape
    n = w.shape[1]
    a, wt = dy.reshape(-1, k).numpy(), w.numpy()
    bn, slab = fused_block.DGRAD_F32_COLUMNS[n], fused_block.DGRAD_F32_SLAB
    parts = {}  # tile -> its segments' sums in block order
    for segments in fused_block.dgrad_stream_plan(valid_len.tolist(), s, k, n, blocks):
        for t, _, units in segments:
            acc = np.zeros((32, bn), np.float32)
            for r, j, q in units:
                acc += a[r:r + 32, q * slab:(q + 1) * slab] @ wt[q * slab:(q + 1) * slab,
                                                                   j * bn:(j + 1) * bn]
            parts.setdefault(t, []).append(((r, j), acc))
    out = np.zeros((bsz * s, n), np.float32)
    for segs in parts.values():
        (r, j), total = segs[0][0], np.zeros((32, bn), np.float32)
        for _, acc in segs:
            total += acc
        out[r:r + 32, j * bn:(j + 1) * bn] = total
    out = torch.from_numpy(out.reshape(bsz, s, n))
    rows = fused_block.computed_rows(out, valid_len)
    if relu_of is not None:
        out = torch.where(relu_of > 0, out, 0.0)
    if residual is not None:
        out = out + residual
    return torch.where(rows, out, 0.0)


def test_walk_order_through_the_layer_matches_jax_vjp_of_the_fused_kernel():
    s, valid = NARROW[0], NARROW[1][:2]
    rng = np.random.default_rng(24)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    ws = [n(3 * D, D, scale=D ** -0.5), n(3 * D, scale=0.02), n(D, D, scale=D ** -0.5),
          n(D, scale=0.02), 1 + n(D, scale=0.1), n(D, scale=0.05), 1 + n(D, scale=0.1),
          n(D, scale=0.05), n(F, D, scale=D ** -0.5), n(F, scale=0.02),
          n(D, F, scale=F ** -0.5), n(D, scale=0.02)]
    x, tgt = n(2, s, D), n(2, s, D)
    vl = np.asarray(valid, np.int32)
    rows = [-(-m // 32) * 32 for m in valid]
    wrows = np.zeros((2, s, 1), np.float32)
    for i, m in enumerate(rows):
        wrows[i, :m] = 1.0

    def jloss(x_, *w_):
        y = jax_fused(x_, jnp.asarray(vl), *w_, H, EPS1, EPS2, 128, True)
        return jnp.sum((wrows * (y - tgt)) ** 2)

    jws = [jnp.asarray(w.T.copy() if w.ndim == 2 else w) for w in ws]
    ref = jax.grad(jloss, argnums=tuple(range(13)))(jnp.asarray(x), *jws)
    ref = [np.asarray(r) for r in ref]
    ref = [r.T if r.ndim == 2 else r for r in ref]

    steps = SimpleNamespace(**{**vars(fused_block.PLAIN_STEPS),
                                           "linear_dgrad": dgrad_walk_model})
    xt, vt, wt = torch.from_numpy(x), torch.from_numpy(vl), [torch.from_numpy(w) for w in ws]
    y, saved = fused_block.layer_forward(steps, xt, vt, wt, H, EPS1, EPS2, save=True)
    dy = 2 * torch.from_numpy(wrows) ** 2 * (y - torch.from_numpy(tgt))
    got = fused_block.layer_backward(steps, dy, xt, vt, *saved, wt, H, EPS1)
    got = [g.reshape(w.shape).numpy() for g, w in zip(got, [xt, *wt])]
    dx = np.concatenate([got[0][i, :m] for i, m in enumerate(rows)])
    dx_ref = np.concatenate([ref[0][i, :m] for i, m in enumerate(rows)])
    for name, a, b in zip(["x", *map(str, range(12))], [dx] + got[1:], [dx_ref] + ref[1:]):
        assert np.abs(a - b).max() <= F32_REL * max(1.0, np.abs(b).max()), name
    for i, m in enumerate(rows):  # the zero-filled tiles get dx = 0
        assert not got[0][i, m:].any()


@pytest.mark.parametrize("site", list(SITES))
def test_f32_dgrad_at_d768_hands_the_walk_its_scratch(fake_cuda, site):
    k, n = SITES[site]
    bsz, s = 3, 640
    vl = torch.tensor([640, 3, 100], dtype=torch.int32)
    dy, w = torch.zeros(bsz, s, k), torch.zeros(k, n)
    kw = {"mask": {"relu_of": torch.zeros(bsz, s, n)},
          "ffn1": {"residual": torch.zeros(bsz, s, n)}}.get(site, {})
    fake_cuda.blocks = 300  # the grid the runtime reports on this card
    asked = []
    query = fake_cuda.linear_dgrad_d768_blocks
    fake_cuda.linear_dgrad_d768_blocks = lambda *a: asked.append(a) or query(*a)
    for _ in range(2):
        fused_block.linear_dgrad(dy, w, vl, **kw)
    epi = {"mask": 1, "ffn1": 2}.get(site, 0)
    assert asked == [(k, n, epi)]  # asked once a site
    assert fake_cuda.calls == ["linear_dgrad_d768"] * 2
    args = fake_cuda.args[0]
    assert len(args) == 14
    assert args[:2] == (dy.data_ptr(), w.data_ptr()) and args[-5:-1] == (bsz * s, k, n, s)
    assert args[6] == bsz * s // 32 * (n // fused_block.DGRAD_F32_COLUMNS[n]) + 300 - 1
