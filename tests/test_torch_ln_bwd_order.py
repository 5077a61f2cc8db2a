"""The order models of ``layernorm_bwd`` (K2a, ``tests/torch_ln_bwd_order.py``)
on the CPU: the bfloat16 row pass at D 768, lane by lane (its 16-byte chunks,
its partials in the shared-memory slots of ``lnw_slot`` read back by the
kernel's column index), gives dgamma and dbeta with the bits of the order
that ``layernorm_bwd_kernel`` sums them in, and dx within a bf16 step of the
plain version (``fused_block.layernorm_bwd_reference``); the order of the
sums is the plain version's dgamma and dbeta within float32 rounding. The
card holds the kernel to the same models (``tests/test_torch_kernels_gpu.py``).
Shapes: D 768, ragged prefixes (a tile of one valid row, tiles past the
prefix, an image with none), split counts that give splits of no computed
tile, of one and of several, with and without the residual and a dgb to sum
into.
"""

import numpy as np
import pytest
import torch

from chadavit_tpu_torch.ops import fused_block
from tests import torch_ln_bwd_order as order

D = fused_block.D_WIDE
CASES = {  # (S_pad, valid lengths, splits)
    "ragged": (96, [1, 33, 96, 0], 5),
    "one_tile_a_split": (64, [64, 17, 40], 6),
    "several_tiles_a_split": (128, [128, 65, 3], 2),
}


def _inputs(case, residual, seed=0):
    s, valid, splits = CASES[case]
    rng = np.random.default_rng(seed + len(valid))
    bsz = len(valid)

    def bf(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale
                                + shift).bfloat16()

    dy, x = bf(bsz, s, D), bf(bsz, s, D, scale=2.0, shift=0.5)
    xf = x.float()
    mean = xf.mean(-1)
    rstd = torch.rsqrt(xf.var(-1, unbiased=False) + 1e-5)
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(D).astype(np.float32))
    res = bf(bsz, s, D) if residual else None
    return dy, x, mean, rstd, g, res, torch.tensor(valid, dtype=torch.int32), splits


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_wide_row_pass_keeps_the_param_sums_and_dx(case, residual, accumulate):
    dy, x, mean, rstd, g, res, vl, splits = _inputs(case, residual)
    dgb = torch.linspace(-1, 1, 2 * D) if accumulate else None
    dx, sums = order.wide_row_pass_order(dy, x, mean, rstd, g, vl, splits, res, dgb)
    old = order.param_sums_order(dy, x, mean, rstd, vl, splits, dgb)
    assert torch.equal(sums, old)  # the row pass keeps layernorm_bwd_kernel's bits
    ref_dx, ref_sums = fused_block.layernorm_bwd_reference(
        dy, x, mean, rstd, g, vl, res, None if dgb is None else dgb.clone())
    assert dx.dtype == torch.bfloat16
    # one bf16 step of the value at most (the sums' order moves dx by a few
    # float32 steps, which can cross a bf16 rounding boundary)
    step = ref_dx.float().abs() * 2.0 ** -7 + 1e-6
    assert ((dx.float() - ref_dx.float()).abs() <= step).all()
    assert torch.allclose(sums, ref_sums, rtol=1e-5, atol=1e-4)
    # rows of the tiles past the prefix: dx exactly zero
    for i, n in enumerate(vl.tolist()):
        start = -(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK
        assert not dx[i, start:].any()


def test_param_sums_follow_the_split_plan():
    """A split count that changes which rows share a partial changes the
    float32 bits of dgamma (so the plan is part of the bits), while the sums
    stay the plain version's within rounding."""
    dy, x, mean, rstd, g, _, vl, _ = _inputs("several_tiles_a_split", False, seed=3)
    one = order.param_sums_order(dy, x, mean, rstd, vl, 1)
    many = order.param_sums_order(dy, x, mean, rstd, vl, 12)
    assert not torch.equal(one, many)
    _, ref = fused_block.layernorm_bwd_reference(dy, x, mean, rstd, g, vl)
    for got in (one, many):
        assert torch.allclose(got, ref, rtol=1e-5, atol=1e-4)
