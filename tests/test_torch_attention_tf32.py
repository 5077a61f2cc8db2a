"""The float32 attention backward at head 64 in 3xTF32, as its CUDA kernel
forms its five products on the tensor cores (``csrc/prefix_attention_bwd.cu``,
``csrc/mma_tf32.cuh``), modelled in numpy (``tests/torch_tf32_split.py``) and
held on the CPU against the JAX package's backward: ``jax.vjp`` of
``chadavit_tpu/ops/flash_attention.py::prefix_flash_attention`` (the Pallas
kernel in interpret mode, its custom VJP the TPU backward kernel). On the
card the kernel itself is held to the plain float32 version
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

B 3, S 256, ragged prefixes (a whole sequence, 130 and 60 rows, and an image
of one row in the second case), head 64: ChAdaViT-B/16's D 768 in 12 heads
and a narrow D 128 in 2. The model takes the lse and o of the port's plain
forward. Tolerance: that of the kernel's ``gpu`` tests, 1e-4 times the
largest entry of the reference where that exceeds 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.ops.flash_attention import prefix_flash_attention as jax_flash
from chadavit_tpu_torch.ops import flash_attention as fa
from tests import torch_tf32_split as tf32

B, S = 3, 256
VALIDS = [[256, 130, 60], [1, 256, 193]]
TOL = 1e-4


def test_split_keeps_22_bits_and_rounds_ties_away_from_zero():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 1e3
    big, small = tf32.split(x)
    for t in (big, small):  # TF32: the 13 low mantissa bits are zero
        assert not (t.view(np.uint32) & 0x1FFF).any()
    err = np.abs((big.astype(np.float64) + small) - x) / np.abs(x)
    assert err.max() <= 2.0 ** -21
    # 1 + 2^-11 lies halfway between two TF32 values: away from zero
    half = np.float32(1 + 2.0 ** -11)
    assert tf32.tf32(half) == np.float32(1 + 2.0 ** -10)
    assert tf32.tf32(-half) == -np.float32(1 + 2.0 ** -10)


def test_3xtf32_product_is_float32_class():
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((64, 64)).astype(np.float32) for _ in range(2))
    exact = a.astype(np.float64) @ b.astype(np.float64)
    three = np.abs(tf32.matmul_3xtf32(a, b) - exact).max()
    one = np.abs(tf32.tf32(a).astype(np.float64) @ tf32.tf32(b) - exact).max()
    f32 = np.abs((a @ b).astype(np.float64) - exact).max()
    assert three <= 4 * f32 and three * 100 < one


@pytest.mark.parametrize("valid", VALIDS)
@pytest.mark.parametrize("d, heads", [(768, 12), (128, 2)])
def test_3xtf32_backward_matches_jax_vjp_of_the_pallas_kernel(d, heads, valid):
    rng = np.random.default_rng(d + valid[0])
    q, k, v, g = (rng.standard_normal((B, S, d)).astype(np.float32) for _ in range(4))
    for i, n in enumerate(valid):
        g[i, n:] = 0.0  # the model's contract: no cotangent past the prefix
    vl = np.asarray(valid, np.int32)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, jnp.asarray(vl), heads, 128, True),
                     *map(jnp.asarray, (q, k, v)))
    ref = np.concatenate([np.asarray(t) for t in vjp(jnp.asarray(g))], axis=-1)
    out, lse = fa.prefix_flash_attention_reference(*map(torch.from_numpy, (q, k, v)),
                                                   torch.from_numpy(vl), heads, return_lse=True)
    got = tf32.attention_backward(q, k, v, out.numpy(), lse.numpy(), g, vl, heads)
    assert got.shape == ref.shape == (B, S, 3 * d)
    for j, name in enumerate(("dq", "dk", "dv")):
        a, r = got[..., j * d:(j + 1) * d], ref[..., j * d:(j + 1) * d]
        assert np.abs(a - r).max() <= TOL * max(1.0, np.abs(r).max()), name
    for i, n in enumerate(valid):  # keys past the prefix: exact zeros in dk and dv
        assert not got[i, n:, d:].any()
