"""The port's prefix attention (chadavit_tpu_torch/ops/flash_attention.py and
ops/attention.py) held against the JAX package on the CPU: the Pallas kernel
run in interpret mode, and the XLA masked attention.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against that plain version on the card (test_torch_kernels_gpu.py,
chip_smoke.py). Tolerance: both sides compute in float32, so 2e-5 absolute
and relative covers the different summation orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.ops.attention import xla_masked_attention as jax_xla_attention
from chadavit_tpu.ops.flash_attention import prefix_flash_attention as jax_flash
from chadavit_tpu_torch.ops import attention, flash_attention

B, S, D, H = 4, 256, 32, 2
VALID = [256, 200, 37, 1]  # a full, two partial and a single-token prefix
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed=0, d=D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, d)).astype(np.float32) for _ in range(3))
    return q, k, v, np.asarray(VALID, np.int32)


def _assert_valid_rows_close(out, ref, valid, **tol):
    for i, n in enumerate(valid):
        np.testing.assert_allclose(np.asarray(out)[i, :n], np.asarray(ref)[i, :n], **tol)


@pytest.mark.parametrize("num_heads", [1, 2])
def test_matches_jax_pallas_interpret(num_heads):
    q, k, v, vl = _inputs()
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl),
                    num_heads, 128, True)
    out = flash_attention.prefix_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(vl), num_heads)
    _assert_valid_rows_close(out.numpy(), ref, vl, **TOL)


def test_matches_jax_xla_masked_attention():
    q, k, v, vl = _inputs(1)
    mask = np.arange(S)[None, :] >= vl[:, None]
    ref, _ = jax_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), H)
    out = flash_attention.prefix_flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(vl), H)
    _assert_valid_rows_close(out.numpy(), ref, vl, **TOL)


def test_plain_masked_attention_and_weights_match_jax():
    q, k, v, vl = _inputs(2)
    mask = np.arange(S)[None, :] >= vl[:, None]
    ref, ref_w = jax_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(mask), H, return_weights=True)
    out, w = attention.xla_masked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), H, return_weights=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), **TOL)


def test_dispatch_takes_the_prefix_path_and_its_plain_version_on_cpu():
    q, k, v, vl = _inputs(3)
    tq, tk, tv, tvl = map(torch.from_numpy, (q, k, v, vl))
    mask = torch.arange(S)[None, :] >= tvl[:, None]
    before = flash_attention.prefix_flash_attention.launches
    out, w = attention.masked_multihead_attention(tq, tk, tv, mask, H, valid_len=tvl)
    assert w is None
    assert flash_attention.prefix_flash_attention.launches == before  # no kernel on CPU
    ref, _ = attention.masked_multihead_attention(tq, tk, tv, mask, H, impl="xla")
    _assert_valid_rows_close(out.numpy(), ref.numpy(), vl, **TOL)
    with pytest.raises(ValueError):
        attention.masked_multihead_attention(tq, tk, tv, mask, H, impl="pallas")


def test_wrapper_refuses_devices_other_than_cpu_and_cuda():
    q = torch.empty((1, 64, D), device="meta")
    vl = torch.ones((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        flash_attention.prefix_flash_attention(q, q, q, vl, H)
