"""Each CUDA kernel of chadavit_tpu_torch against its plain PyTorch version,
on the card, at the widths of ChAdaViT-moyen (D 192, 2 heads of 96, FFN 2048)
with ragged prefixes (single-token, partial and full, row tiles past the
prefix). Marked ``gpu``; skips without a CUDA
device. It imports no JAX, so on the card's machine it runs without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerance: float32 on both sides, 1e-4 absolute on the rows < valid_len.
"""

import numpy as np
import pytest
import torch

from chadavit_tpu_torch.ops import fused_block
from chadavit_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, dev, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


def _assert_valid_rows_close(out, ref, valid):
    torch.cuda.synchronize()
    for i, n in enumerate(valid):
        err = (out[i, :n] - ref[i, :n]).abs().max().item()
        assert err <= TOL, (i, n, err)


D, HEADS, F = fused_block.D_MODEL, 2, fused_block.D_FFN
VALIDS = [[256, 200, 65, 1], [1, 97, 129, 255], [197, 589, 33, 64]]


@pytest.mark.parametrize("valid", VALIDS)
def test_prefix_attention(dev, valid):
    rng = np.random.default_rng(sum(valid))
    s = max(256, -(-max(valid) // 64) * 64)
    qkv = _randn(rng, dev, len(valid), s, 3 * D)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    before = fa.prefix_flash_attention.launches
    out = fa.prefix_flash_attention(q, k, v, vl, HEADS)
    assert fa.prefix_flash_attention.launches == before + 1
    _assert_valid_rows_close(out, fa.prefix_flash_attention_reference(q, k, v, vl, HEADS), valid)
    # query blocks wholly past the prefix are written as zeros
    for i, n in enumerate(valid):
        assert not out[i, -(-n // 64) * 64:].any().item()


@pytest.mark.parametrize("valid", VALIDS)
def test_gemm_steps_and_chain(dev, valid):
    rng = np.random.default_rng(sum(valid))
    s = -(-max(valid) // 128) * 128
    x = _randn(rng, dev, len(valid), s, D)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    w = [_randn(rng, dev, 3 * D, D, scale=D ** -0.5), _randn(rng, dev, 3 * D, scale=0.1),
         _randn(rng, dev, D, D, scale=D ** -0.5), _randn(rng, dev, D, scale=0.1),
         1 + _randn(rng, dev, D, scale=0.1), _randn(rng, dev, D, scale=0.1),
         1 + _randn(rng, dev, D, scale=0.1), _randn(rng, dev, D, scale=0.1),
         _randn(rng, dev, F, D, scale=D ** -0.5), _randn(rng, dev, F, scale=0.1),
         _randn(rng, dev, D, F, scale=F ** -0.5), _randn(rng, dev, D, scale=0.1)]
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = w
    _assert_valid_rows_close(fused_block.ln_linear(x, g1, b1, 1e-5, wqkv, bqkv, vl),
                             fused_block.ln_linear_reference(x, g1, b1, 1e-5, wqkv, bqkv), valid)
    hid = fused_block.linear_relu(x, w1, b1f, vl)
    _assert_valid_rows_close(hid, fused_block.linear_relu_reference(x, w1, b1f), valid)
    _assert_valid_rows_close(
        fused_block.linear_residual_ln(hid, w2, b2f, x, g2, b2, 1e-6, vl),
        fused_block.linear_residual_ln_reference(hid, w2, b2f, x, g2, b2, 1e-6), valid)
    _assert_valid_rows_close(
        fused_block.linear_residual_ln(x, wout, bout, x, g1, b1, 1e-5, vl),
        fused_block.linear_residual_ln_reference(x, wout, bout, x, g1, b1, 1e-5), valid)
    out = fused_block.fused_encoder_block(x, vl, *w, HEADS)
    _assert_valid_rows_close(
        out, fused_block.fused_encoder_block_reference(x, vl, *w, HEADS), valid)
    # row tiles wholly past the prefix are zero
    for i, n in enumerate(valid):
        assert not out[i, -(-n // 32) * 32:].any().item()


def test_wrappers_refuse_other_dtypes(dev):
    x = torch.zeros((1, 64, D), dtype=torch.float16, device=dev)
    vl = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        fa.prefix_flash_attention(x, x, x, vl, HEADS)


def test_wrappers_refuse_other_widths(dev):
    x = torch.zeros((1, 64, 64), device=dev)
    vl = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        fa.prefix_flash_attention(x, x, x, vl, 2)  # head width 32
    with pytest.raises(ValueError):
        fused_block.linear_relu(x, torch.zeros((128, 64), device=dev),
                                torch.zeros((128,), device=dev), vl)
