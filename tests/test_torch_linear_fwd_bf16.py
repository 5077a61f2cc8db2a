"""The CUDA route of the bfloat16 forward GEMM steps whose kernels run on the
tensor cores (``csrc/linear_fwd_bf16.cu``: ``ln_linear_fwd_bf16``, K1a,
``linear_relu_fwd_bf16``, K1c, and ``linear_residual_ln_fwd_bf16``, K1b), with
the launch stubbed: the wrappers
check every operand before the launch and raise on one the kernels' 16-byte
copies cannot take (an operand 8 bytes past a 16-byte boundary, a strided
view, S off the 64-row blocks), and they pass the layer chain's own tensors
to the kernels as they are, without a copy. The kernels themselves are held
against their plain versions on the card (``test_torch_kernels_gpu.py``,
``chip_smoke.py``); the plain versions against JAX in
``test_torch_fused_block.py`` and ``test_torch_bf16.py``.
"""

import pytest
import torch

from chadavit_tpu_torch.ops import fused_block
from tests.test_torch_fused_block_backward import fake_cuda  # noqa: F401 (a fixture)

D, F = fused_block.D_MODEL, fused_block.D_FFN
BF16 = torch.bfloat16
VL = torch.tensor([128, 3], dtype=torch.int32)


def _z(*shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype)


def _misaligned(*shape):
    """A contiguous bf16 tensor 8 bytes past a 16-byte boundary."""
    flat = torch.zeros(torch.Size(shape).numel() + 4, dtype=BF16)
    return flat[4:].view(shape)


def _strided(*shape):
    """A bf16 view with every row twice as far apart as its width (a vector:
    every element twice as far apart as its size)."""
    if len(shape) == 1:
        return torch.zeros(2 * shape[0], dtype=BF16)[::2]
    return torch.zeros(*shape[:-1], 2 * shape[-1], dtype=BF16)[..., :shape[-1]]


def _operands(step, k=D, s=128):
    """The operands of one call of ``step`` by name, bf16, B 2."""
    if step == "ln_linear":
        return {"x": _z(2, s, D), "w": _z(3 * D, D), "bias": _z(3 * D),
                "g": _z(D, dtype=torch.float32), "b": _z(D, dtype=torch.float32)}
    if step == "linear_relu":
        return {"x": _z(2, s, D), "w": _z(F, D), "bias": _z(F)}
    return {"a": _z(2, s, k), "w": _z(D, k), "bias": _z(D), "residual": _z(2, s, D),
            "g": _z(D, dtype=torch.float32), "b": _z(D, dtype=torch.float32)}


def _call(step, ops, save=False):
    with torch.no_grad():
        if step == "ln_linear":
            return fused_block.ln_linear(ops["x"], ops["g"], ops["b"], 1e-5, ops["w"],
                                         ops["bias"], VL, save=save)
        if step == "linear_relu":
            return fused_block.linear_relu(ops["x"], ops["w"], ops["bias"], VL)
        return fused_block.linear_residual_ln(ops["a"], ops["w"], ops["bias"], ops["residual"],
                                              ops["g"], ops["b"], 1e-5, VL, save=save)


# (step, K, the operand the kernel copies 16 bytes at a time)
COPIED = [("ln_linear", D, "x"), ("ln_linear", D, "w"), ("ln_linear", D, "bias"),
          ("linear_relu", D, "x"), ("linear_relu", D, "w"),
          ("linear_residual_ln", D, "a"), ("linear_residual_ln", D, "w"),
          ("linear_residual_ln", D, "residual"), ("linear_residual_ln", F, "a"),
          ("linear_residual_ln", F, "w"), ("linear_residual_ln", F, "residual")]


@pytest.mark.parametrize("step, k, name", COPIED)
def test_bf16_refuses_an_operand_off_a_16_byte_boundary(fake_cuda, step, k, name):
    ops = _operands(step, k)
    ops[name] = _misaligned(*ops[name].shape)
    with pytest.raises(ValueError, match=f"{name}: must be aligned to 16 bytes"):
        _call(step, ops)
    assert fake_cuda.calls == []


@pytest.mark.parametrize("step, k, name", COPIED)
def test_bf16_refuses_a_strided_operand(fake_cuda, step, k, name):
    ops = _operands(step, k)
    ops[name] = _strided(*ops[name].shape)
    with pytest.raises(ValueError, match=f"{name}: must be contiguous"):
        _call(step, ops)
    assert fake_cuda.calls == []


@pytest.mark.parametrize("step, k", [("ln_linear", D), ("linear_relu", D),
                                     ("linear_residual_ln", D), ("linear_residual_ln", F)])
def test_bf16_refuses_rows_off_its_64_row_blocks(fake_cuda, step, k):
    with pytest.raises(ValueError, match="multiple of 64"):
        _call(step, _operands(step, k, s=96))
    assert fake_cuda.calls == []
    ops = {n: t.float() for n, t in _operands(step, k, s=96).items()}
    _call(step, ops)  # the float32 kernels take 32-row multiples
    assert fake_cuda.calls == [step + "_fwd"]


@pytest.mark.parametrize("step, k, save", [("ln_linear", D, False), ("ln_linear", D, True),
                                           ("linear_relu", D, False),
                                           ("linear_residual_ln", D, False),
                                           ("linear_residual_ln", D, True),
                                           ("linear_residual_ln", F, False),
                                           ("linear_residual_ln", F, True)])
def test_bf16_hands_its_operands_over_as_they_are(fake_cuda, step, k, save):
    ops = _operands(step, k)
    out = _call(step, ops, save)
    (name,), (args,) = fake_cuda.calls, fake_cuda.args
    assert name == step + "_fwd_bf16"
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.is_contiguous() and o.data_ptr() % 16 == 0 for o in outs)
    if step == "ln_linear":
        assert args[:7] == (ops["x"].data_ptr(), ops["g"].data_ptr(), ops["b"].data_ptr(), 1e-5,
                            ops["w"].data_ptr(), ops["bias"].data_ptr(), outs[0].data_ptr())
        assert args[7:9] == ((outs[1].data_ptr(), outs[2].data_ptr()) if save else (None, None))
        assert outs[0].dtype == BF16 and all(t.dtype == torch.float32 for t in outs[1:])
        assert args[10:14] == (2 * 128, D, 3 * D, 128)
        return
    if step == "linear_relu":
        assert args[:4] == (ops["x"].data_ptr(), ops["w"].data_ptr(), ops["bias"].data_ptr(),
                            out.data_ptr())
        assert args[5:9] == (2 * 128, D, F, 128)
        return
    assert args[:4] == tuple(ops[n].data_ptr() for n in ("a", "w", "bias", "residual"))
    assert args[7] == outs[0].data_ptr()
    if save:
        _, mean, rstd, r = out
        assert args[8:11] == (mean.data_ptr(), rstd.data_ptr(), r.data_ptr())
        assert r.dtype == BF16 and mean.dtype == rstd.dtype == torch.float32
    else:
        assert args[8:11] == (None, None, None)
    assert args[12:16] == (2 * 128, k, D, 128)


@pytest.mark.parametrize("save", [False, True])
def test_bf16_layer_chain_passes_its_own_tensors_to_the_kernels(fake_cuda, save):
    # the chain's intermediates go to the next kernel as they are: x2 into
    # linear_relu and the FFN2 site's residual, hid into the FFN2 site
    d = D
    x = _z(2, 128, d)
    ws = [_z(3 * d, d, dtype=torch.float32), _z(3 * d, dtype=torch.float32),
          _z(d, d, dtype=torch.float32), _z(d, dtype=torch.float32)] + [
        _z(d, dtype=torch.float32) for _ in range(4)] + [
        _z(F, d, dtype=torch.float32), _z(F, dtype=torch.float32),
        _z(d, F, dtype=torch.float32), _z(d, dtype=torch.float32)]
    with torch.no_grad():
        fused_block.layer_forward(fused_block.KERNEL_STEPS, x, VL, tuple(ws), 2, 1e-5, 1e-5,
                                  save=save)
    assert fake_cuda.calls == ["ln_linear_fwd_bf16", "prefix_attention_fwd_bf16",
                               "linear_residual_ln_fwd_bf16", "linear_relu_fwd_bf16",
                               "linear_residual_ln_fwd_bf16"]
    _, _, out_proj, relu, ffn2 = fake_cuda.args
    assert out_proj[3] == x.data_ptr()  # the layer input is site 1's residual
    x2 = out_proj[7]
    assert relu[0] == x2 and ffn2[3] == x2
    assert ffn2[0] == relu[3]
    assert (out_proj[8] is not None) == save and (ffn2[10] is not None) == save
