"""Which kernels the bf16 attention forward and backward and the float32 FFN1
+ ReLU step reach, on the CUDA route with the library stubbed
(``FakeLibrary``). The Python wrappers call one C entry point a step
(``prefix_attention_fwd_bf16``, ``prefix_attention_bwd_bf16``,
``linear_relu_fwd``), which picks the kernel by head width or model width:
each launch is counted under its instance's name, with the C arguments of
its width. The instances the new kernels replaced (the ``mma.sync`` forward
and backward at head 64, ``launch_fwd<64>`` and ``launch_bwd<64>``, and
``linear_relu_kernel`` at D 768) are gone from the sources; which kernels run
at each width, and that head 64 runs no ``mma.sync``, the card shows
(``chip_smoke.py`` phase 1's instances and SASS, and the launch counts of
``tests/test_torch_kernels_gpu.py``).
"""

import re
from pathlib import Path

import pytest
import torch

from chadavit_tpu_torch.ops import _launch, fused_block
from chadavit_tpu_torch.ops import flash_attention as fa
from tests.test_torch_fused_block_backward import fake_cuda  # noqa: F401 (a fixture)

CSRC = Path(__file__).resolve().parent.parent / "chadavit_tpu_torch" / "csrc"


@pytest.mark.parametrize("hd", [32, 64, 96])
def test_bf16_attention_backward_reaches_its_head_width_launch(fake_cuda, hd):
    heads, b, s = 2, 2, 128
    d = heads * hd
    qkv = torch.zeros(b, s, 3 * d, dtype=torch.bfloat16)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    o, do = (torch.zeros(b, s, d, dtype=torch.bfloat16) for _ in range(2))
    lse = torch.zeros(b, heads, s)
    vl = torch.tensor([s, 70], dtype=torch.int32)
    name = fa.instance("prefix_attention_bwd_bf16", hd)
    before = _launch.LAUNCHES[name]
    fa.prefix_attention_bwd(q, k, v, o, lse, do, vl, heads)
    assert fake_cuda.calls == ["prefix_attention_bwd_bf16"]
    assert fake_cuda.args[0][14:18] == (b, heads, hd, s)  # batch, heads, head_dim, s_pad
    assert _launch.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("hd", [32, 64, 96])
def test_bf16_attention_forward_reaches_its_head_width_launch(fake_cuda, hd, with_lse):
    heads, b, s = 2, 2, 128
    d = heads * hd
    qkv = torch.zeros(b, s, 3 * d, dtype=torch.bfloat16)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    vl = torch.tensor([s, 70], dtype=torch.int32)
    name = fa.instance("prefix_attention_fwd_bf16", hd)
    before = _launch.LAUNCHES[name]
    out, lse = fa.attention_forward(q, k, v, vl, heads, with_lse)
    assert fake_cuda.calls == ["prefix_attention_fwd_bf16"]
    args = fake_cuda.args[0]
    assert args[3] == 3 * d and args[6] == d  # ld (the packed rows), ldo
    assert (args[7] is None) == (not with_lse) and (lse is None) == (not with_lse)
    assert args[8:12] == (b, heads, hd, s)  # batch, heads, head_dim, s_pad
    assert args[12] == fa._qscale(hd, torch.bfloat16)
    assert out.shape == (b, s, d) and _launch.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("d", [64, 192, 768])
def test_f32_linear_relu_reaches_its_width_kernel(fake_cuda, d):
    b, s, n = 2, 64, fused_block.WIDTHS[d]
    x, w, bias = torch.zeros(b, s, d), torch.zeros(n, d), torch.zeros(n)
    vl = torch.tensor([s, 33], dtype=torch.int32)
    name = fused_block.instance("linear_relu_fwd", d)
    before = _launch.LAUNCHES[name]
    fused_block.linear_relu(x, w, bias, vl)
    assert fake_cuda.calls == ["linear_relu_fwd"]
    assert fake_cuda.args[0][5:9] == (b * s, d, n, s)  # M, K, N, s_pad
    assert _launch.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("source, gone", [
    ("prefix_attention_bf16.cu", r"launch_bwd<\s*64\s*>"),
    ("prefix_attention_bf16.cu", r"launch_fwd<\s*64\s*>"),
    ("fused_block.cu", r"linear_relu_kernel<\s*(D_WIDE|768)\s*>")])
def test_replaced_instances_are_gone(source, gone):
    assert not re.search(gone, (CSRC / source).read_text())
