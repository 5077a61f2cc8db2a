"""The port's encoder layer at the smoke configs' widths (D 64, 2 heads of 32,
FFN 2048: ``scripts/smoke/{dino,knn,linear}_synthetic.yaml``) held against
the JAX package's fused Pallas layer kernel in interpret mode on the CPU,
forward and ``jax.vjp`` (dx and the 12 parameter gradients), in float32 and
bfloat16. JAX's ``EncoderLayer`` takes that kernel at D 64 at every sequence
the smoke YAMLs make, and so does the port's layer, whose chain has D 64
instances of every step and head-32 instances of the attention; on the CPU
each step runs its plain version, which the kernels are held to on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py`` phase 2d).

B 2, S 256, valid lengths 256 and 100: the JAX kernel's 128-row blocks skip
the second image's last block, and the port's 32-row tiles its last four.
The cotangent is that of sum((y - target)^2) over every row of the 32-row
tiles that hold a valid row (the JAX kernel computes those rows for real
too, so its VJP is the truth there).

Tolerances, those of ``tests/test_torch_fused_block_d768.py``; the readings
on this data on the CPU: float32, the output within 2e-5 absolute on the
valid rows (read: 1.4e-6), the gradients within 1e-4 of their largest entry
(at least 1; read: 4.6e-7). bfloat16 (both packages round at the JAX
kernel's casts but sum in other orders, so a value can land on a
neighbouring bfloat16; on the CPU XLA's excess precision also skips some of
the JAX kernel's casts): per valid row a cosine of at least 0.9999 (read:
1 - 2.1e-5) and a max abs of 4 bfloat16 steps at the row's largest entry
(read: 2); the gradients a cosine of at least 0.995 per tensor (read: 1 -
6.6e-4 on W1, whose gradient moves with each FFN hidden entry whose ReLU
mask the two packages' bfloat16 sums put on opposite sides of 0; the other
tensors 1 - 2.8e-4 or better).

Besides: the port's copy of the JAX gate fuses every sequence of the three
smoke YAMLs at D 64 in both dtypes, as the JAX arithmetic does; the widths
the port's Python names (``fused_block.WIDTHS``,
``flash_attention.HEAD_DIMS``) are the ones the C predicates build; and on
the CUDA route (the launch stubbed) the layer at D 64 takes the chain, its
launches counted under the ``_d64`` and ``_hd32`` instances with the C
arguments of those widths.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.ops import fused_block as jax_fused_block
from chadavit_tpu.ops.fused_block import fused_encoder_block as jax_fused
from chadavit_tpu_torch.config import load_yaml
from chadavit_tpu_torch.models.chada_vit import EncoderLayer
from chadavit_tpu_torch.ops import _launch, fused_block
from chadavit_tpu_torch.ops import flash_attention as fa
from tests.test_torch_fused_block_backward import fake_cuda  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "chadavit_tpu_torch" / "csrc"
B, S, D, H, F = 2, 256, 64, 2, 2048
VALID = [256, 100]
EPS1, EPS2 = 1e-5, 1e-6
F32_ABS, F32_REL = 2e-5, 1e-4
ROW_COS, ROW_STEPS, GRAD_COS = 0.9999, 4, 0.995
NAMES = ["x", "wqkv", "bqkv", "wout", "bout", "g1", "b1", "g2", "b2", "w1", "b1f", "w2",
         "b2f"]
DTYPES = [torch.float32, torch.bfloat16]
SMOKE_YAMLS = ["dino_synthetic.yaml", "knn_synthetic.yaml", "linear_synthetic.yaml"]


def _weights(seed):
    """The 12 layer parameters in nn.Linear layout (out, in), as numpy."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return [n(3 * D, D, scale=D ** -0.5), n(3 * D, scale=0.02),
            n(D, D, scale=D ** -0.5), n(D, scale=0.02),
            1 + n(D, scale=0.1), n(D, scale=0.05), 1 + n(D, scale=0.1), n(D, scale=0.05),
            n(F, D, scale=D ** -0.5), n(F, scale=0.02),
            n(D, F, scale=F ** -0.5), n(D, scale=0.02)]


def _jax_weights(ws):
    """The JAX kernels' (in, out) layout."""
    return [jnp.asarray(w.T.copy() if w.ndim == 2 else w) for w in ws]


def _x(seed, dtype):
    """The layer input, rounded to bfloat16 for the bfloat16 runs (the one
    input both packages take)."""
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _rows():
    """Rows of each image the port computes: its 32-row tiles that hold a valid row."""
    return [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in VALID]


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_d64_layer_forward_matches_jax_fused_kernel(dtype):
    ws, x, vl = _weights(0), _x(1, dtype), np.asarray(VALID, np.int32)
    jdt = getattr(jnp, dtype)
    ref = jax_fused(jnp.asarray(x, jdt), jnp.asarray(vl), *_jax_weights(ws), H, EPS1, EPS2,
                    128, True)
    out = fused_block.fused_encoder_block(torch.from_numpy(x).to(getattr(torch, dtype)),
                                          torch.from_numpy(vl), *map(torch.from_numpy, ws),
                                          H, EPS1, EPS2)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, S, D)
    out, ref = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    for i, n in enumerate(VALID):
        a, b = out[i, :n].astype(np.float64), ref[i, :n].astype(np.float64)
        if dtype == "float32":
            assert np.abs(a - b).max() <= F32_ABS, (i, np.abs(a - b).max())
            continue
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        assert cos.min() >= ROW_COS, (i, cos.min())
        step = 2.0 ** (np.floor(np.log2(np.abs(b).max(-1))) - 7)
        assert (np.abs(a - b).max(-1) <= ROW_STEPS * step).all(), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_d64_layer_vjp_matches_jax_fused_kernel(dtype):
    ws = _weights(2)
    rng = np.random.default_rng(3)
    x = _x(4, dtype)
    tgt = rng.standard_normal((B, S, D)).astype(np.float32)
    vl = np.asarray(VALID, np.int32)
    rows = _rows()
    wrows = np.zeros((B, S, 1), np.float32)
    for i, n in enumerate(rows):
        wrows[i, :n] = 1.0
    jdt = getattr(jnp, dtype)

    def jloss(x_, *w_):
        y = jax_fused(x_, jnp.asarray(vl), *w_, H, EPS1, EPS2, 128, True)
        return jnp.sum((wrows * (y.astype(jnp.float32) - tgt)) ** 2)

    ref = jax.grad(jloss, argnums=tuple(range(13)))(jnp.asarray(x, jdt), *_jax_weights(ws))
    ref = [np.asarray(r.astype(jnp.float32)) for r in ref]
    ref = [r.T if r.ndim == 2 else r for r in ref]
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    wt = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    y = fused_block.fused_encoder_block(xt, torch.from_numpy(vl), *wt, H, EPS1, EPS2)
    loss = ((torch.from_numpy(wrows) * (y.float() - torch.from_numpy(tgt))) ** 2).sum()
    got = torch.autograd.grad(loss, [xt, *wt])
    assert got[0].dtype == getattr(torch, dtype)
    assert all(g.dtype == torch.float32 for g in got[1:])
    got = [g.float().numpy() for g in got]
    dx = np.concatenate([got[0][i, :n] for i, n in enumerate(rows)])
    dx_ref = np.concatenate([ref[0][i, :n] for i, n in enumerate(rows)])
    for name, a, b in zip(NAMES, [dx] + got[1:], [dx_ref] + ref[1:]):
        assert a.shape == b.shape, name
        if dtype == "float32":
            assert np.abs(a - b).max() <= F32_REL * max(1.0, np.abs(b).max()), name
        else:
            assert _cos(a, b) >= GRAD_COS, (name, _cos(a, b))
    for i, n in enumerate(rows):  # the zero-filled tiles get dx = 0
        assert not got[0][i, n:].any()


# ---- the route: every sequence of the smoke YAMLs takes the chain ----------------------
def _smoke_sequences(name):
    """(D, heads, FFN, the sequence widths 1 + patches x channels the YAML's
    crops make for 1 .. its most channels)."""
    cfg = load_yaml(str(ROOT / "scripts" / "smoke" / name))
    kw = cfg["backbone"]["kwargs"]
    augs = cfg.get("augmentations") or [cfg["data"]["augmentations"]]
    crops = {a["crop_size"] for a in augs}
    most = max(kw.get("max_number_channels", 1), cfg["data"].get("max_img_channels", 1))
    seqs = sorted({1 + (c // kw["patch_size"]) ** 2 * n for c in crops
                   for n in range(1, most + 1)})
    return kw["embed_dim"], kw["num_heads"], kw.get("ffn_dim", F), seqs


@pytest.mark.parametrize("dtype", DTYPES)
def test_gate_fuses_every_sequence_of_the_smoke_yamls(dtype):
    itemsize = 4 if dtype == torch.float32 else 2
    seen = []
    for name in SMOKE_YAMLS:
        d, heads, ffn, seqs = _smoke_sequences(name)
        assert (d, heads, ffn) == (D, H, F), name
        for s in seqs:
            blk = jax_fused_block.pick_block(s)
            s_pad = -(-s // blk) * blk
            jax_fits = jax_fused_block.vmem_estimate(s_pad, d, ffn, heads, blk,
                                                     itemsize) <= jax_fused_block.VMEM_BYTES
            assert jax_fits and (d // heads) % 8 == 0, (name, s)  # the JAX layer's choice
            assert fused_block.jax_layer_fused(s, d, ffn, heads, dtype), (name, s)
            seen.append(s)
    assert max(seen) == 17 and min(seen) == 5  # 4 patches a channel, 1-4 channels


def _c_constants(text):
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (\w+) = (\d+);", text)}


def test_python_widths_equal_the_c_predicates():
    common = (CSRC / "gemm_common.cuh").read_text()
    consts = _c_constants(common)
    body = re.search(r"constexpr bool is_width\(int d\) \{(.*?)\}", common, re.S).group(1)
    widths = {consts[n] for n in re.findall(r"d == (\w+)", body)}
    assert widths == set(fused_block.WIDTHS)
    assert {consts["D_FFN"]} == set(fused_block.WIDTHS.values())
    for src in ("attention_f32.cuh", "prefix_attention_bf16.cu"):
        text = (CSRC / src).read_text()
        body = re.search(r"constexpr bool built_head_dim\(int hd\) \{(.*?)\}", text, re.S)
        assert {int(n) for n in re.findall(r"hd == (\d+)", body.group(1))} == set(
            fa.HEAD_DIMS), src


# ---- the CUDA route at D 64, the launch stubbed -----------------------------------------
CHAIN = ["ln_linear_fwd", "prefix_attention_fwd", "linear_residual_ln_fwd", "linear_relu_fwd",
         "linear_residual_ln_fwd"]
CHAIN_BWD = {"layernorm_bwd": 3, "linear_dgrad": 4, "linear_wgrad": 4, "prefix_attention_bwd": 1,
             "ln_linear_fwd": 1, "linear_relu_fwd": 1, "linear_residual_ln_fwd": 1}


def _tag(dtype):
    return "" if dtype == torch.float32 else "_bf16"


def _counted(name, dtype):
    entry = name + _tag(dtype)
    if name.startswith("prefix_attention"):
        return fa.instance(entry, D // H)
    return fused_block.instance(entry, D)


@pytest.mark.parametrize("dtype", DTYPES)
def test_d64_layer_takes_the_chain_and_counts_its_instances(fake_cuda, dtype):
    before = dict(_launch.LAUNCHES)
    layer = EncoderLayer(D, H, F, dtype=dtype)
    x = torch.zeros(2, 128, D, dtype=dtype, requires_grad=True)
    y = layer(x, None, valid_len=torch.tensor([17, 9], dtype=torch.int32))
    assert type(y.grad_fn).__name__ == "FusedEncoderBlockBackward"
    # every step on its own entry point, none of them a wgmma one
    assert fake_cuda.calls == [name + _tag(dtype) for name in CHAIN]
    fwd = fake_cuda.args[1]
    assert (fwd[9], fwd[10]) == (H, 32) and fwd[12] == pytest.approx(fa._qscale(32, dtype))
    y.float().sum().backward()
    backward = fake_cuda.calls[len(CHAIN):]
    assert {n: backward.count(n + _tag(dtype)) for n in CHAIN_BWD} == CHAIN_BWD
    assert len(backward) == sum(CHAIN_BWD.values())
    launched = {k: v - before.get(k, 0) for k, v in _launch.LAUNCHES.items()
                if v != before.get(k, 0)}
    want = {}
    for name in CHAIN:
        want[_counted(name, dtype)] = want.get(_counted(name, dtype), 0) + 1
    for name, n in CHAIN_BWD.items():
        want[_counted(name, dtype)] = want.get(_counted(name, dtype), 0) + n
    assert launched == want
    assert all(k.endswith(("_d64", "_hd32")) for k in launched)
    assert x.grad is not None and layer.self_attn.in_proj_weight.grad is not None


@pytest.mark.parametrize("dtype", DTYPES)
def test_d64_wgrad_and_dgrad_take_the_d64_sites(fake_cuda, dtype):
    bsz, s = 2, 128
    vl = torch.tensor([128, 17], dtype=torch.int32)
    for n, k in sorted(fused_block._WGRAD_SHAPES):
        if min(n, k) != D:
            continue
        z = torch.zeros(bsz, s, dtype=torch.float32)
        ln = (z, z, torch.ones(k), torch.zeros(k)) if n == 3 * k else None
        fused_block.linear_wgrad(torch.zeros(bsz, s, n, dtype=dtype),
                                 torch.zeros(bsz, s, k, dtype=dtype), vl, ln=ln)
        args = fake_cuda.args[-1]
        assert fake_cuda.calls[-1] == _launch.entry_point("linear_wgrad", dtype)
        assert args[-6:-1] == (bsz * s, n, k, s, fused_block.wgrad_splits(bsz, s, n, k, dtype))
    tables = (fused_block.WGRAD_F32_TILES, fused_block.WGRAD_BF16_TILES)
    assert all(min(t[(n, k)]) == D for t in tables for n, k in t if min(n, k) == D)
    for k, n, aux in ((D, F, "relu_of"), (F, D, "residual"), (D, D, None), (3 * D, D, None)):
        dy = torch.zeros(bsz, s, k, dtype=dtype)
        kw = {} if aux is None else {aux: torch.zeros(bsz, s, n, dtype=dtype)}
        fused_block.linear_dgrad(dy, torch.zeros(k, n, dtype=dtype), vl, **kw)
        assert fake_cuda.calls[-1] == _launch.entry_point("linear_dgrad", dtype)
        assert fake_cuda.args[-1][-5:-1] == (bsz * s, k, n, s)


@pytest.mark.parametrize("dtype", DTYPES)
def test_widths_off_the_built_ones_still_raise(fake_cuda, dtype):
    # D 128 (heads of 64 are built; the chain at D 128 is not) and D 96 in 2
    # heads of 48, where the JAX gate says fused
    for d, heads in ((128, 2), (96, 2)):
        assert fused_block.jax_layer_fused(128, d, F, heads, dtype)
        layer = EncoderLayer(d, heads, F, dtype=dtype)
        with pytest.raises(NotImplementedError, match=f"D {d}"):
            layer(torch.zeros(1, 128, d, dtype=dtype),
                  None, valid_len=torch.tensor([100], dtype=torch.int32))
    q = torch.zeros(1, 128, 96, dtype=dtype)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.prefix_flash_attention(q, q, q, torch.tensor([100], dtype=torch.int32), 2)
    assert fake_cuda.calls == []
