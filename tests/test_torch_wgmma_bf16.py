"""The CUDA route of ChAdaViT-B/16's bfloat16 K1a, K1b, K1c, K2b and K2c (D
768), whose kernels are wgmma products fed by TMA
(``csrc/linear_wgmma_bf16.cu``), with the launch stubbed: ``ln_linear``,
``linear_residual_ln``, ``linear_relu``, ``linear_dgrad`` and
``linear_wgrad`` hand the wgmma entry points their operands, the LN1
pre-pass's scratch and the stream-K walk's grid, count the launches under the
D 768 instance names, and leave D 192, D 64 and float32 on their own entry
points. Then the pre-pass's plain version
(``layernorm_rows_reference``): the h of ``ln_linear_reference``, and JAX's
LN1 (``chadavit_tpu/ops/fused_block.py``: ``_stats`` and phase A's h) on the
same seeded numpy inputs; and the order that K1b's LayerNorm row pass keeps
(``tests/torch_bf16_order.py``) against JAX's LayerNorm of a bfloat16 pre-LN
sum r (``_fwd_kernel`` :162-186: ``_stats`` of r in float32, the LN output
rounded to bfloat16). The kernels are held against the plain versions on
the card (``test_torch_kernels_gpu.py``, ``chip_smoke.py`` phase 2c).

Tolerances against JAX, a few times the readings on the CPU: float32 h within
4e-6 absolute (read: 9.5e-7), the row stats within 1e-6 of their largest
entry (read: 2.2e-7); bfloat16 h within one bfloat16 step of its entry (a
float32 difference of an ulp can round to the neighbouring bfloat16; read: 2
of 98 304 entries one step off at D 768, none at D 192). K1b's LayerNorm of
r: the same bounds for its out and row stats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.ops.fused_block import _stats as jax_stats
from chadavit_tpu_torch.ops import _launch, fused_block
from tests import torch_bf16_order as bf16_order
from tests.test_torch_fused_block_backward import fake_cuda  # noqa: F401 (a fixture)

DW, F = fused_block.D_WIDE, fused_block.D_FFN
BF16 = torch.bfloat16
VL = torch.tensor([128, 3], dtype=torch.int32)


def _z(*shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype)


def _ln_operands(d, dtype=BF16, s=128):
    return {"x": _z(2, s, d, dtype=dtype), "w": _z(3 * d, d, dtype=dtype),
            "bias": _z(3 * d, dtype=dtype), "g": _z(d, dtype=torch.float32),
            "b": _z(d, dtype=torch.float32)}


@pytest.mark.parametrize("save", [False, True])
def test_d768_ln_linear_takes_the_wgmma_entry_point(fake_cuda, save):
    ops = _ln_operands(DW)
    before = _launch.LAUNCHES["ln_linear_fwd_bf16_d768"]
    with torch.no_grad():
        out = fused_block.ln_linear(ops["x"], ops["g"], ops["b"], 1e-5, ops["w"], ops["bias"],
                                    VL, save=save)
    (name,), (args,) = fake_cuda.calls, fake_cuda.args
    assert name == "ln_linear_fwd_wgmma_bf16"
    assert _launch.LAUNCHES["ln_linear_fwd_bf16_d768"] == before + 1
    outs = out if save else (out,)
    assert args[:7] == (ops["x"].data_ptr(), ops["g"].data_ptr(), ops["b"].data_ptr(), 1e-5,
                        ops["w"].data_ptr(), ops["bias"].data_ptr(), outs[0].data_ptr())
    assert args[7:9] == ((outs[1].data_ptr(), outs[2].data_ptr()) if save else (None, None))
    # the pre-pass's h: a scratch of its own, which the tensor map of the GEMM reads
    assert args[9] is not None and args[9] not in (ops["x"].data_ptr(), outs[0].data_ptr())
    assert args[10:15] == (VL.data_ptr(), 2 * 128, DW, 3 * DW, 128)
    assert outs[0].shape == (2, 128, 3 * DW) and outs[0].dtype == BF16


@pytest.mark.parametrize("d, dtype, entry", [
    (fused_block.D_MODEL, BF16, "ln_linear_fwd_bf16"),  # D 192: the mma.sync kernel
    (DW, torch.float32, "ln_linear_fwd"),  # float32: the CUDA-core kernels
    (fused_block.D_MODEL, torch.float32, "ln_linear_fwd")])
def test_ln_linear_keeps_its_other_entry_points(fake_cuda, d, dtype, entry):
    # (counted under entry's instance; the float32 D 768 launch goes to
    # ln_linear_fwd_d768, whose LN1 row pass writes h into a scratch of x's
    # shape for its 128-row GEMM)
    ops = _ln_operands(d, dtype)
    with torch.no_grad():
        fused_block.ln_linear(ops["x"], ops["g"], ops["b"], 1e-5, ops["w"], ops["bias"], VL)
    (name,), (args,) = fake_cuda.calls, fake_cuda.args
    if d == DW:
        assert name == "ln_linear_fwd_d768" and len(args) == 16
        assert args[9] is not None and args[9] not in (ops["x"].data_ptr(), args[6])
    else:
        assert name == entry and len(args) == 15  # no scratch
    assert _launch.LAUNCHES[fused_block.instance(entry, d)] > 0


@pytest.mark.parametrize("site", ["qkv", "out", "ffn1", "ffn2"])
def test_d768_wgrad_counts_under_its_instance(fake_cuda, site):
    n, k = {"qkv": (3 * DW, DW), "out": (DW, DW), "ffn1": (F, DW), "ffn2": (DW, F)}[site]
    z = torch.zeros(2, 128, dtype=torch.float32)
    ln = (z, z, torch.ones(k), torch.zeros(k)) if site == "qkv" else None
    before = _launch.LAUNCHES["linear_wgrad_bf16_d768"]
    dw, db = fused_block.linear_wgrad(_z(2, 128, n), _z(2, 128, k), VL, ln=ln)
    assert fake_cuda.calls == ["linear_wgrad_wgmma_bf16"]
    assert _launch.LAUNCHES["linear_wgrad_bf16_d768"] == before + 1
    assert dw.shape == (n, k) and db.shape == (n,) and dw.dtype == db.dtype == torch.float32
    if ln is not None:  # the saved stats and LN1's parameters, as they are
        assert fake_cuda.args[0][2:6] == tuple(t.data_ptr() for t in ln)


def test_d768_layer_chain_takes_the_wgmma_kernels(fake_cuda):
    # the bfloat16 layer at D 768: K1a, K1b and K1c through the wgmma entry
    # points forward, and in the backward their recomputes, the four K2b and
    # the four K2c sites too; K2a and the attention keep theirs
    d = DW
    shapes = [(3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,), (d,), (d,), (F, d), (F,), (d, F),
              (d,)]
    ws = [torch.zeros(sh, requires_grad=True) for sh in shapes]
    x = _z(2, 128, d).requires_grad_(True)
    y = fused_block.fused_encoder_block(x, VL, *ws, 12)
    assert fake_cuda.calls == ["ln_linear_fwd_wgmma_bf16", "prefix_attention_fwd_bf16",
                               "linear_residual_ln_fwd_wgmma_bf16", "linear_relu_fwd_wgmma_bf16",
                               "linear_residual_ln_fwd_wgmma_bf16"]
    forward = len(fake_cuda.calls)
    y.backward(torch.zeros_like(y))
    backward = fake_cuda.calls[forward:]
    assert backward.count("linear_wgrad_wgmma_bf16") == 4 and "linear_wgrad_bf16" not in backward
    assert backward.count("linear_dgrad_wgmma_bf16") == 4 and "linear_dgrad_bf16" not in backward
    assert backward.count("ln_linear_fwd_wgmma_bf16") == 1
    assert backward.count("linear_relu_fwd_wgmma_bf16") == 1
    assert "linear_relu_fwd_bf16" not in backward
    assert backward.count("linear_residual_ln_fwd_wgmma_bf16") == 1
    assert "linear_residual_ln_fwd_bf16" not in backward


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("k", [DW, F])
def test_d768_linear_residual_ln_takes_the_wgmma_entry_point(fake_cuda, k, save):
    # both sites: the GEMM writes r into the saved r or into out, the row pass
    # normalises it; the D 192 kernel's arguments, no scratch
    a, w, bias, res = _z(2, 128, k), _z(DW, k), _z(DW), _z(2, 128, DW)
    g, b = torch.ones(DW), torch.zeros(DW)
    before = _launch.LAUNCHES["linear_residual_ln_fwd_bf16_d768"]
    with torch.no_grad():
        out = fused_block.linear_residual_ln(a, w, bias, res, g, b, 1e-5, VL, save=save)
    (name,), (args,) = fake_cuda.calls, fake_cuda.args
    assert name == "linear_residual_ln_fwd_wgmma_bf16"
    assert _launch.LAUNCHES["linear_residual_ln_fwd_bf16_d768"] == before + 1
    outs = out if save else (out,)
    assert args[:8] == (a.data_ptr(), w.data_ptr(), bias.data_ptr(), res.data_ptr(),
                        g.data_ptr(), b.data_ptr(), 1e-5, outs[0].data_ptr())
    assert args[8:11] == (tuple(t.data_ptr() for t in outs[1:]) if save else (None,) * 3)
    assert args[11:] == (VL.data_ptr(), 2 * 128, k, DW, 128, 0)
    assert outs[0].shape == (2, 128, DW) and outs[0].dtype == BF16


@pytest.mark.parametrize("d, dtype, entry", [
    (fused_block.D_MODEL, BF16, "linear_residual_ln_fwd_bf16"),  # D 192: mma.sync
    (fused_block.D_SMALL, BF16, "linear_residual_ln_fwd_bf16"),  # D 64: mma.sync
    (DW, torch.float32, "linear_residual_ln_fwd")])  # float32: the 128-row GEMM
def test_linear_residual_ln_keeps_its_other_entry_points(fake_cuda, d, dtype, entry):
    with torch.no_grad():
        fused_block.linear_residual_ln(_z(2, 128, d, dtype=dtype), _z(d, d, dtype=dtype),
                                       _z(d, dtype=dtype), _z(2, 128, d, dtype=dtype),
                                       torch.ones(d), torch.zeros(d), 1e-5, VL)
    assert fake_cuda.calls == [entry]
    assert _launch.LAUNCHES[fused_block.instance(entry, d)] > 0


def test_d768_linear_relu_takes_the_wgmma_entry_point(fake_cuda):
    x, w, bias = _z(2, 128, DW), _z(F, DW), _z(F)
    before = _launch.LAUNCHES["linear_relu_fwd_bf16_d768"]
    with torch.no_grad():
        out = fused_block.linear_relu(x, w, bias, VL)
    (name,), (args,) = fake_cuda.calls, fake_cuda.args
    assert name == "linear_relu_fwd_wgmma_bf16"
    assert _launch.LAUNCHES["linear_relu_fwd_bf16_d768"] == before + 1
    # the D 192 kernel's arguments: no scratch, the kernel writes the zero tiles
    assert args == (x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), VL.data_ptr(),
                    2 * 128, DW, F, 128, 0)
    assert out.shape == (2, 128, F) and out.dtype == BF16


DGRAD_SITES = {"ffn2": (DW, F, "relu_of", 1), "ffn1": (F, DW, "residual", 2),
               "out": (DW, DW, None, 0), "qkv": (3 * DW, DW, None, 0)}


@pytest.mark.parametrize("site", list(DGRAD_SITES))
def test_d768_dgrad_takes_the_wgmma_entry_point(fake_cuda, site):
    k, n, aux, epilogue = DGRAD_SITES[site]
    dy, w = _z(2, 128, k), _z(k, n)
    kw = {} if aux is None else {aux: _z(2, 128, n)}
    before = _launch.LAUNCHES["linear_dgrad_bf16_d768"]
    out = fused_block.linear_dgrad(dy, w, VL, **kw)
    (name,), (args,) = fake_cuda.calls, fake_cuda.args
    assert name == "linear_dgrad_wgmma_bf16"
    assert _launch.LAUNCHES["linear_dgrad_bf16_d768"] == before + 1
    aux_ptr = None if aux is None else kw[aux].data_ptr()
    assert args == (dy.data_ptr(), w.data_ptr(), aux_ptr, out.data_ptr(), epilogue,
                    VL.data_ptr(), 2 * 128, k, n, 128, 0)
    assert out.shape == (2, 128, n) and out.dtype == BF16


@pytest.mark.parametrize("d, dtype, entry", [
    (fused_block.D_MODEL, BF16, "_bf16"),  # D 192: the mma.sync kernels
    (DW, torch.float32, ""),  # float32: the CUDA-core kernels
    (fused_block.D_MODEL, torch.float32, "")])
@pytest.mark.parametrize("step", ["linear_relu", "linear_dgrad"])
def test_linear_relu_and_dgrad_keep_their_other_entry_points(fake_cuda, d, dtype, entry, step):
    if step == "linear_relu":
        with torch.no_grad():
            fused_block.linear_relu(_z(2, 128, d, dtype=dtype), _z(F, d, dtype=dtype),
                                    _z(F, dtype=dtype), VL)
        want = call = "linear_relu_fwd" + entry
    else:
        fused_block.linear_dgrad(_z(2, 128, 3 * d, dtype=dtype), _z(3 * d, d, dtype=dtype), VL)
        want = call = "linear_dgrad" + entry
        if (d, dtype) == (DW, torch.float32):  # the float32 D 768 data gradient: its walk
            call = "linear_dgrad_d768"
    assert fake_cuda.calls == [call]
    assert _launch.LAUNCHES[fused_block.instance(want, d)] > 0


def test_layernorm_rows_passes_the_stats_in_or_out(fake_cuda):
    x, g, b = _z(2, 128, DW), torch.ones(DW), torch.zeros(DW)
    h, mean, rstd = fused_block.layernorm_rows(x, g, b, VL)
    stats = (torch.zeros(2, 128), torch.ones(2, 128))
    h2, mean2, rstd2 = fused_block.layernorm_rows(x, g, b, VL, stats=stats)
    (taken, given) = fake_cuda.args
    assert fake_cuda.calls == ["ln_rows_bf16", "ln_rows_bf16"]
    assert taken[4:9] == (None, None, h.data_ptr(), mean.data_ptr(), rstd.data_ptr())
    assert given[4:9] == (stats[0].data_ptr(), stats[1].data_ptr(), h2.data_ptr(), None, None)
    assert mean2 is stats[0] and rstd2 is stats[1]
    assert taken[10:13] == given[10:13] == (2 * 128, DW, 128)


def _inputs(seed, bsz, s, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, d)).astype(np.float32) * 2 + 0.5
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.05 * rng.standard_normal(d)).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("d", [fused_block.D_MODEL, DW])
def test_layernorm_rows_reference_is_ln_linears_h(d, dtype):
    # the identity weight and a zero bias turn ln_linear_reference into its h
    x, g, b = (torch.from_numpy(a) for a in _inputs(3, 3, 96, d))
    x = x.to(dtype)
    vl = torch.tensor([96, 33, 0], dtype=torch.int32)
    h, mean, rstd = fused_block.layernorm_rows_reference(x, g, b, vl)
    eye, zero = torch.eye(d, dtype=dtype), torch.zeros(d, dtype=dtype)
    ref, mu, rs = fused_block.ln_linear_reference(x, g, b, 1e-5, eye, zero, save=True)
    ok = fused_block.computed_rows(x, vl)
    assert h.dtype == dtype and torch.equal(h, torch.where(ok, ref, 0.0).to(dtype))
    assert torch.equal(mean, torch.where(ok[..., 0], mu, 0.0))
    assert torch.equal(rstd, torch.where(ok[..., 0], rs, 0.0))
    # the backward's pre-pass, from the saved stats: the same h
    h2, *_ = fused_block.layernorm_rows_reference(x, g, b, vl, stats=(mu, rs))
    assert torch.equal(h2, h)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("d", [fused_block.D_MODEL, DW])
def test_layernorm_rows_reference_matches_jax_ln1(d, dtype):
    x, g, b = _inputs(7, 2, 64, d)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    xf = xj.astype(jnp.float32)
    mu, rstd = jax_stats(xf, 1e-5)
    hj = np.asarray(((xf - mu) * rstd * jnp.asarray(g) + jnp.asarray(b)).astype(jdt)
                    .astype(jnp.float32))
    xt = torch.from_numpy(np.array(xf)).to(dtype)
    vl = torch.tensor([64, 64], dtype=torch.int32)
    h, mean, rs = fused_block.layernorm_rows_reference(xt, torch.from_numpy(g),
                                                       torch.from_numpy(b), vl)
    for ours, ref in ((mean, np.asarray(mu)[..., 0]), (rs, np.asarray(rstd)[..., 0])):
        assert np.abs(ours.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    diff = np.abs(h.float().numpy() - hj)
    if dtype == torch.float32:
        assert diff.max() <= 4e-6, diff.max()
    else:
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(hj), 1e-30))) - 7)
        assert (diff <= step).all(), (diff / step).max()


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_k1b_layernorm_order_matches_jax_ln_of_a_bf16_r(eps):
    # a bfloat16 pre-LN sum r (JAX: r = x + o in bfloat16), its LayerNorm in
    # float32 as JAX takes it (rf = r.astype(f32), _stats, (rf - mu) rstd g +
    # b rounded to bfloat16), against the order K1b's row pass keeps, with
    # zeros on the 32-row tiles past the prefix
    rng = np.random.default_rng(9)
    r = (rng.standard_normal((2, 96, DW)) * 2 + 0.3).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(DW)).astype(np.float32)
    b = (0.05 * rng.standard_normal(DW)).astype(np.float32)
    rj = jnp.asarray(r).astype(jnp.bfloat16)
    rf = rj.astype(jnp.float32)
    mu, rstd = jax_stats(rf, eps)
    yj = np.asarray(((rf - mu) * rstd * jnp.asarray(g) + jnp.asarray(b)).astype(jnp.bfloat16)
                    .astype(jnp.float32))
    valid = [96, 33]
    rt = torch.from_numpy(np.array(rf)).to(BF16)
    out, mean, rs = bf16_order.residual_ln_rows_order(rt, torch.from_numpy(g),
                                                      torch.from_numpy(b), eps, valid)
    assert out.dtype == BF16 and mean.dtype == rs.dtype == torch.float32
    rows = [96, 64]  # the rows of the computed 32-row tiles
    for i, n in enumerate(rows):
        for ours, ref in ((mean[i, :n], np.asarray(mu)[i, :n, 0]),
                          (rs[i, :n], np.asarray(rstd)[i, :n, 0])):
            assert np.abs(ours.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
        diff = np.abs(out[i, :n].float().numpy() - yj[i, :n])
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(yj[i, :n]), 1e-30))) - 7)
        assert (diff <= step).all(), (diff / step).max()
        assert not out[i, n:].any() and not mean[i, n:].any() and not rs[i, n:].any()
