"""The gradient of the port's encoder layer (chadavit_tpu_torch/ops/
fused_block.py: FusedEncoderBlock and its backward chain) held against the
JAX package on the CPU: ``jax.vjp`` of the fused Pallas layer in interpret
mode (its custom VJP, the TPU backward kernel), ``jax.vjp`` of one unfused JAX
EncoderLayer (block_impl="xla"), and torch autograd through the plain
forward. The cotangent is zero on rows past ``valid_len``, as the model's
(it reads only CLS): dx on the valid rows and all 12 parameter gradients
must agree, and dx past ``valid_len`` must be zero. A cotangent on the tail
rows the forward computes is tested in tests/test_torch_bf16.py.

On the CPU each step of the chain runs its plain version; the CUDA kernels
are held against those on the card (test_torch_kernels_gpu.py,
chip_smoke.py). The CUDA route is driven here with the launch stubbed: with
grad on the layer is the Function and its backward launches the backward
kernels; the forward-only step wrappers raise instead of handing back a
detached tensor; the backward wrappers refuse the widths their kernels are
not built for and reach the launch at D 192, head 96, FFN 2048.

Tolerance: float32 on both sides, through two LayerNorms and the FFN: a
max abs error of 1e-4 times the gradient's largest entry (at least 1).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.models.chada_vit import EncoderLayer as JaxEncoderLayer
from chadavit_tpu.ops.fused_block import fused_encoder_block as jax_fused
from chadavit_tpu_torch.models.chada_vit import EncoderLayer as PortEncoderLayer
from chadavit_tpu_torch.ops import _build, _launch, flash_attention, fused_block

B, S, D, H, F = 3, 256, 32, 2, 64
VALID = [256, 130, 60]  # 60 < 128 leaves a whole sequence block to skip
EPS1, EPS2 = 1e-5, 1e-6
REL = 1e-4
NAMES = ["wqkv", "bqkv", "wout", "bout", "g1", "b1", "g2", "b2", "w1", "b1f", "w2", "b2f"]


def _weights(seed=0):
    """The 12 layer parameters in nn.Linear layout (out, in), as numpy."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return [n(3 * D, D, scale=D ** -0.5), n(3 * D, scale=0.1),
            n(D, D, scale=D ** -0.5), n(D, scale=0.1),
            1 + n(D, scale=0.1), n(D, scale=0.1), 1 + n(D, scale=0.1), n(D, scale=0.1),
            n(F, D, scale=D ** -0.5), n(F, scale=0.1),
            n(D, F, scale=F ** -0.5), n(D, scale=0.1)]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x, g = (rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(2))
    for i, n in enumerate(VALID):
        g[i, n:] = 0.0
    return x, g, np.asarray(VALID, np.int32)


def _t(a):
    """JAX layout (in, out) of a matrix gradient -> nn.Linear (out, in)."""
    a = np.asarray(a)
    return a.T if a.ndim == 2 else a


def _port_grads(x, g, vl, ws, layer, eps2=EPS2):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    y = layer(xt, torch.from_numpy(vl), *wt, H, EPS1, eps2)
    return y, [gr.numpy() for gr in torch.autograd.grad(y, [xt, *wt], torch.from_numpy(g))]


def _assert_grads_close(got, want):
    dx, dx_ref = got[0], np.asarray(want[0])
    for i, n in enumerate(VALID):
        scale = max(1.0, np.abs(dx_ref[i, :n]).max())
        assert np.abs(dx[i, :n] - dx_ref[i, :n]).max() <= REL * scale, ("dx", i)
    for name, a, b in zip(NAMES, got[1:], want[1:]):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= REL * max(1.0, np.abs(b).max()), name


def test_matches_jax_vjp_of_the_fused_pallas_layer():
    ws, (x, g, vl) = _weights(), _inputs(1)
    jw = [w.T.copy() if w.ndim == 2 else w for w in ws]
    _, vjp = jax.vjp(lambda x_, *w_: jax_fused(x_, jnp.asarray(vl), *w_, H, EPS1, EPS2, 128, True),
                     jnp.asarray(x), *map(jnp.asarray, jw))
    ref = [_t(r) for r in vjp(jnp.asarray(g))]
    y, got = _port_grads(x, g, vl, ws, fused_block.fused_encoder_block)
    assert type(y.grad_fn).__name__ == "FusedEncoderBlockBackward"
    _assert_grads_close(got, ref)


def test_matches_jax_vjp_of_the_unfused_encoder_layer():
    ws, (x, g, vl) = _weights(2), _inputs(3)
    (wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f) = \
        [w.T.copy() if w.ndim == 2 else w for w in ws]
    params = {"in_proj_kernel": wqkv, "in_proj_bias": bqkv,
              "out_proj_kernel": wout, "out_proj_bias": bout,
              "norm1": {"scale": g1, "bias": b1}, "norm2": {"scale": g2, "bias": b2},
              "linear1": {"kernel": w1, "bias": b1f}, "linear2": {"kernel": w2, "bias": b2f}}
    layer = JaxEncoderLayer(embed_dim=D, num_heads=H, ffn_dim=F, layer_norm_eps=EPS1,
                            attn_impl="xla", block_impl="xla")
    mask = jnp.asarray(np.arange(S)[None, :] >= vl[:, None])

    def f(x_, p_):
        return layer.apply({"params": p_}, x_, mask, valid_len=jnp.asarray(vl))

    _, vjp = jax.vjp(f, jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, params))
    dx, dp = vjp(jnp.asarray(g))
    ref = [dx, _t(dp["in_proj_kernel"]), dp["in_proj_bias"], _t(dp["out_proj_kernel"]),
           dp["out_proj_bias"], dp["norm1"]["scale"], dp["norm1"]["bias"],
           dp["norm2"]["scale"], dp["norm2"]["bias"], _t(dp["linear1"]["kernel"]),
           dp["linear1"]["bias"], _t(dp["linear2"]["kernel"]), dp["linear2"]["bias"]]
    # the JAX layer uses one eps for both norms
    _, got = _port_grads(x, g, vl, ws, fused_block.fused_encoder_block, eps2=EPS1)
    _assert_grads_close(got, ref)


def test_matches_autograd_of_the_plain_forward_and_is_zero_past_the_prefix():
    ws, (x, g, vl) = _weights(4), _inputs(5)
    _, got = _port_grads(x, g, vl, ws, fused_block.fused_encoder_block)
    _, ref = _port_grads(x, g, vl, ws, fused_block.fused_encoder_block_reference)
    _assert_grads_close(got, ref)
    for i, n in enumerate(VALID):
        assert not got[0][i, n:].any()


def test_backward_reference_is_the_functions_backward():
    # fused_encoder_block_backward_reference on the Function's residuals gives
    # what the Function's backward gives (plain steps on both sides on the CPU)
    ws, (x, g, vl) = _weights(6), _inputs(7)
    wt = tuple(map(torch.from_numpy, ws))
    xt, vt = torch.from_numpy(x), torch.from_numpy(vl)
    _, (attn, x2, r2, lse, stats) = fused_block.layer_forward(
        fused_block.PLAIN_STEPS, xt, vt, wt, H, EPS1, EPS2, save=True)
    ref = fused_block.fused_encoder_block_backward_reference(
        torch.from_numpy(g), xt, vt, attn, x2, r2, lse, stats, wt, H, EPS1)
    _, got = _port_grads(x, g, vl, ws, fused_block.fused_encoder_block)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b.reshape(a.shape).numpy())


def test_unfused_port_layer_trains_through_the_attention_function():
    # block_impl="xla" runs the plain layer, whose attention is the Function
    torch.manual_seed(0)
    layer = PortEncoderLayer(D, H, F, EPS1, block_impl="xla")
    x, g, vl = _inputs(8)
    out = layer(torch.from_numpy(x), None, valid_len=torch.from_numpy(vl))
    names, seen, stack = set(), set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and id(fn) not in seen:
            seen.add(id(fn))
            names.add(type(fn).__name__)
            stack.extend(f for f, _ in fn.next_functions)
    assert "PrefixFlashAttentionBackward" in names
    out.backward(torch.from_numpy(g))
    assert layer.self_attn.in_proj_weight.grad.abs().sum() > 0


# ---- the CUDA route, with the launch stubbed --------------------------------
class FakeLibrary:
    """Stands in for the kernel library: every launch succeeds, writes
    nothing and is recorded by name (``calls``) and with its arguments
    (``args``)."""

    def __init__(self):
        self.calls, self.args = [], []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            self.args.append(args)
            return 0
        return launch


class KernelReached(Exception):
    pass


@pytest.fixture
def fake_cuda(monkeypatch):
    lib = FakeLibrary()
    monkeypatch.setattr(_launch, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(_launch, "stream", lambda device: 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    return lib


@pytest.fixture
def cuda_route(monkeypatch):
    """Every check before a launch runs; reaching the launch raises."""
    def library():
        raise KernelReached
    monkeypatch.setattr(_launch, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(_build, "library", library)


def _z(*shape, requires_grad=False):
    return torch.zeros(shape, requires_grad=requires_grad)


def _served_weights(requires_grad):
    d, f = fused_block.D_MODEL, fused_block.D_FFN
    return [_z(3 * d, d), _z(3 * d), _z(d, d), _z(d), _z(d), _z(d), _z(d), _z(d),
            _z(f, d), _z(f), _z(d, f), _z(d)] if not requires_grad else [
        t.requires_grad_(True) for t in _served_weights(False)]


def test_cuda_route_with_grad_is_the_function_and_its_backward_launches(fake_cuda):
    ws = _served_weights(True)
    x = _z(2, 128, fused_block.D_MODEL, requires_grad=True)
    vl = torch.tensor([128, 3], dtype=torch.int32)
    y = fused_block.fused_encoder_block(x, vl, *ws, 2)
    assert type(y.grad_fn).__name__ == "FusedEncoderBlockBackward"
    forward = ["ln_linear_fwd", "prefix_attention_fwd", "linear_residual_ln_fwd",
               "linear_relu_fwd", "linear_residual_ln_fwd"]
    assert fake_cuda.calls == forward
    y.backward(torch.zeros_like(y))
    backward = fake_cuda.calls[len(forward):]
    assert sorted(set(backward)) == ["layernorm_bwd", "linear_dgrad", "linear_relu_fwd",
                                     "linear_residual_ln_fwd", "linear_wgrad", "ln_linear_fwd",
                                     "prefix_attention_bwd"]
    assert [backward.count(k) for k in ("layernorm_bwd", "linear_dgrad", "linear_wgrad",
                                        "prefix_attention_bwd")] == [3, 4, 4, 1]
    assert all(w.grad is not None and w.grad.shape == w.shape for w in ws)
    assert x.grad is not None and x.grad.shape == x.shape


def test_cuda_route_without_grad_takes_the_save_free_chain(fake_cuda):
    ws = _served_weights(True)
    with torch.no_grad():  # the teacher
        y = fused_block.fused_encoder_block(_z(2, 128, fused_block.D_MODEL), torch.tensor(
            [128, 3], dtype=torch.int32), *ws, 2)
    assert y.grad_fn is None
    assert fake_cuda.calls == ["ln_linear_fwd", "prefix_attention_fwd", "linear_residual_ln_fwd",
                               "linear_relu_fwd", "linear_residual_ln_fwd"]


def _step_calls(d, f, requires_grad):
    x = _z(2, 64, d, requires_grad=requires_grad)
    vl = torch.tensor([64, 3], dtype=torch.int32)
    ws = [_z(*w.shape, requires_grad=requires_grad) for w in
          [_z(3 * d, d), _z(3 * d), _z(d), _z(d), _z(f, d), _z(f), _z(d, f), _z(d)]]
    wqkv, bqkv, g, b, w1, b1f, w2, b2f = ws
    return {
        "ln_linear": lambda: fused_block.ln_linear(x, g, b, EPS1, wqkv, bqkv, vl),
        "linear_relu": lambda: fused_block.linear_relu(x, w1, b1f, vl),
        "linear_residual_ln": lambda: fused_block.linear_residual_ln(
            _z(2, 64, f), w2, b2f, x, g, b, EPS2, vl),
    }


@pytest.mark.parametrize("step", ["ln_linear", "linear_relu", "linear_residual_ln"])
@pytest.mark.parametrize("route", ["cpu", "cuda"])
def test_forward_only_steps_raise_rather_than_detach(request, route, step):
    if route == "cuda":
        request.getfixturevalue("fake_cuda")
    call = _step_calls(fused_block.D_MODEL, fused_block.D_FFN, True)[step]
    with pytest.raises(RuntimeError, match="no gradient"):
        call()
    with torch.no_grad():
        call()  # the same call without grad runs


def _bwd_calls(d, f, hd):
    """One call of each backward wrapper at widths d, f and head width hd."""
    bsz, s = 2, 128
    vl = torch.tensor([128, 3], dtype=torch.int32)
    a, stats = _z(bsz, s, d), _z(bsz, s)
    calls = {
        "layernorm_bwd": lambda: fused_block.layernorm_bwd(a, a, stats, stats, _z(d), vl,
                                                           residual=a),
        "dgrad_ffn1": lambda: fused_block.linear_dgrad(a, _z(d, f), vl,
                                                       relu_of=_z(bsz, s, f)),
        "dgrad_ffn2": lambda: fused_block.linear_dgrad(_z(bsz, s, f), _z(f, d), vl,
                                                       residual=a),
        "dgrad_out": lambda: fused_block.linear_dgrad(a, _z(d, d), vl),
        "dgrad_qkv": lambda: fused_block.linear_dgrad(_z(bsz, s, 3 * d), _z(3 * d, d), vl),
        "wgrad_qkv": lambda: fused_block.linear_wgrad(_z(bsz, s, 3 * d), a, vl,
                                                      ln=(stats, stats, _z(d), _z(d))),
        "wgrad_out": lambda: fused_block.linear_wgrad(a, a, vl),
        "wgrad_ffn1": lambda: fused_block.linear_wgrad(_z(bsz, s, f), a, vl),
        "wgrad_ffn2": lambda: fused_block.linear_wgrad(a, _z(bsz, s, f), vl),
        "prefix_attention_bwd": lambda: flash_attention.prefix_attention_bwd(
            a, a, a, a, _z(bsz, d // hd, s), a, vl, d // hd),
    }
    return calls


BWD = ["layernorm_bwd", "dgrad_ffn1", "dgrad_ffn2", "dgrad_out", "dgrad_qkv", "wgrad_qkv",
       "wgrad_out", "wgrad_ffn1", "wgrad_ffn2", "prefix_attention_bwd"]


@pytest.mark.parametrize("call", BWD)
def test_cuda_route_backward_refuses_widths_the_kernels_are_not_built_for(cuda_route, call):
    with pytest.raises(ValueError):
        _bwd_calls(D, F, D // H)[call]()


@pytest.mark.parametrize("call", BWD)
def test_cuda_route_backward_launches_at_the_served_widths(cuda_route, call):
    with pytest.raises(KernelReached):
        _bwd_calls(fused_block.D_MODEL, fused_block.D_FFN, flash_attention.HEAD_DIM)[call]()


def test_cuda_route_needs_valid_len(fake_cuda):
    d = fused_block.D_MODEL
    with pytest.raises(ValueError, match="valid_len"):
        fused_block.layernorm_bwd(_z(2, 128, d), _z(2, 128, d), _z(2, 128), _z(2, 128),
                                  _z(d), None)
    assert fake_cuda.calls == []


def test_dgrad_takes_one_epilogue(cuda_route):
    d, f = fused_block.D_MODEL, fused_block.D_FFN
    with pytest.raises(ValueError, match="one epilogue"):
        fused_block.linear_dgrad(_z(2, 128, d), _z(d, f), torch.tensor([128, 3], dtype=torch.int32),
                                 relu_of=_z(2, 128, f), residual=_z(2, 128, f))


# ---- the split plan of linear_wgrad (both dtypes) ------------------------------
def _computed_tiles(valid_len, s_pad):
    rb = fused_block.ROW_BLOCK
    return [b * s_pad + t for b, n in enumerate(valid_len) for t in range(0, s_pad, rb)
            if t < n]


@pytest.mark.parametrize("s_pad, valid_len, splits", [
    (2048, [197, 589, 981, 1961, 393, 1373, 1765, 1961], 8),  # hub shapes
    (2048, [197, 589, 981, 1961, 393, 1373, 1765, 1961], 44),
    (384, [1, 0, 33, 127, 129, 383, 200, 65], 14),  # ragged, a padded image
    (128, [0, 0, 0], 5),  # nothing to sum: every split empty
    (256, [256, 1], 40),  # more splits than tiles
    (2048, [1 + 196 * c for c in np.random.default_rng(64).integers(1, 11, 64)], 8),
])
def test_wgrad_split_plan_covers_every_computed_tile_once_in_order(s_pad, valid_len, splits):
    plan = fused_block.wgrad_split_tiles(valid_len, s_pad, splits)
    assert len(plan) == splits
    assert [r for share in plan for r in share] == _computed_tiles(valid_len, s_pad)
    sizes = [len(share) for share in plan]
    assert max(sizes) - min(sizes) <= 1  # contiguous shares of near-equal size


WGRAD_TILES = {torch.bfloat16: (fused_block.WGRAD_BF16_TILES, fused_block.WGRAD_BF16_BLOCKS),
               torch.float32: (fused_block.WGRAD_F32_TILES, fused_block.WGRAD_F32_BLOCKS)}


@pytest.mark.parametrize("n, k", sorted(fused_block.WGRAD_BF16_TILES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wgrad_splits_stay_bounded_as_the_batch_grows(n, k, dtype):
    table, blocks = WGRAD_TILES[dtype]
    tn, tk = table[(n, k)]
    assert n % tn == 0 and k % tk == 0
    tiles = (n // tn) * (k // tk)
    splits = [fused_block.wgrad_splits(bsz, 2048, n, k, dtype) for bsz in (1, 8, 64, 256, 1024)]
    assert splits[0] <= 2048 // fused_block.ROW_BLOCK
    assert len(set(splits)) == 1  # the partial scratch does not grow with the batch
    assert tiles * splits[0] <= blocks  # one wave on the card
    assert fused_block.wgrad_splits(1, 32, n, k, dtype) == 1  # no more splits than 32-row tiles


@pytest.mark.parametrize("n, k", sorted(fused_block.WGRAD_F32_TILES))
def test_wgrad_f32_tiles_span_the_192_wide_side(n, k):
    """The float32 kernel's tile takes the 192-wide side of dW whole and 64 of
    the other, so the 2048-wide operand is read once; six warps of 32 x 64."""
    tn, tk = fused_block.WGRAD_F32_TILES[(n, k)]
    d = fused_block.D_MODEL
    assert (tn, tk) == ((d, 64) if k == fused_block.D_FFN else (64, d))
    assert (tn // 32) * (tk // 64) == 6 and n % tn == 0 and k % tk == 0
    assert set(fused_block.WGRAD_F32_TILES) == set(fused_block.WGRAD_BF16_TILES)


@pytest.mark.parametrize("n, k", sorted(fused_block.WGRAD_BF16_TILES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_passes_its_row_plan_to_the_kernel(fake_cuda, n, k, dtype):
    bsz, s = 3, 640
    vl = torch.tensor([640, 3, 100], dtype=torch.int32)
    z = torch.zeros(bsz, s, dtype=torch.float32)
    dm = fused_block.D_MODEL
    ln = (z, z, torch.ones(k), torch.zeros(k)) if (n, k) == (3 * dm, dm) else None
    fused_block.linear_wgrad(torch.zeros(bsz, s, n, dtype=dtype),
                             torch.zeros(bsz, s, k, dtype=dtype), vl, ln=ln)
    (name,), (args,) = fake_cuda.calls, fake_cuda.args
    plan = fused_block.wgrad_splits(bsz, s, n, k, dtype)
    assert name == _launch.entry_point("linear_wgrad", dtype)
    assert args[-2] == plan and args[-6:-2] == (bsz * s, n, k, s)


# ---- the split plan of layernorm_bwd (both dtypes) ----------------------------
@pytest.mark.parametrize("s_pad, valid_len, splits", [
    (2048, [197, 589, 981, 1961, 393, 1373, 1765, 1961], 512),  # hub shapes: a tile a split
    (2048, [197, 589, 981, 1961, 393, 1373, 1765, 1961], 44),
    (384, [1, 0, 33, 127, 129, 383, 200, 65], 14),  # ragged, a padded image
    (128, [0, 0, 0], 5),  # nothing to sum: every split empty
    (2048, [1 + 196 * c for c in np.random.default_rng(64).integers(1, 11, 64)], 2048),
])
def test_layernorm_bwd_split_plan_covers_every_computed_tile_once_in_order(s_pad, valid_len,
                                                                          splits):
    plan = fused_block.layernorm_bwd_split_tiles(valid_len, s_pad, splits)
    assert len(plan) == splits
    assert [r for share in plan for r in share] == _computed_tiles(valid_len, s_pad)
    # each split walks a contiguous share of all the tiles, near-equal in size
    tiles = len(valid_len) * s_pad // fused_block.ROW_BLOCK
    walked = [(i + 1) * tiles // splits - i * tiles // splits for i in range(splits)]
    assert sum(walked) == tiles and max(walked) - min(walked) <= 1
    assert all(len(share) <= n for share, n in zip(plan, walked))


def test_layernorm_bwd_splits_stay_bounded_as_the_batch_grows():
    splits = [fused_block.layernorm_bwd_splits(bsz, 2048) for bsz in (64, 256, 1024, 4096)]
    assert splits == [fused_block.LN_BWD_SPLITS] * 4  # the scratch does not grow
    assert fused_block.layernorm_bwd_splits(1, 64) == 2  # no more splits than 32-row tiles
    assert fused_block.layernorm_bwd_splits(8, 2048) == 8 * 2048 // fused_block.ROW_BLOCK


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz, s", [(3, 640), (64, 2048)])
def test_layernorm_bwd_passes_its_split_plan_to_the_kernel(fake_cuda, dtype, bsz, s):
    d = fused_block.D_MODEL
    vl = torch.full((bsz,), 3, dtype=torch.int32)
    z = torch.zeros(bsz, s, d, dtype=dtype)
    stats = torch.zeros(bsz, s)
    dx, dgb = fused_block.layernorm_bwd(z, z, stats, stats, torch.ones(d), vl)
    (name,), (args,) = fake_cuda.calls, fake_cuda.args
    assert name == _launch.entry_point("layernorm_bwd", dtype)
    assert args[-5:-1] == (bsz * s, d, s, fused_block.layernorm_bwd_splits(bsz, s))
    assert dx.shape == z.shape and dx.dtype == dtype and dgb.shape == (2 * d,)


# ---- the split plan of ln_bwd (K6, both dtypes) -----------------------------------
@pytest.mark.parametrize("m", [1, 5, 63, 64, 65, 2200, 16384, 65573, 10 ** 6])
def test_ln_bwd_split_plan_covers_every_row_once_in_order(m):
    from chadavit_tpu_torch.ops import layernorm as ln

    splits = ln.ln_bwd_splits(m)
    plan = ln.ln_bwd_split_rows(m, splits)
    assert len(plan) == splits and 1 <= splits <= m
    assert [r for share in plan for r in share] == list(range(m))  # each row in one split
    sizes = [len(share) for share in plan]
    assert max(sizes) - min(sizes) <= 1  # near-equal contiguous shares
    if splits < ln.LN_BWD_MAX_SPLITS:  # below the cap, no split walks more than its rows
        assert max(sizes) <= ln.LN_BWD_SPLIT_ROWS


def test_ln_bwd_splits_depend_on_the_rows_alone_and_stay_bounded():
    from chadavit_tpu_torch.ops import layernorm as ln

    rows, most = ln.LN_BWD_SPLIT_ROWS, ln.LN_BWD_MAX_SPLITS
    assert [ln.ln_bwd_splits(m) for m in (1, rows, rows + 1, 16384)] == [1, 1, 2, 16384 // rows]
    big = [ln.ln_bwd_splits(m) for m in (most * rows, most * rows + 1, 10 ** 6, 10 ** 8)]
    assert big == [most] * 4  # the scratch does not grow with the batch
    # the scratch at the widest row the kernel takes: at most 2 MB
    assert most * 2 * ln.LN_MAX_D * 4 <= 2 * 2 ** 20


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 45, 192), (1, 5, 64), (40, 2048, 192)])
def test_ln_bwd_passes_its_split_plan_and_scratch_to_the_kernel(fake_cuda, monkeypatch, shape,
                                                                dtype, residual):
    from chadavit_tpu_torch.ops import layernorm as ln

    made, scratch = [], ln.ln_bwd_scratch
    monkeypatch.setattr(ln, "ln_bwd_scratch",
                        lambda m, d, device: made.append(scratch(m, d, device)) or made[-1])
    d, m = shape[-1], shape[0] * shape[1]
    x = torch.zeros(shape, dtype=dtype)
    stats = torch.zeros(shape[:-1])
    dx, dg, db = ln.ln_bwd(x, x if residual else None, torch.ones(d), stats, stats, x)
    (name,), (args,) = fake_cuda.calls, fake_cuda.args
    splits = ln.ln_bwd_splits(m)
    assert name == _launch.entry_point("ln_bwd", dtype)
    assert len(args) == len(_build.SIGNATURES[name]) and args[-4:-1] == (m, d, splits)
    assert (args[1] is not None) == residual
    # the kernel writes one partial row of [dgamma, dbeta] a split, into that scratch
    (partial,) = made
    assert partial.shape == (splits, 2 * d) and partial.dtype == torch.float32
    assert args[7] == partial.data_ptr()
    assert dx.shape == shape and dx.dtype == dtype and dg.shape == db.shape == (d,)


def test_bf16_dgrad_refuses_rows_off_its_block(cuda_route):
    d = fused_block.D_MODEL
    vl = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 64"):
        fused_block.linear_dgrad(torch.zeros(1, 96, d, dtype=torch.bfloat16),
                                 torch.zeros(d, d, dtype=torch.bfloat16), vl)
    with pytest.raises(KernelReached):  # 128 rows are two of its blocks
        fused_block.linear_dgrad(torch.zeros(1, 128, d, dtype=torch.bfloat16),
                                 torch.zeros(d, d, dtype=torch.bfloat16), vl)


def test_bf16_wgrad_norms_x_of_the_model_width_only(cuda_route):
    d, f = fused_block.D_MODEL, fused_block.D_FFN
    z = torch.zeros(1, 128)
    with pytest.raises(ValueError, match="norms X of width"):
        fused_block.linear_wgrad(torch.zeros(1, 128, d, dtype=torch.bfloat16),
                                 torch.zeros(1, 128, f, dtype=torch.bfloat16),
                                 torch.tensor([3], dtype=torch.int32),
                                 ln=(z, z, torch.ones(f), torch.zeros(f)))


def _misaligned(*shape):
    """A contiguous float32 tensor 8 bytes past a 16-byte boundary."""
    return torch.zeros(math.prod(shape) + 2)[2:].view(shape)


@pytest.mark.parametrize("which", ["dy", "w", "residual"])
def test_f32_dgrad_refuses_operands_its_copies_cannot_take(fake_cuda, which):
    # the float32 linear_dgrad copies 16 bytes at a time (cp.async): an operand
    # 8 bytes past a 16-byte boundary is refused before the launch
    d, f = fused_block.D_MODEL, fused_block.D_FFN
    shapes = {"dy": (2, 128, f), "w": (f, d), "residual": (2, 128, d)}
    ops = {n: _misaligned(*sh) if n == which else torch.zeros(sh) for n, sh in shapes.items()}
    with pytest.raises(ValueError, match="aligned"):
        fused_block.linear_dgrad(ops["dy"], ops["w"], torch.tensor([128, 3], dtype=torch.int32),
                                 residual=ops["residual"])
    assert fake_cuda.calls == []
