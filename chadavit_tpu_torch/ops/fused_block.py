"""One ChAdaViT encoder layer, forward and backward, as chains of CUDA kernels.

Counterpart of ``chadavit_tpu/ops/fused_block.py`` (``_stats`` :68,
``_fwd_kernel`` :91, ``_bwd_kernel`` :211, ``_run_fwd`` :519,
``fused_encoder_block`` :572 with its custom VJP ``_vjp_fwd`` :587 and
``_vjp_bwd`` :597). The TPU kernels hold a whole layer of one image in VMEM,
which does not fit a Hopper block's shared memory, so the forward is the chain

    qkv = ln_linear(x)                       LN1, then x @ Wqkv^T + bqkv
    a   = prefix_flash_attention(qkv)         ops/flash_attention.py
    x2  = linear_residual_ln(a, Wout, x)      LN1(x + a @ Wout^T + bout)
    hid = linear_relu(x2)                     relu(x2 @ W1^T + b1)
    y   = linear_residual_ln(hid, W2, x2)     LN2(x2 + hid @ W2^T + b2)

behind :func:`fused_encoder_block`, whose signature follows the JAX function.
When autograd records the call it runs :class:`FusedEncoderBlock`, whose
forward also saves the JAX residual set (``x``, ``attn``, ``x2``, ``r2``, the
base-2 lse and the three pairs of LN stats) and whose backward is the chain of
``csrc/fused_block_bwd.cu`` (:func:`layernorm_bwd`, :func:`linear_dgrad`,
:func:`linear_wgrad`) around ``prefix_attention_bwd``; it recomputes h, qkv
and the FFN hidden as the TPU kernel does, and saves none of them. The
teacher's forward runs under ``torch.no_grad()`` and takes the save-free
launches.

Weights are in torch ``nn.Linear`` layout, ``(out, in)``: the transpose of the
JAX kernels. The GEMM kernels are ``csrc/fused_block.cu`` and
``csrc/fused_block_bwd.cu``, with the bfloat16 instances of every GEMM step
on the tensor cores (``csrc/linear_fwd_bf16.cu``, ``csrc/linear_bwd_bf16.cu``);
``layernorm_bwd`` stays on CUDA cores in both dtypes. Each step has a plain
version here; a CPU tensor takes it, a CUDA tensor the kernel.

Row tiles of :data:`ROW_BLOCK` (32) rows wholly past ``valid_len`` are
skipped and written as zeros, as the TPU kernel skips its fully-invalid
sequence blocks; every row of a tile that holds a valid row is computed for
real, also its rows past ``valid_len``. That 32-row tile is what "computed
for real" means for the port's layer (the JAX kernel's is its 128/256-row
block); padded positions are not contractual either way
(``chadavit_tpu/models/chada_vit.py:461-465``). The backward keeps the TPU
kernel's contract (``fused_block.py:33-39``): it is exact for any cotangent
on the rows the forward computed, so dx on those rows and all 12 parameter
gradients equal autograd through the plain forward; rows of the zero-filled
tiles give nothing and get dx = 0. Keys past ``valid_len`` stay masked.

The chain's kernels are built for the widths of :data:`WIDTHS`:
ChAdaViT-moyen's (D 192, FFN 2048, 2 heads of 96), ChAdaViT-B/16's (D 768,
FFN 2048, 12 heads of 64) and the smoke configs' (``scripts/smoke/*.yaml``:
D 64, FFN 2048, 2 heads of 32). Launches at D 192 are counted under the C
entry point's name, those at D 768 and D 64 with ``_d768`` and ``_d64``
after it (:func:`instance`). Which layers take the chain at all is the JAX
layer's choice (:func:`jax_layer_fused`, a copy of its VMEM gate):
ChAdaViT-B/16 at a sequence the gate sends to the unfused layer runs
``models/chada_vit.py``'s unfused body with the attention kernels, and the
chain where the gate says fused (1-7 channels in bfloat16, 1-3 in float32);
the smoke width takes the chain at every sequence up to 10 channels of 224
px. At any other width the chain raises ``NotImplementedError`` on CUDA
tensors (on CPU tensors it runs its plain versions, which take any width).

Precision follows the JAX kernels, not ``torch.autocast``: the layer takes
float32 or bfloat16 activations. The parameters stay float32; the matrices
and biases are cast to the activation dtype at use (:func:`pack_weights`,
the JAX ``_pack_weights``) and the LayerNorm parameters stay float32. In
bfloat16 every product sums in float32 and rounds to bfloat16 before its
bfloat16 bias add; residual adds are bfloat16; LayerNorm statistics are
float32 and the LN output is rounded to bfloat16; the saved residuals
(``x``, ``attn``, ``x2``, ``r2``) are bfloat16 and the lse and stats float32;
dx is bfloat16 and the parameter gradients float32. The kernels have a
bfloat16 instance each (C entry points ending in ``_bf16``), and the plain
versions round at the same points.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from chadavit_tpu_torch.ops import _build, _launch
from chadavit_tpu_torch.ops import flash_attention as fa
from chadavit_tpu_torch.ops.layernorm import layernorm_stats

ROW_BLOCK = 32  # the GEMM kernels' row tile and K slice
SEQ_PAD = 128   # the chain pads sequences to this multiple, as the model does
# The widths the kernels are built for, D -> FFN: the smoke configs',
# ChAdaViT-moyen's and ChAdaViT-B/16's; on CUDA tensors the wrappers raise on
# any other.
WIDTHS = {64: 2048, 192: 2048, 768: 2048}
# ChAdaViT-moyen's widths: launches at D_MODEL keep the entry point's name
D_MODEL = 192
D_FFN = 2048
# ChAdaViT-B/16's width, where the bfloat16 K1a, K1b, K1c, K2b and K2c are wgmma kernels
D_WIDE = 768
# the smoke configs' width (scripts/smoke/*.yaml: 2 heads of 32)
D_SMALL = 64
# The bfloat16 ln_linear / linear_relu / linear_residual_ln / linear_dgrad /
# linear_wgrad are tensor-core kernels (csrc/linear_fwd_bf16.cu,
# csrc/linear_bwd_bf16.cu; at D 768 csrc/linear_wgmma_bf16.cu)
# that copy 16 bytes at a time. The first four own 64-row blocks, so s_pad
# must be a multiple of 64 (the chain pads to SEQ_PAD). At D 192 wgrad's grid
# is its output tiles (the (TN, TK) of each weight shape (N, K) below, as the
# kernel has them) times a number of splits of the rows that fills the card's
# 132 SMs once.
BF16_GEMM_ROWS = 64


def _weight_shapes(d: int, f: int, qkv, square, ffn1, ffn2) -> dict:
    """``{(N, K): tile}`` for the four weight shapes of a layer of width d."""
    return {(3 * d, d): qkv, (d, d): square, (f, d): ffn1, (d, f): ffn2}


WGRAD_BF16_TILES = {
    **_weight_shapes(D_MODEL, D_FFN, (64, D_MODEL), (64, D_MODEL), (128, D_MODEL), (D_MODEL, 128)),
    # D 64: the whole 64-wide side (three tiles along N at the QKV site)
    **_weight_shapes(D_SMALL, D_FFN, (64, D_SMALL), (64, D_SMALL), (128, D_SMALL), (D_SMALL, 128))}
WGRAD_BF16_BLOCKS = 132
# At D 768 linear_wgrad is a stream-K walk in both dtypes: the units of every
# output tile (the computed 32-row tiles, in bfloat16 two at a time) are cut
# into as many near-equal shares in tile-major order as the grid has blocks,
# one block each; the partial of each tile segment lands in slot tile + block
# (wgrad_stream_plan), so the scratch holds tiles + blocks - 1 slots whatever
# the batch, and a second pass adds each tile's slots in block order
# (wgrad_stream_fixups). bfloat16 (csrc/linear_wgmma_bf16.cu): 128 x 256
# output tiles, WGRAD_WGMMA_UNIT rows a unit, WGRAD_WGMMA_BLOCKS blocks, one
# an SM.
WGRAD_WGMMA_TILES = _weight_shapes(D_WIDE, WIDTHS[D_WIDE], *((128, 256),) * 4)
WGRAD_WGMMA_UNIT = 2 * ROW_BLOCK
WGRAD_WGMMA_BLOCKS = 132
# The float32 linear_wgrad (CUDA cores, csrc/fused_block_bwd.cu) at D 192 and
# D 64 splits the rows by a plan of its own (wgrad_splits): tiles of 192 of
# the D-wide side of dW and 64 of the other at D 192 (6 warps of 32 x 64
# outputs), the whole 64-wide side and 192, 64, 128 and 128 of the other at
# D 64 (6, 2, 4 and 4 warps), two blocks an SM, so the splits fill
# WGRAD_F32_BLOCKS blocks once, and never more than WGRAD_SPLITS: the
# out-projection's 3 tiles would take 88, whose partials (13 MB) the second
# pass would read for a product of 0.7 GFLOP at hub shapes. The bfloat16
# plan takes the same cap, which it reaches only at D 64's out-projection
# (one tile, 132 splits uncapped). At D 768 the float32 walk takes D 192's
# tiles (WGRAD_F32_STREAM_TILES), one 32-row tile a unit, over
# WGRAD_F32_BLOCKS blocks.
WGRAD_F32_TILES = {
    **_weight_shapes(D_MODEL, D_FFN, (64, D_MODEL), (64, D_MODEL), (64, D_MODEL), (D_MODEL, 64)),
    **_weight_shapes(D_SMALL, D_FFN, (3 * D_SMALL, D_SMALL), (D_SMALL, D_SMALL), (128, D_SMALL),
                     (D_SMALL, 128))}
WGRAD_F32_STREAM_TILES = _weight_shapes(D_WIDE, WIDTHS[D_WIDE], (64, D_MODEL), (64, D_MODEL),
                                        (64, D_MODEL), (D_MODEL, 64))
WGRAD_F32_BLOCKS = 264
WGRAD_SPLITS = 64
# The float32 linear_dgrad at D 768 (csrc/fused_block_bwd.cu,
# linear_dgrad_d768) is a stream-K walk too: a unit is one computed 32-row
# tile x one column slice (DGRAD_F32_COLUMNS of the output's N) x one slab of
# DGRAD_F32_SLAB columns of K; the units of every output tile (computed tile
# i x slices + slice), tile-major, are cut into as many near-equal shares as
# the card holds blocks of the walk (the C side reads that from the runtime's
# occupancy, linear_dgrad_d768_blocks), one block each. A block's segment that
# is a whole tile writes dX; the others land in slot tile + block, and a
# second pass adds each split tile's slots in block order (dgrad_stream_plan,
# dgrad_stream_fixups). The wrapper asks the C side for the grid once a site
# and device (dgrad_stream_blocks) and sizes the scratch as every 32-row tile
# of the batch plus blocks - 1 slots; the kernel refuses a smaller scratch.
DGRAD_F32_SLAB = 16
DGRAD_F32_COLUMNS = {D_FFN: 256, D_WIDE: D_MODEL}
_DGRAD_F32_BLOCKS = {}  # (device, K, N, epilogue) -> the walk's grid there
# layernorm_bwd (both dtypes) cuts the batch's 32-row tiles into at most this
# many contiguous shares at D 192 (a quarter as many at D 768), one block
# each, whatever the batch: its partial sums are (splits, 2 D) float32
# (layernorm_bwd_splits), 3.1 MB at most at either width. A few blocks an SM,
# so the first pass keeps the card's loads in flight and its second pass
# stays a few microseconds (scripts/bench_layernorm_bwd.py).
LN_BWD_SPLITS = 2048


def instance(entry_point: str, d: int) -> str:
    """The name a launch of C entry point ``entry_point`` at width ``d`` is
    counted under (``_launch.LAUNCHES``): the entry point's own at D 192,
    with ``_d768`` or ``_d64`` after it at D 768 or D 64."""
    return entry_point if d == D_MODEL else f"{entry_point}_d{d}"


def _built_width(name: str, d: int) -> int:
    """``d`` when the kernels are built for it (:data:`WIDTHS`), else raises
    ``ValueError``."""
    if d not in WIDTHS:
        raise ValueError(f"{name}: the kernels are built for D in {sorted(WIDTHS)}, got {d}")
    return d


# --------------------------------------------------------------- the route ----
# The JAX layer takes its fused Pallas layer kernel only where the kernel's
# VMEM estimate fits (chadavit_tpu/models/chada_vit.py:186-200); the port's
# EncoderLayer takes the same route. Host integer arithmetic, copied from
# chadavit_tpu/ops/flash_attention.py (DEFAULT_BLOCK :75, MIN_BLOCK :76,
# pick_block :79, LANES :96) and chadavit_tpu/ops/fused_block.py (VMEM_BYTES
# :65, _bwd_block :482, vmem_estimate :504).
VMEM_BYTES = 100 * 1024 * 1024  # the JAX fused layer's VMEM budget
LANES = 8
DEFAULT_BLOCK = 256
MIN_BLOCK = 128


def pick_block(s: int, default: int = DEFAULT_BLOCK) -> int:
    """The JAX kernels' sequence block for a sequence of ``s`` rows: 256
    where it divides ``s``, else 128 where that does, else 256."""
    if s % default == 0:
        return default
    if s % MIN_BLOCK == 0:
        return MIN_BLOCK
    return default


def _bwd_block(block: int, s_pad: int) -> int:
    """The JAX backward's key block: doubled where that still divides s_pad."""
    return 2 * block if s_pad % (2 * block) == 0 else block


def vmem_estimate(s_pad: int, d: int, f: int, num_heads: int, block: int,
                  itemsize: int) -> int:
    """The JAX fused layer's VMEM estimate in bytes (its backward kernel's)."""
    act = s_pad * d * itemsize
    return (4 * act
            + 2 * s_pad * 3 * d * itemsize
            + s_pad * d * 4
            + 4 * num_heads * LANES * s_pad * 4
            + (2 * d * 3 * d + 2 * d * d + 4 * d * f) * 4
            + (d * 3 * d + d * d + 2 * d * f) * itemsize
            + 6 * _bwd_block(block, s_pad) * s_pad * 4
            + 6 * act)


def jax_layer_fused(s: int, d: int, f: int, num_heads: int, dtype: torch.dtype,
                    has_valid_len: bool = True, return_attention: bool = False) -> bool:
    """True where the JAX ``EncoderLayer`` with ``block_impl="auto"`` on a
    TPU runs its fused layer kernel on a sequence of ``s`` rows (as the layer
    receives it) at width ``d``, FFN ``f``, ``num_heads`` heads and compute
    ``dtype``: ``valid_len`` given, no attention weights asked, a head width
    that is a multiple of 8, and the kernel's VMEM estimate at the dtype's
    item size at most :data:`VMEM_BYTES` (and dropout 0, which the port's
    layer always has: it refuses a rate above 0). Elsewhere it runs the
    unfused layer (plain LayerNorms and products around the attention
    kernels)."""
    if not has_valid_len or return_attention:
        return False
    if d % num_heads or (d // num_heads) % 8:
        return False
    blk = pick_block(s)
    s_pad = -(-s // blk) * blk
    itemsize = torch.empty((), dtype=dtype).element_size()
    return vmem_estimate(s_pad, d, f, num_heads, blk, itemsize) <= VMEM_BYTES


# ---------------------------------------------------------- plain versions ----
def _ln(x, mu, rstd, g, b):
    return ((x.float() - mu) * rstd * g.float() + b.float()).to(x.dtype)


def _mm(a, w):
    """``a @ w^T`` (w ``(N, K)``); a bfloat16 product sums in float32 and
    rounds to bfloat16, as the JAX kernels' ``_nn(...).astype(dt)``."""
    if a.dtype == torch.float32:
        return torch.matmul(a, w.t())
    return torch.matmul(a.float(), w.float().t()).to(a.dtype)


def computed_rows(x: torch.Tensor, valid_len) -> torch.Tensor:
    """``(B, S, 1)`` bool: the row lies in a :data:`ROW_BLOCK` tile that holds
    a valid row of its image, so the forward computes it for real."""
    start = torch.arange(x.shape[1], device=x.device) // ROW_BLOCK * ROW_BLOCK
    return (start[None, :] < valid_len.to(x.device)[:, None])[..., None]


def ln_linear_reference(x, g, b, eps, w, bias, valid_len=None, save: bool = False):
    """``LN(x) @ w^T + bias``; x ``(B, S, K)``, w ``(N, K)``. With ``save``
    also the LN row mean and rstd, ``(B, S)`` each."""
    mu, rstd = layernorm_stats(x, eps)
    out = _mm(_ln(x, mu, rstd, g, b), w) + bias
    return (out, mu[..., 0], rstd[..., 0]) if save else out


def layernorm_rows_reference(x, g, b, valid_len, eps: float = 1e-5, stats=None):
    """The LN1 pre-pass of the bfloat16 K1a and K2c at D 768:
    ``h = LN(x)`` rounded to x's dtype (the h of :func:`ln_linear_reference`)
    on the rows the forward computes (:func:`computed_rows`), zeros on the
    others; the row stats taken here, or given as ``stats = (mean, rstd)``
    ``(B, S)`` each. Returns ``(h, mean, rstd)``; stats it takes are zeros on
    the zero-filled tiles."""
    ok = computed_rows(x, valid_len)
    if stats is None:
        mu, rstd = layernorm_stats(x, eps)
        mu, rstd = torch.where(ok, mu, 0.0)[..., 0], torch.where(ok, rstd, 0.0)[..., 0]
    else:
        mu, rstd = stats
    h = torch.where(ok, _ln(x, mu[..., None], rstd[..., None], g, b), 0.0).to(x.dtype)
    return h, mu, rstd


def linear_relu_reference(x, w, bias, valid_len=None):
    """``relu(x @ w^T + bias)``."""
    return torch.relu(_mm(x, w) + bias)


def linear_residual_ln_reference(a, w, bias, residual, g, b, eps, valid_len=None,
                                 save: bool = False):
    """``LN(residual + (a @ w^T + bias))``: the residual add in the input
    dtype, then f32 LayerNorm (the double-norm1 site and the LN2 site). With
    ``save`` also the LN row mean and rstd ``(B, S)`` and the pre-LN sum r."""
    r = residual + (_mm(a, w) + bias)
    mu, rstd = layernorm_stats(r, eps)
    out = _ln(r, mu, rstd, g, b)
    return (out, mu[..., 0], rstd[..., 0], r) if save else out


def layernorm_bwd_reference(dy, xin, mean, rstd, g, valid_len, residual=None,
                            dgb=None):
    """Backward of ``y = LN(xin) g + beta`` from the saved row stats
    (``fused_block.py:242-252``): ``dx = rstd (dy g - mean(dy g) - xhat
    mean(dy g xhat))`` plus ``residual``, in f32 and rounded once to dy's
    dtype, and ``dgb = [dgamma, dbeta]`` ``(2 D,)`` in f32, summed into
    ``dgb`` when it is given. Rows the forward did not compute
    (:func:`computed_rows`) give nothing and get ``dx = 0``. Returns
    ``(dx, dgb)``."""
    ok = computed_rows(dy, valid_len)
    d = dy.shape[-1]
    dyf = torch.where(ok, dy.float(), 0.0)
    xhat = torch.where(ok, (xin.float() - mean[..., None]) * rstd[..., None], 0.0)
    dyg = dyf * g.float()
    m1 = dyg.sum(-1, keepdim=True) / d
    m2 = (dyg * xhat).sum(-1, keepdim=True) / d
    dx = rstd[..., None] * (dyg - m1 - xhat * m2)
    if residual is not None:
        dx = dx + residual
    dx = torch.where(ok, dx, 0.0).to(dy.dtype)
    sums = torch.cat([(dyf * xhat).sum((0, 1)), dyf.sum((0, 1))])
    if dgb is None:
        return dx, sums
    return dx, dgb.add_(sums)


def linear_dgrad_reference(dy, w, valid_len, relu_of=None, residual=None):
    """``dX = dY @ W`` (W in Linear layout ``(N_out, N_in)``), masked by
    ``relu_of > 0`` or plus ``residual``, summed in f32 and rounded once to
    dy's dtype; rows the forward did not compute are zero."""
    if dy.dtype == torch.float32:
        out = torch.matmul(dy, w)
    else:
        out = torch.matmul(dy.float(), w.float())
    if relu_of is not None:
        out = torch.where(relu_of > 0, out, 0.0)
    if residual is not None:
        out = residual + out
    return torch.where(computed_rows(dy, valid_len), out, 0.0).to(dy.dtype)


def linear_wgrad_reference(dy, x, valid_len, ln=None):
    """``(dW, db) = (dY^T X', colsum dY)`` in f32 over the rows the forward
    computed; ``X' = LN(X)`` (rounded to X's dtype, the forward's h) with
    ``ln = (mean, rstd, g, beta)``, else X."""
    ok = computed_rows(dy, valid_len)
    if ln is not None:
        mean, rstd, g, b = ln
        x = _ln(x, mean[..., None], rstd[..., None], g, b)
    dyf = torch.where(ok, dy, 0.0).reshape(-1, dy.shape[-1])
    xf = torch.where(ok, x, 0.0).reshape(-1, x.shape[-1])
    if dy.dtype != torch.float32:
        dyf, xf = dyf.float(), xf.float()
    return torch.matmul(dyf.t(), xf), dyf.sum(0)


# ---------------------------------------------------------------- kernels ----
def _check(name: str, a, w, ks, n: int):
    """Shape checks of a GEMM step: a ``(B, S, K)`` with S a multiple of
    :data:`ROW_BLOCK` and K in ``ks``, w ``(n, K)``. Returns ``(B, S, K)``."""
    if (a.dim() != 3 or a.shape[1] % ROW_BLOCK or a.shape[2] not in ks
            or w.shape != (n, a.shape[2])):
        raise ValueError(
            f"{name}: the kernel takes a (B, S, K) with S a multiple of {ROW_BLOCK} and "
            f"K in {ks}, w ({n}, K); got {tuple(a.shape)} and {tuple(w.shape)}")
    return a.shape


def _stats_out(save: bool, bsz: int, s: int, like: torch.Tensor):
    if not save:
        return None, None
    return (torch.empty((bsz, s), dtype=torch.float32, device=like.device),
            torch.empty((bsz, s), dtype=torch.float32, device=like.device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _copy_align(name: str, dtype: torch.dtype, s: int) -> int:
    """The alignment in bytes that a GEMM kernel's 16-byte copies need of its
    operands beyond the four elements ``vector_operand`` always asks: 16 for
    the bfloat16 tensor-core kernels, whose 64-row blocks also need S a
    multiple of :data:`BF16_GEMM_ROWS` (raises otherwise); 0 for float32,
    whose four elements are the 16 bytes that the cp.async copies of the
    float32 ``linear_residual_ln`` and ``linear_wgrad`` need."""
    if dtype != torch.bfloat16:
        return 0
    if s % BF16_GEMM_ROWS:
        raise ValueError(f"{name}: the bfloat16 kernel takes S a multiple of "
                         f"{BF16_GEMM_ROWS}, got {s}")
    return 16


def _library_fn(name: str, dtype: torch.dtype):
    """``(C entry point name, its function)`` of kernel ``name`` for
    activations of ``dtype`` (``_bf16`` for bfloat16)."""
    full = _launch.entry_point(name, dtype)
    return full, getattr(_build.library(), full)


def _wgmma(dtype: torch.dtype, d: int) -> bool:
    """True where a step's bfloat16 kernel at width ``d`` is the wgmma one
    (csrc/linear_wgmma_bf16.cu): at D 768, K1a (``ln_linear_fwd_wgmma_bf16``),
    K1b at both sites (``linear_residual_ln_fwd_wgmma_bf16``), K1c
    (``linear_relu_fwd_wgmma_bf16``), K2b at its four sites
    (``linear_dgrad_wgmma_bf16``) and K2c (``linear_wgrad_wgmma_bf16``); K2a
    keeps its entry point."""
    return dtype == torch.bfloat16 and d == D_WIDE


def ln_linear(x, g, b, eps: float, w, bias, valid_len, save: bool = False):
    """``LN(x) @ w^T + bias`` (kernel ``ln_linear_fwd`` on CUDA; in
    bfloat16 on the tensor cores, S a multiple of :data:`BF16_GEMM_ROWS` and
    x, w, bias 16-byte aligned; at D 768 in bfloat16 ``ln_linear_fwd_wgmma_bf16``,
    whose LN1 pre-pass writes h into a scratch of x's shape that the GEMM
    reads by TMA, and in float32 ``ln_linear_fwd_d768``, whose row pass does
    the same for its GEMM on 128-row blocks); with ``save`` also the LN row
    mean and rstd. x, w and bias of one dtype (float32 or bfloat16), g and b
    float32. Forward only: raises where autograd would record the call."""
    _launch.refuse_grad("ln_linear", x, g, b, w, bias)
    if _launch.on_cpu(x, g, b, w, bias, valid_len):
        return ln_linear_reference(x, g, b, eps, w, bias, valid_len, save)
    d = _built_width("ln_linear", x.shape[-1])
    n, dt = 3 * d, x.dtype
    bsz, s, k = _check("ln_linear", x, w, (d,), n)
    if g.shape != (k,) or b.shape != (k,) or bias.shape != (n,):
        raise ValueError(f"ln_linear: g {tuple(g.shape)}, b {tuple(b.shape)}, "
                         f"bias {tuple(bias.shape)}")
    tc = _copy_align("ln_linear", dt, s)
    out = torch.empty((bsz, s, n), dtype=dt, device=x.device)
    mean, rstd = _stats_out(save, bsz, s, x)
    name, fn = _library_fn("ln_linear_fwd", dt)
    args = [_launch.vector_operand(x, "x", dt, tc), _launch.vector_operand(g, "g"),
            _launch.vector_operand(b, "b"), eps, _launch.vector_operand(w, "w", dt, tc),
            _launch.vector_operand(bias, "bias", dt, tc),
            _launch.vector_operand(out, "out", dt, tc), _ptr(mean), _ptr(rstd)]
    if d == D_WIDE:  # LN1 in a row pass into h, then the GEMM
        fn = (_build.library().ln_linear_fwd_wgmma_bf16 if dt == torch.bfloat16 else
              _build.library().ln_linear_fwd_d768)
        h = torch.empty_like(x)  # the pre-pass's scratch, held until the launch is queued
        args.append(h.data_ptr())
    status = fn(*args, _launch.valid_len_operand(valid_len, bsz, x.device), bsz * s, k, n, s,
                _launch.stream(x.device))
    _build.check(status, name)
    _launch.counted(instance(name, d))
    return (out, mean, rstd) if save else out


def layernorm_rows(x, g, b, valid_len, eps: float = 1e-5, stats=None):
    """The LN1 pre-pass of the bfloat16 K1a and K2c at D 768 on its own
    (kernel ``ln_rows_bf16``, bfloat16 x of width 192 or 768, 16-byte
    aligned): ``(h, mean, rstd)`` as :func:`layernorm_rows_reference`, the
    stats taken by the kernel or given as ``stats = (mean, rstd)`` (then
    returned as they are)."""
    if _launch.on_cpu(x, g, b, valid_len):
        return layernorm_rows_reference(x, g, b, valid_len, eps, stats)
    d = x.shape[-1]
    if d not in (D_MODEL, D_WIDE):
        raise ValueError(f"layernorm_rows: the kernel is built for D 192 and 768, got {d}")
    if x.dim() != 3 or x.shape[1] % ROW_BLOCK or g.shape != (d,) or b.shape != (d,):
        raise ValueError(f"layernorm_rows: x {tuple(x.shape)} (S a multiple of {ROW_BLOCK}), "
                         f"g {tuple(g.shape)}, b {tuple(b.shape)}")
    bsz, s, _ = x.shape
    h = torch.zeros_like(x)  # the kernel writes the computed rows only
    if stats is None:
        mean, rstd = _stats_out(True, bsz, s, x)
        ins, outs = (None, None), (mean.data_ptr(), rstd.data_ptr())
    else:
        mean, rstd = stats
        ins, outs = (_row_stats("mean", mean, bsz, s), _row_stats("rstd", rstd, bsz, s)), (None,
                                                                                           None)
    status = _build.library().ln_rows_bf16(
        _launch.vector_operand(x, "x", torch.bfloat16, 16), _launch.vector_operand(g, "g"),
        _launch.vector_operand(b, "b"), eps, *ins, h.data_ptr(), *outs,
        _launch.valid_len_operand(valid_len, bsz, x.device), bsz * s, d, s,
        _launch.stream(x.device))
    _build.check(status, "ln_rows_bf16")
    _launch.counted("ln_rows_bf16")
    return h, mean, rstd


def linear_relu(x, w, bias, valid_len):
    """``relu(x @ w^T + bias)`` (kernel ``linear_relu_fwd`` on CUDA; in
    bfloat16 on the tensor cores, S a multiple of :data:`BF16_GEMM_ROWS` and
    x, w 16-byte aligned; at D 768 in bfloat16 ``linear_relu_fwd_wgmma_bf16``,
    which also writes the zero-filled tiles' rows), all of one dtype. Forward
    only: raises where autograd would record the call."""
    _launch.refuse_grad("linear_relu", x, w, bias)
    if _launch.on_cpu(x, w, bias, valid_len):
        return linear_relu_reference(x, w, bias, valid_len)
    d = _built_width("linear_relu", x.shape[-1])
    n, dt = WIDTHS[d], x.dtype
    bsz, s, k = _check("linear_relu", x, w, (d,), n)
    if bias.shape != (n,):
        raise ValueError(f"linear_relu: bias {tuple(bias.shape)}")
    tc = _copy_align("linear_relu", dt, s)
    out = torch.empty((bsz, s, n), dtype=dt, device=x.device)
    name, fn = _library_fn("linear_relu_fwd", dt)
    if _wgmma(dt, d):
        fn = _build.library().linear_relu_fwd_wgmma_bf16
    status = fn(
        _launch.vector_operand(x, "x", dt, tc), _launch.vector_operand(w, "w", dt, tc),
        _launch.vector_operand(bias, "bias", dt), _launch.vector_operand(out, "out", dt, tc),
        _launch.valid_len_operand(valid_len, bsz, x.device), bsz * s, k, n, s,
        _launch.stream(x.device))
    _build.check(status, name)
    _launch.counted(instance(name, d))
    return out


def linear_residual_ln(a, w, bias, residual, g, b, eps: float, valid_len,
                       save: bool = False):
    """``LN(residual + (a @ w^T + bias))`` (kernel ``linear_residual_ln_fwd``
    on CUDA; one block owns whole output rows, so the LayerNorm is local; at
    D 768 a GEMM writes the pre-LN sum r (into the saved r, else into the
    output) and a row pass normalises it, in bfloat16
    ``linear_residual_ln_fwd_wgmma_bf16``; in bfloat16 on the tensor cores, S
    a multiple of :data:`BF16_GEMM_ROWS` and a, w, residual 16-byte
    aligned). With
    ``save`` also the LN row mean and rstd and the pre-LN sum r. a, w, bias
    and residual of one dtype, g and b float32. Forward only: raises where
    autograd would record the call."""
    _launch.refuse_grad("linear_residual_ln", a, w, bias, residual, g, b)
    if _launch.on_cpu(a, w, bias, residual, g, b, valid_len):
        return linear_residual_ln_reference(a, w, bias, residual, g, b, eps, valid_len,
                                            save)
    n = _built_width("linear_residual_ln", w.shape[0] if w.dim() == 2 else -1)
    dt = a.dtype
    bsz, s, k = _check("linear_residual_ln", a, w, (n, WIDTHS[n]), n)
    if (bias.shape != (n,) or residual.shape != (bsz, s, n) or g.shape != (n,)
            or b.shape != (n,)):
        raise ValueError(f"linear_residual_ln: residual {tuple(residual.shape)}, "
                         f"bias {tuple(bias.shape)}")
    tc = _copy_align("linear_residual_ln", dt, s)
    out = torch.empty((bsz, s, n), dtype=dt, device=a.device)
    mean, rstd = _stats_out(save, bsz, s, a)
    r = torch.empty_like(out) if save else None
    name, fn = _library_fn("linear_residual_ln_fwd", dt)
    if _wgmma(dt, n):
        fn = _build.library().linear_residual_ln_fwd_wgmma_bf16
    status = fn(
        _launch.vector_operand(a, "a", dt, tc), _launch.vector_operand(w, "w", dt, tc),
        _launch.vector_operand(bias, "bias", dt),
        _launch.vector_operand(residual, "residual", dt, tc),
        _launch.vector_operand(g, "g"), _launch.vector_operand(b, "b"), eps,
        _launch.vector_operand(out, "out", dt, tc), _ptr(mean), _ptr(rstd), _ptr(r),
        _launch.valid_len_operand(valid_len, bsz, a.device), bsz * s, k, n, s,
        _launch.stream(a.device))
    _build.check(status, name)
    _launch.counted(instance(name, n))
    return (out, mean, rstd, r) if save else out


def _rows(name: str, t, bsz: int, s: int, n: int, dtype: torch.dtype, align: int = 0) -> int:
    """Pointer of a contiguous ``(bsz, s, n)`` CUDA tensor of ``dtype``."""
    if t.shape != (bsz, s, n):
        raise ValueError(f"{name}: want ({bsz}, {s}, {n}), got {tuple(t.shape)}")
    return _launch.vector_operand(t, name, dtype, align)


def _row_stats(name: str, t, bsz: int, s: int) -> int:
    if t.shape != (bsz, s):
        raise ValueError(f"{name}: want ({bsz}, {s}), got {tuple(t.shape)}")
    return _launch.vector_operand(t, name)


def layernorm_bwd_splits(bsz: int, s_pad: int, d: int = D_MODEL) -> int:
    """Row splits of ``layernorm_bwd`` at width ``d``: one block each, walking
    a contiguous share of the batch's 32-row tiles; at most
    :data:`LN_BWD_SPLITS` at D 192 (that times 192 / d at a wider D, whose
    rows are each that much more work) and never more than the tiles, so the
    partial sums ``(splits, 2 d)`` stay bounded whatever the batch."""
    return max(1, min(LN_BWD_SPLITS * D_MODEL // d, bsz * s_pad // ROW_BLOCK))


def layernorm_bwd_split_tiles(valid_len, s_pad: int, splits: int) -> list:
    """The first rows of the 32-row tiles each split of ``layernorm_bwd``
    sums, as its kernel assigns them: split ``i`` walks tiles ``[i * T //
    splits, (i + 1) * T // splits)`` of the ``T = B * s_pad / 32`` in order
    and sums those that hold a valid row (it writes dx = 0 on the others)."""
    per = s_pad // ROW_BLOCK
    total = len(valid_len) * per

    def computed(t):
        return t % per * ROW_BLOCK < int(valid_len[t // per])

    return [[t * ROW_BLOCK for t in range(i * total // splits, (i + 1) * total // splits)
             if computed(t)] for i in range(splits)]


def layernorm_bwd(dy, xin, mean, rstd, g, valid_len, residual=None, dgb=None):
    """Backward of a LayerNorm site from its saved row stats (kernel
    ``layernorm_bwd`` on CUDA, its rows cut by :func:`layernorm_bwd_splits`):
    ``(dx, dgb)`` with ``dgb = [dgamma, dbeta]`` ``(2 D,)`` float32, summed
    into ``dgb`` in place when it is given (the two norm1 sites). dy, xin,
    residual and dx of one dtype; stats and g float32. See
    :func:`layernorm_bwd_reference`."""
    if _launch.on_cpu(dy, xin, mean, rstd, g, valid_len):
        return layernorm_bwd_reference(dy, xin, mean, rstd, g, valid_len, residual, dgb)
    if dy.dim() != 3 or dy.shape[2] not in WIDTHS or dy.shape[1] % ROW_BLOCK:
        raise ValueError(f"layernorm_bwd: the kernel takes (B, S, D), D in {sorted(WIDTHS)}, "
                         f"with S a multiple of {ROW_BLOCK}, got {tuple(dy.shape)}")
    bsz, s, d = dy.shape
    dt = dy.dtype
    if g.shape != (d,):
        raise ValueError(f"layernorm_bwd: g {tuple(g.shape)}")
    dx = torch.empty_like(dy)
    if dgb is None:
        dgb, accumulate = torch.empty(2 * d, dtype=torch.float32, device=dy.device), 0
    else:
        if dgb.shape != (2 * d,):
            raise ValueError(f"layernorm_bwd: dgb {tuple(dgb.shape)}")
        accumulate = 1
    splits = layernorm_bwd_splits(bsz, s, d)
    partial = torch.empty((splits, 2 * d), dtype=torch.float32, device=dy.device)
    name, fn = _library_fn("layernorm_bwd", dt)
    # the bfloat16 row pass at D 768 moves 16 bytes a load and store (gamma too)
    align = 16 if dt == torch.bfloat16 and d == D_WIDE else 0
    status = fn(
        _rows("dy", dy, bsz, s, d, dt, align), _rows("xin", xin, bsz, s, d, dt, align),
        _row_stats("mean", mean, bsz, s), _row_stats("rstd", rstd, bsz, s),
        _launch.vector_operand(g, "g", align=align),
        None if residual is None else _rows("residual", residual, bsz, s, d, dt, align),
        dx.data_ptr(), partial.data_ptr(), _launch.vector_operand(dgb, "dgb"), accumulate,
        _launch.valid_len_operand(valid_len, bsz, dy.device), bsz * s, d, s, splits,
        _launch.stream(dy.device))
    _build.check(status, name)
    _launch.counted(instance(name, d))
    return dx, dgb


_EPILOGUE_NONE, _EPILOGUE_RELU_MASK, _EPILOGUE_RESIDUAL = 0, 1, 2
_DGRAD_SITES = {  # (K, N, epilogue) of the four data-gradient GEMMs of a layer of each width
    site for d, f in WIDTHS.items() for site in (
        (d, f, _EPILOGUE_RELU_MASK), (f, d, _EPILOGUE_RESIDUAL), (d, d, _EPILOGUE_NONE),
        (3 * d, d, _EPILOGUE_NONE))}


def _layer_width(n: int, k: int) -> int:
    """The width D of the layer whose weight shape ``(n, k)`` is (its narrow side)."""
    return min(n, k)


def linear_dgrad(dy, w, valid_len, relu_of=None, residual=None):
    """``dX = dY @ W`` (W in Linear layout), masked by ``relu_of > 0`` or plus
    ``residual`` (kernel ``linear_dgrad`` on CUDA, at the layer's four sites
    only; in bfloat16 on the tensor cores, S a multiple of
    :data:`BF16_GEMM_ROWS`; at D 768 in bfloat16 ``linear_dgrad_wgmma_bf16``,
    in float32 the stream-K walk ``linear_dgrad_d768``,
    :func:`dgrad_stream_plan`), all of one dtype. See
    :func:`linear_dgrad_reference`."""
    if _launch.on_cpu(dy, w, valid_len):
        return linear_dgrad_reference(dy, w, valid_len, relu_of, residual)
    if relu_of is not None and residual is not None:
        raise ValueError("linear_dgrad: one epilogue at a time")
    aux = relu_of if relu_of is not None else residual
    epilogue = (_EPILOGUE_RELU_MASK if relu_of is not None
                else _EPILOGUE_RESIDUAL if residual is not None else _EPILOGUE_NONE)
    if dy.dim() != 3 or dy.shape[1] % ROW_BLOCK or w.dim() != 2 or w.shape[0] != dy.shape[2] \
            or (w.shape[0], w.shape[1], epilogue) not in _DGRAD_SITES:
        raise ValueError(f"linear_dgrad: dy {tuple(dy.shape)}, w {tuple(w.shape)}, "
                         f"epilogue {epilogue}: not a site the kernel is built for")
    bsz, s, k = dy.shape
    n, dt = w.shape[1], dy.dtype
    tc = _copy_align("linear_dgrad", dt, s)
    out = torch.empty((bsz, s, n), dtype=dt, device=dy.device)
    name, fn = _library_fn("linear_dgrad", dt)
    operands = (_rows("dy", dy, bsz, s, k, dt, tc), _launch.vector_operand(w, "w", dt, tc),
                None if aux is None else _rows("aux", aux, bsz, s, n, dt, tc), out.data_ptr(),
                epilogue)
    rows = (_launch.valid_len_operand(valid_len, bsz, dy.device), bsz * s, k, n, s,
            _launch.stream(dy.device))
    if _wgmma(dt, _layer_width(k, n)):
        status = _build.library().linear_dgrad_wgmma_bf16(*operands, *rows)
    elif _layer_width(k, n) == D_WIDE:  # the float32 stream-K walk
        slots = dgrad_stream_slots(bsz * s, n, dgrad_stream_blocks(k, n, epilogue, dy.device))
        partial = torch.empty((slots, ROW_BLOCK * DGRAD_F32_COLUMNS[n]), dtype=torch.float32,
                              device=dy.device)
        # the images' first entries and the count, then the computed 32-row tiles' first rows
        tile_list = torch.empty(bsz + 1 + bsz * s // ROW_BLOCK, dtype=torch.int32,
                                device=dy.device)
        status = _build.library().linear_dgrad_d768(*operands, partial.data_ptr(), slots,
                                                    tile_list.data_ptr(), *rows)
    else:
        status = fn(*operands, *rows)
    _build.check(status, name)
    _launch.counted(instance(name, _layer_width(k, n)))
    return out


def dgrad_stream_blocks(k: int, n: int, epilogue: int, device) -> int:
    """The grid of the float32 ``linear_dgrad`` at D 768 at site ``(k, n,
    epilogue)`` on ``device``: as many blocks as the card holds at the walk's
    occupancy, as its C side reads them from the runtime
    (``linear_dgrad_d768_blocks``), asked once a site and device."""
    key = (device, k, n, epilogue)
    if key not in _DGRAD_F32_BLOCKS:
        blocks = _build.library().linear_dgrad_d768_blocks(k, n, epilogue)
        if blocks <= 0:  # minus a cudaError, or no block of the walk fits an SM
            raise RuntimeError(f"linear_dgrad_d768_blocks: {blocks}")
        _DGRAD_F32_BLOCKS[key] = blocks
    return _DGRAD_F32_BLOCKS[key]


def dgrad_stream_slots(m: int, n: int, blocks: int) -> int:
    """Partial slots of the float32 ``linear_dgrad`` at D 768 for ``m`` rows,
    output width ``n`` and a walk of ``blocks`` blocks: one a 32-row tile and
    column slice, plus ``blocks`` - 1 (slot tile + block); each holds 32 x
    ``DGRAD_F32_COLUMNS[n]`` float32."""
    return m // ROW_BLOCK * (n // DGRAD_F32_COLUMNS[n]) + blocks - 1


def dgrad_stream_plan(valid_len, s_pad: int, k: int, n: int, blocks: int) -> list:
    """What each of the ``blocks`` blocks of the float32 ``linear_dgrad`` at D
    768 (``dY (M, k) @ W (k, n)``) sums, as its kernel assigns it: the units
    (first row of a computed 32-row tile, column slice, slab of
    :data:`DGRAD_F32_SLAB` columns of K) of every output tile t = (computed
    tile i, slice j), t = i x slices + j, its slabs in order, cut into
    contiguous shares, block b taking units ``[b U // G, (b + 1) U // G)`` of
    the U. Per block, its segments in order: ``(tile, slot, units)``, slot
    None where the segment is the whole tile (the block writes dX), else tile
    + b."""
    rows = wgrad_split_tiles(valid_len, s_pad, 1)[0]
    slices, slabs = n // DGRAD_F32_COLUMNS[n], k // DGRAD_F32_SLAB
    units = [(r, j, q) for r in rows for j in range(slices) for q in range(slabs)]
    total = len(units)
    plan = []
    for blk in range(blocks):
        segments = []
        for u in range(blk * total // blocks, (blk + 1) * total // blocks):
            if not segments or segments[-1][0] != u // slabs:
                segments.append((u // slabs, []))
            segments[-1][1].append(units[u])
        plan.append([(t, None if len(us) == slabs else t + blk, us) for t, us in segments])
    return plan


def dgrad_stream_fixups(tile: int, slabs: int, tiles: int, blocks: int) -> list:
    """The slots the second pass of the float32 ``linear_dgrad`` at D 768 adds,
    in order, for output ``tile`` of ``tiles`` when a tile has ``slabs`` units
    and the walk ``blocks`` blocks, by its kernel's arithmetic (that of
    :func:`wgrad_stream_fixups`); none when one block's share holds the whole
    tile (that block wrote it)."""
    slots = wgrad_stream_fixups(tile, slabs, tiles, blocks)
    return slots if len(slots) > 1 else []


# the four weight shapes of a layer of each width
_WGRAD_SHAPES = set(WGRAD_BF16_TILES) | set(WGRAD_WGMMA_TILES)


def wgrad_splits(bsz: int, s_pad: int, n: int, k: int, dtype=torch.bfloat16) -> int:
    """Row splits of ``linear_wgrad`` at weight shape ``(n, k)`` for
    activations of ``dtype``: output tiles (:data:`WGRAD_BF16_TILES` or
    :data:`WGRAD_F32_TILES`) x splits fill :data:`WGRAD_BF16_BLOCKS` or
    :data:`WGRAD_F32_BLOCKS` blocks once (at most :data:`WGRAD_SPLITS`), and
    no split is planned beyond the batch's
    32-row tiles. Its partial sums are ``(splits, n * k + n)`` float32,
    bounded whatever the batch."""
    if dtype == torch.float32:
        tn, tk = WGRAD_F32_TILES[(n, k)]
        most = WGRAD_F32_BLOCKS // ((n // tn) * (k // tk))
    else:
        tn, tk = WGRAD_BF16_TILES[(n, k)]
        most = WGRAD_BF16_BLOCKS // ((n // tn) * (k // tk))
    return max(1, min(most, WGRAD_SPLITS, bsz * s_pad // ROW_BLOCK))


def _stream_walk(dtype) -> tuple:
    """``(tiles, unit rows, blocks)`` of the stream-K walk of ``linear_wgrad``
    at D 768 for activations of ``dtype``."""
    if dtype == torch.float32:
        return WGRAD_F32_STREAM_TILES, ROW_BLOCK, WGRAD_F32_BLOCKS
    return WGRAD_WGMMA_TILES, WGRAD_WGMMA_UNIT, WGRAD_WGMMA_BLOCKS


def wgrad_stream_tiles(n: int, k: int, dtype=torch.bfloat16) -> int:
    """Output tiles of ``linear_wgrad`` at D 768 at weight shape ``(n, k)``
    (:data:`WGRAD_WGMMA_TILES` or :data:`WGRAD_F32_STREAM_TILES`)."""
    tn, tk = _stream_walk(dtype)[0][(n, k)]
    return (n // tn) * (k // tk)


def wgrad_stream_slots(n: int, k: int, dtype=torch.bfloat16) -> int:
    """Partial slots of ``linear_wgrad`` at D 768: tiles + blocks - 1,
    whatever the batch; each slot holds a tile's partial dW and db, ``tn * tk
    + tn`` float32."""
    return wgrad_stream_tiles(n, k, dtype) + _stream_walk(dtype)[2] - 1


def wgrad_stream_plan(valid_len, s_pad: int, n: int, k: int, dtype=torch.bfloat16) -> list:
    """What each block of ``linear_wgrad`` at D 768 sums, as its kernel
    assigns it: the units (in bfloat16 two computed 32-row tiles each, in the
    order of :func:`wgrad_split_tiles`, an odd last tile alone; in float32 one)
    of every output tile, tile-major, cut into the walk's G blocks'
    contiguous shares, block b taking units ``[b U // G, (b + 1) U // G)`` of
    the U. Per block, its segments in order: ``(tile, slot, first rows of the
    32-row tiles it sums)``, slot = tile + b."""
    _, unit, blocks = _stream_walk(dtype)
    rows = wgrad_split_tiles(valid_len, s_pad, 1)[0]
    units = [rows[i:i + unit // ROW_BLOCK] for i in range(0, len(rows), unit // ROW_BLOCK)]
    total = wgrad_stream_tiles(n, k, dtype) * len(units)
    plan = []
    for blk in range(blocks):
        segments = []
        for u in range(blk * total // blocks, (blk + 1) * total // blocks):
            t = u // len(units)
            if not segments or segments[-1][0] != t:
                segments.append((t, t + blk, []))
            segments[-1][2].extend(units[u % len(units)])
        plan.append(segments)
    return plan


def wgrad_stream_fixups(tile: int, units: int, tiles: int,
                        blocks: int = WGRAD_WGMMA_BLOCKS) -> list:
    """The slots the second pass of ``linear_wgrad`` at D 768 adds, in order,
    for output ``tile`` of ``tiles`` when a tile has ``units`` units and the
    walk ``blocks`` blocks (G), by its kernel's arithmetic: its units ``[tile
    C, tile C + C)`` lie in the shares of blocks ``b(tile C) .. b(tile C + C -
    1)``, b(u) = ((u + 1) G - 1) // U, skipping blocks with no units."""
    total = tiles * units
    if total == 0:
        return []
    lo = ((tile * units + 1) * blocks - 1) // total
    hi = ((tile * units + units) * blocks - 1) // total
    return [tile + b for b in range(lo, hi + 1)
            if b * total // blocks < (b + 1) * total // blocks]


def wgrad_split_tiles(valid_len, s_pad: int, splits: int) -> list:
    """The first rows of the 32-row tiles each split of ``linear_wgrad`` sums
    (both dtypes), as its kernel assigns them: the computed tiles
    (those that hold a valid row), image by image, cut into ``splits``
    contiguous shares, split ``i`` taking list entries
    ``[i * T // splits, (i + 1) * T // splits)`` of the T tiles."""
    rows = [b * s_pad + t * ROW_BLOCK for b, n in enumerate(valid_len)
            for t in range(min(s_pad // ROW_BLOCK, -(-max(int(n), 0) // ROW_BLOCK)))]
    total = len(rows)
    return [rows[i * total // splits:(i + 1) * total // splits] for i in range(splits)]


def linear_wgrad(dy, x, valid_len, ln=None):
    """``(dW, db) = (dY^T X', colsum dY)`` in float32 over the rows the
    forward computed, with ``X' = LN(X)`` from ``ln = (mean, rstd, g, beta)``
    (kernel ``linear_wgrad`` on CUDA, at the layer's four weight shapes only).
    At D 192 and in float32 X' is normed as X is staged and the rows split by
    :func:`wgrad_splits`, in bfloat16 on the tensor cores; at D 64 the same
    with tiles of their own (:data:`WGRAD_F32_TILES`, :data:`WGRAD_BF16_TILES`); at D 768
    the walk of :func:`wgrad_stream_plan` (``linear_wgrad_d768`` in float32,
    ``linear_wgrad_wgmma_bf16`` in bfloat16), with LN1 in a pre-pass into a
    scratch of x's shape. dy and x of one
    dtype, 16-byte aligned; the partial sums, their fixed-order reduce and
    the result are float32 for both dtypes. See :func:`linear_wgrad_reference`."""
    if _launch.on_cpu(dy, x, valid_len):
        return linear_wgrad_reference(dy, x, valid_len, ln)
    if dy.dim() != 3 or x.dim() != 3 or dy.shape[:2] != x.shape[:2] \
            or dy.shape[1] % ROW_BLOCK or (dy.shape[2], x.shape[2]) not in _WGRAD_SHAPES:
        raise ValueError(f"linear_wgrad: dy {tuple(dy.shape)}, x {tuple(x.shape)}: not a "
                         "weight shape the kernel is built for")
    bsz, s, n = dy.shape
    k, dt = x.shape[2], dy.dtype
    stream = _layer_width(n, k) == D_WIDE
    # every instance's partial sums are bounded whatever the batch
    if stream:
        tn, tk = _stream_walk(dt)[0][(n, k)]
        partial = torch.empty((wgrad_stream_slots(n, k, dt), tn * tk + tn), dtype=torch.float32,
                              device=dy.device)
    else:
        splits = wgrad_splits(bsz, s, n, k, dt)
        partial = torch.empty((splits, n * k + n), dtype=torch.float32, device=dy.device)
    dwb = torch.empty(n * k + n, dtype=torch.float32, device=dy.device)
    if ln is None:
        ln_ptrs = (None,) * 4
    else:
        mean, rstd, g, b = ln
        if g.shape != (k,) or b.shape != (k,) or k not in WIDTHS:
            raise ValueError(f"linear_wgrad: g {tuple(g.shape)}, b {tuple(b.shape)} (the "
                             f"kernel norms X of width {' or '.join(map(str, WIDTHS))} only)")
        ln_ptrs = (_row_stats("mean", mean, bsz, s), _row_stats("rstd", rstd, bsz, s),
                   _launch.vector_operand(g, "g"), _launch.vector_operand(b, "b"))
    name, fn = _library_fn("linear_wgrad", dt)
    operands = (_rows("dy", dy, bsz, s, n, dt, 16), _rows("x", x, bsz, s, k, dt, 16), *ln_ptrs)
    vl = _launch.valid_len_operand(valid_len, bsz, dy.device)
    if stream:
        h = None if ln is None else torch.empty_like(x)  # the pre-pass's scratch
        fn = (_build.library().linear_wgrad_d768 if dt == torch.float32 else
              _build.library().linear_wgrad_wgmma_bf16)
        status = fn(*operands, _ptr(h), partial.data_ptr(), dwb.data_ptr(), vl, bsz * s, n, k, s,
                    _stream_walk(dt)[2], _launch.stream(dy.device))
    else:
        status = fn(*operands, partial.data_ptr(), dwb.data_ptr(), vl, bsz * s, n, k, s, splits,
                    _launch.stream(dy.device))
    _build.check(status, name)
    _launch.counted(instance(name, _layer_width(n, k)))
    return dwb[:n * k].view(n, k), dwb[n * k:]


# ------------------------------------------------------------- the layer ----
# The steps of the layer: the wrappers (kernels on CUDA tensors, plain versions
# on CPU tensors) or the plain versions on any device.
KERNEL_STEPS = SimpleNamespace(
    ln_linear=ln_linear, linear_relu=linear_relu, linear_residual_ln=linear_residual_ln,
    attention=fa.attention_forward, attention_bwd=fa.prefix_attention_bwd,
    layernorm_bwd=layernorm_bwd, linear_dgrad=linear_dgrad, linear_wgrad=linear_wgrad)


def _plain_attention(q, k, v, valid_len, num_heads, with_lse):
    out = fa.prefix_flash_attention_reference(q, k, v, valid_len, num_heads, with_lse)
    return out if with_lse else (out, None)


PLAIN_STEPS = SimpleNamespace(
    ln_linear=ln_linear_reference, linear_relu=linear_relu_reference,
    linear_residual_ln=linear_residual_ln_reference, attention=_plain_attention,
    attention_bwd=fa.prefix_flash_attention_backward_reference,
    layernorm_bwd=layernorm_bwd_reference, linear_dgrad=linear_dgrad_reference,
    linear_wgrad=linear_wgrad_reference)


def _pad_seq(x: torch.Tensor) -> torch.Tensor:
    s = x.shape[1]
    s_pad = -(-s // SEQ_PAD) * SEQ_PAD
    return x if s == s_pad else F.pad(x, (0, 0, 0, s_pad - s))


def pack_weights(weights, dtype: torch.dtype) -> tuple:
    """The 12 layer parameters as the kernels take them
    (``fused_block.py:467-479``, ``_pack_weights``): the matrices and biases
    cast to the activation dtype, the LayerNorm parameters as they are
    (float32). A no-op for float32."""
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = weights
    c = [t.to(dtype) for t in (wqkv, bqkv, wout, bout, w1, b1f, w2, b2f)]
    return (*c[:4], g1, b1, g2, b2, *c[4:])


def layer_forward(steps, x, valid_len, weights, num_heads, eps1, eps2, save):
    """``y``, and with ``save`` the residuals ``(attn, x2, r2, lse, stats)``,
    stats the (mean, rstd) pairs of LN1, the site-2 norm1 and LN2. The
    weights are the float32 parameters; they are cast here to x's dtype."""
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = pack_weights(weights,
                                                                             x.dtype)
    d = x.shape[2]
    if not save:
        qkv = steps.ln_linear(x, g1, b1, eps1, wqkv, bqkv, valid_len)
        a, _ = steps.attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                               valid_len, num_heads, False)
        x2 = steps.linear_residual_ln(a, wout, bout, x, g1, b1, eps1, valid_len)
        hid = steps.linear_relu(x2, w1, b1f, valid_len)
        return steps.linear_residual_ln(hid, w2, b2f, x2, g2, b2, eps2, valid_len)
    qkv, mu1, rstd1 = steps.ln_linear(x, g1, b1, eps1, wqkv, bqkv, valid_len, save=True)
    a, lse = steps.attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                             valid_len, num_heads, True)
    x2, mu2, rstd2, _ = steps.linear_residual_ln(a, wout, bout, x, g1, b1, eps1,
                                                 valid_len, save=True)
    hid = steps.linear_relu(x2, w1, b1f, valid_len)
    y, mu3, rstd3, r2 = steps.linear_residual_ln(hid, w2, b2f, x2, g2, b2, eps2,
                                                 valid_len, save=True)
    return y, (a, x2, r2, lse, (mu1, rstd1, mu2, rstd2, mu3, rstd3))


def layer_backward(steps, dy, x, valid_len, attn, x2, r2, lse, stats, weights,
                    num_heads, eps1):
    """``(dx, 12 parameter grads)`` of the layer from the saved residuals, the
    TPU kernel's phases B', C' and D' (``fused_block.py:254-432``) as a chain;
    h, qkv and the FFN hidden are recomputed, not saved. dx has dy's dtype,
    the parameter gradients are float32."""
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = pack_weights(weights,
                                                                             dy.dtype)
    mu1, rstd1, mu2, rstd2, mu3, rstd3 = stats
    d = x.shape[2]
    # B': LN2, the FFN, then the site-2 norm1
    dr2, dgb2 = steps.layernorm_bwd(dy, r2, mu3, rstd3, g2, valid_len)
    hid = steps.linear_relu(x2, w1, b1f, valid_len)
    dw2, db2f = steps.linear_wgrad(dr2, hid, valid_len)
    dz1 = steps.linear_dgrad(dr2, w2, valid_len, relu_of=hid)
    del hid
    dw1, db1f = steps.linear_wgrad(dz1, x2, valid_len)
    dx2 = steps.linear_dgrad(dz1, w1, valid_len, residual=dr2)
    del dz1
    # the site-2 pre-LN sum x + (a @ Wout^T + bout), recomputed
    r = steps.linear_residual_ln(attn, wout, bout, x, g1, b1, eps1, valid_len, save=True)[3]
    dr, dgb1 = steps.layernorm_bwd(dx2, r, mu2, rstd2, g1, valid_len)
    del r, dx2
    dwout, dbout = steps.linear_wgrad(dr, attn, valid_len)
    da = steps.linear_dgrad(dr, wout, valid_len)
    # C': the attention, from recomputed q, k, v
    qkv = steps.ln_linear(x, g1, b1, eps1, wqkv, bqkv, valid_len)
    dqkv = steps.attention_bwd(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                               attn, lse, da, valid_len, num_heads)
    del qkv, da
    # D': the QKV projection with LN1 applied as x is staged, then the site-1
    # LN1, whose dgamma/dbeta add into site 2's
    dwqkv, dbqkv = steps.linear_wgrad(dqkv, x, valid_len, ln=(mu1, rstd1, g1, b1))
    dh = steps.linear_dgrad(dqkv, wqkv, valid_len)
    dx, dgb1 = steps.layernorm_bwd(dh, x, mu1, rstd1, g1, valid_len, residual=dr, dgb=dgb1)
    return (dx, dwqkv, dbqkv, dwout, dbout, dgb1[:d], dgb1[d:], dgb2[:d], dgb2[d:],
            dw1, db1f, dw2, db2f)


class FusedEncoderBlock(torch.autograd.Function):
    """The layer with a gradient. Forward: the chain with the save outputs on;
    it saves exactly the JAX residual set (``fused_block.py:587-595``), the
    activations in x's dtype and the lse and stats in float32. Backward:
    :func:`layer_backward`. ``steps`` is :data:`KERNEL_STEPS` (the kernel
    wrappers) or :data:`PLAIN_STEPS` (the plain chains forward and backward,
    which keep no graph of their insides: the reference at sizes where
    autograd of the plain forward would not fit). Takes x already padded to
    :data:`SEQ_PAD`; the weights are the float32 parameters, whose gradients
    come back in float32."""

    @staticmethod
    def forward(ctx, x, valid_len, num_heads, eps1, eps2, steps, *weights):
        y, (attn, x2, r2, lse, stats) = layer_forward(
            steps, x, valid_len, weights, num_heads, eps1, eps2, save=True)
        ctx.save_for_backward(x, valid_len, attn, x2, r2, lse, *stats, *weights)
        ctx.num_heads, ctx.eps1, ctx.steps = num_heads, eps1, steps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, valid_len, attn, x2, r2, lse, *rest = ctx.saved_tensors
        stats, weights = rest[:6], rest[6:]
        dx, *grads = layer_backward(ctx.steps, dy.contiguous(), x, valid_len, attn,
                                     x2, r2, lse, stats, weights, ctx.num_heads, ctx.eps1)
        return (dx, None, None, None, None, None,
                *(gr.reshape(w.shape) for gr, w in zip(grads, weights)))


def fused_encoder_block(x, valid_len, wqkv, bqkv, wout, bout, g1, b1, g2, b2,
                        w1, b1f, w2, b2f, num_heads: int, eps1: float = 1e-5,
                        eps2: float = 1e-5) -> torch.Tensor:
    """One ChAdaViT encoder layer. x ``(B, S, D)``; returns ``(B, S, D)``.

    Weights in ``nn.Linear`` layout: wqkv ``(3D, D)``, wout ``(D, D)``,
    w1 ``(F, D)``, w2 ``(D, F)``, float32. x is float32 or bfloat16, and the
    layer computes in x's dtype (module docstring). On CUDA every step is a
    kernel launch, at the widths (D, F) of :data:`WIDTHS` only (ChAdaViT-moyen's
    192/2048, ChAdaViT-B/16's 768/2048 and the smoke configs' 64/2048): at any
    other width it raises
    ``NotImplementedError`` (the chain's instances at that width are not
    ported). When autograd records the call (grad mode on and an input that
    requires grad) it runs :class:`FusedEncoderBlock`; otherwise (the teacher,
    serving) the chain without the save outputs.
    """
    if valid_len is None:
        raise ValueError("fused_encoder_block needs valid_len")
    weights = (wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f)
    d, f = x.shape[2], w1.shape[0]
    if WIDTHS.get(d) != f and not _launch.on_cpu(x, valid_len):
        raise NotImplementedError(
            f"fused_encoder_block: D {d}, FFN {f}, {num_heads} heads: the layer chain's "
            f"kernels are built for (D, FFN) in {sorted(WIDTHS.items())}; the chain's D {d} "
            "instances are not ported. Set block_impl='xla' (the unfused layer)")
    s = x.shape[1]
    xp = _pad_seq(x)
    if _launch.needs_grad(x, *weights):
        y = FusedEncoderBlock.apply(xp, valid_len, num_heads, eps1, eps2, KERNEL_STEPS,
                                    *weights)
    else:
        y = layer_forward(KERNEL_STEPS, xp, valid_len, weights, num_heads, eps1, eps2,
                           save=False)
    return y if y.shape[1] == s else y[:, :s]


def fused_encoder_block_reference(x, valid_len, wqkv, bqkv, wout, bout, g1, b1,
                                  g2, b2, w1, b1f, w2, b2f, num_heads: int,
                                  eps1: float = 1e-5, eps2: float = 1e-5):
    """The same layer through the plain versions only, on any device, with
    plain autograd."""
    weights = (wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f)
    return layer_forward(PLAIN_STEPS, x, valid_len, weights, num_heads, eps1, eps2,
                          save=False)


def fused_encoder_block_backward_reference(dy, x, valid_len, attn, x2, r2, lse, stats,
                                           weights, num_heads: int, eps1: float = 1e-5):
    """The backward chain through the plain version of every step, on any
    device: ``(dx, 12 parameter grads)`` from the residuals that
    :class:`FusedEncoderBlock` saves (``stats`` the six LN stat rows,
    ``weights`` the 12 parameters)."""
    return layer_backward(PLAIN_STEPS, dy, x, valid_len, attn, x2, r2, lse, stats,
                           weights, num_heads, eps1)
