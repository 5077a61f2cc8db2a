#!/usr/bin/env python3
"""Smoke run of chadavit_tpu_torch on one NVIDIA GPU: the served embedding path,
the DINO train step and the pretrain entry point of ChAdaViT-moyen through the
port's hand-written CUDA kernels, in float32 and in bfloat16 (the canonical
pretrain precision: float32 parameters, bfloat16 activations). Every kernel
has a float32 and a bfloat16 instance (C entry points ``name`` and
``name_bf16``).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds at its start and end:

0. guard: a watchdog ends a hang after WATCHDOG_S with a traceback; no CUDA
   device means exit 1 (there is no CPU path); TF32 off; the card's name and
   power limit from nvidia-smi.
1. build: nvcc compiles csrc/*.cu (layernorm.cu among them), one process per
   source, into one library (cold build seconds); beside it, nvcc -Xptxas -v
   on csrc/linear_fwd_bf16.cu, csrc/linear_bwd_bf16.cu,
   csrc/prefix_attention_bf16.cu, csrc/prefix_attention.cu,
   csrc/prefix_attention_bwd.cu, csrc/fused_block.cu, csrc/fused_block_bwd.cu
   and csrc/layernorm.cu prints the registers, shared memory and spills of
   the tensor-core kernels, of the float32 attention forward and of the
   backward's two kernels, of the float32 ln_linear, linear_relu,
   linear_residual_ln and linear_dgrad, of layernorm_bwd's and the float32
   linear_wgrad's two passes and of ln_bwd's four instances at D 192 (the
   model's width), none of which may spill.
2. each kernel instance against its plain PyTorch version at hub shapes (B 8,
   S_pad 2048, D 192, F 2048, 2 heads, 1..10 channels), float32 on the
   inputs of seed 0, then bfloat16 on those of each of BF16_SEEDS (the worst
   bf16 readings are printed, the bounds are a few times them): the forward
   kernels, their save outputs (LN stats, pre-LN sum,
   lse), then every backward kernel on the inputs the layer's backward gives
   it (linear_dgrad, linear_wgrad and the attention backward twice, for the
   same bits); in float32
   linear_residual_ln twice at each site, with and without its save outputs,
   for the same bits, and the attention forward with its lse for zeros and
   lse 1e30 on the 64-query tiles past valid_len; in bfloat16
   the tensor-core ln_linear, linear_relu and linear_residual_ln (K1a, K1c,
   K1b) once more, K1a and each K1b site with and without its save outputs,
   every call twice for the same bits and with zeros on the tiles past
   valid_len (and how many qkv entries and hid ReLU masks differ from the
   plain versions); the whole layer forward; the layer's backward through
   FusedEncoderBlock against the plain backward chain on the Function's own
   residuals (in bfloat16 with the kernel's recompute of the FFN hidden, as
   the Function's: backward_reference; and, in float32, against
   torch.autograd.grad of fused_encoder_block_reference), with a cotangent
   that is zero past valid_len. Then the tail rows: a cotangent on every row of the tiles that
   hold a valid row (32-row tiles of the layer, 64-query tiles of the
   attention), K2 through FusedEncoderBlock and K4 through
   PrefixFlashAttention against the plain backward chains, in both dtypes.
   Then the LayerNorm kernels (ln_fwd, ln_bwd) against their plain versions
   on the same rows (B x S_pad rows of D 192), with and without the residual,
   eps 1e-5 and 1e-6, and run twice for the same bits (fixed-order sums).
3. the JAX fixtures: the depth-2, full-width model's CLS embeddings
   (tests/goldens/torch_port_cls_depth2.npz) and three DINO train steps of
   that backbone with the canonical head (tests/goldens/torch_port_dino_depth2.npz),
   then both again in bfloat16 (torch_port_cls_bf16_depth2.npz,
   torch_port_dino_bf16_depth2.npz).
4. the served path: load_chadavit16_moyen() at depth 12 with seeded weights,
   extract_embeddings on 24 images in batches of 8; the launch count of every
   kernel must be what 12 layers x 3 batches imply, and the embeddings must
   match the same model run through the plain versions on the card. Then the
   same in bfloat16 (load_chadavit16_moyen(dtype=torch.bfloat16)): only the
   bfloat16 instances launch, and the parameters stay float32.
4b. the train path: build_dino(DinoPretrainSpec()) at depth 12 on the card,
   synthetic_dino_batch of 8 images, 3 steps: the loss is finite, the launch
   count of every kernel is what 12 layers x 3 steps x (teacher + student)
   imply, and step 1 agrees with step 1 of a plain backbone
   (fused_encoder_block_reference) from the same state: the loss, and the
   cosine of each tensor's update (zero updates fail, the frozen prototypes
   must stay put); the first layer's backward at the train batch's shapes
   against the plain backward chain. Then the bfloat16 train path at the
   canonical batch (32 images x 2 global crops, depth 12, 3 steps): only the
   bfloat16 instances launch, step 1 agrees with step 1 of the same model
   through the plain chains (FusedEncoderBlock with the plain steps, forward
   and backward) in the same way, and the first layer's backward at these 64
   sequences holds to the bounds of phase 2; the partial-sum scratch of
   linear_wgrad_bf16 and layernorm_bwd at this batch, and of the float32
   linear_wgrad at the float32 train batch and at this one.
4c. the pretrain entry point: main_pretrain.main (the command line) and
   run_dino_pretrain on the canonical YAML
   (scripts/pretrain/dino_chada_vit_moyen.yaml: batch 32, bf16, depth 12)
   with data.dataset=synthetic and backbone.kwargs.ln_impl=pallas, the host
   multicrop loader and checkpoints in a temporary directory. (a) 4 steps
   straight through the command line; (b) 2 steps with a step checkpoint;
   (c) auto-resume from it to
   step 4: the metrics of steps 3-4 and the final train state of (c) equal
   (a)'s bit for bit. The launch count of every kernel in (a) is what 12
   layers x 4 steps x (teacher + student) imply, plus the final norm's
   ln_fwd (teacher and student) and ln_bwd (student). The host loader's time
   per batch beside the step's time, its device span and the time the step
   waited for its batch. Then block_impl=xla in float32 (batch 16): 2 steps,
   every LayerNorm (3 per layer and the final norm) through ln_fwd / ln_bwd,
   and step 1 against the same run with ln_impl=xla (plain LayerNorms): the
   loss, and the per-tensor cosine of the update directions.
5. times with CUDA events: each kernel instance (and the share of its bound
   it reaches; linear_residual_ln, linear_dgrad and linear_wgrad also site
   by site), its plain version, one PyTorch call for the same function (a
   yardstick the port never calls), its bound (ln_fwd and ln_bwd at the
   final norm's site, over every row: they take no valid_len); the device
   time by the profiler of ln_fwd, ln_bwd (ln_bwd also with the L2 cold: a
   buffer larger than the 50 MB L2 written before each call),
   ln_linear, linear_relu, linear_residual_ln and linear_dgrad (both also
   site by site),
   layernorm_bwd, linear_dgrad and linear_wgrad, whose small calls CUDA
   events time by the host's launch rate, and of the attention forward and
   backward (K3, K4), kernel by kernel (so each pass of layernorm_bwd and
   linear_wgrad on its own); K3 and K4 run twice for the same bits; the whole layer forward
   and backward; the served batch and the train step, in both dtypes.
6. one JSON line with every kernel instance, then the last line
   {"ok": true, "device": {...}}. A failed phase prints no last line and
   exits 1.
"""

import faulthandler
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

WATCHDOG_S = 900
GOLDENS = Path(__file__).resolve().parent / "tests" / "goldens"
FIXTURE = GOLDENS / "torch_port_cls_depth2.npz"
DINO_FIXTURE = GOLDENS / "torch_port_dino_depth2.npz"
FIXTURE_BF16 = GOLDENS / "torch_port_cls_bf16_depth2.npz"
DINO_FIXTURE_BF16 = GOLDENS / "torch_port_dino_bf16_depth2.npz"
CANONICAL = Path(__file__).resolve().parent / "scripts" / "pretrain" / "dino_chada_vit_moyen.yaml"

# hub shapes
B, S_PAD, D, H, FFN = 8, 2048, 192, 2, 2048
COUNTS = [1, 3, 5, 10, 2, 7, 9, 10]
N_PATCHES = 196
EPS1, EPS2 = 1e-5, 1e-5

# max abs error against the plain version on rows < valid_len (f32 on both
# sides; the kernels sum in another order than cuBLAS)
KERNEL_TOL = 1e-4
LAYER_TOL = 2e-4
# backward steps: their outputs reach the hundreds (sums over up to 16k rows),
# so the abs tolerance scales with the output's largest entry when that is > 1
GRAD_REL = 1e-4
FIXTURE_COS = 1 - 1e-5  # per-row cosine against the JAX fixture
FIXTURE_TOL = 5e-4      # max abs against the JAX fixture, after 2 layers
SERVED_COS = 1 - 1e-5   # per-row cosine, kernels against plain versions, 12 layers
# the DINO fixture: f32 on both sides through 3 steps of 2 layers, the head and
# LARS. Metrics and parameter norms carry summation order only; the norm of a
# parameter's change is a difference of nearby numbers, so it is looser.
DINO_METRIC_REL = 1e-4
DINO_NORM_REL = 1e-5
DINO_DELTA_REL = 1e-3
# the train path's step 1, kernels against the plain backbone
TRAIN_LOSS_REL = 1e-5
TRAIN_PARAM_COS = 1 - 1e-5
TRAIN_B, TRAIN_STEPS = 8, 3

# bfloat16 kernel instances against their plain bfloat16 versions, which round
# at the same points and sum in other orders: a value can land on the
# neighbouring bf16 and a chain carries such steps. A bf16 output may sit
# BF16_STEPS bf16 steps from the plain one at the reference's largest entry; an
# f32 output (LN stats, lse, parameter gradients: sums of bf16 operands) within
# BF16_F32_REL of its largest entry; the cosine over the rows the kernel
# computes is at least BF16_COS. Each bound is a few times the worst reading of
# phase 2 over BF16_SEEDS on an H100, which phase 2 prints (PERF.md section 6).
BF16_SEEDS = (0, 1, 2)
BF16_STEPS, BF16_F32_REL, BF16_COS = 3, 3e-3, 1 - 2e-5
# the bf16 JAX fixtures: the JAX XLA path rounds at its own points, the
# kernels at the Pallas kernels' (per-row cosine and max abs of the CLS);
# three DINO steps; the bounds of tests/test_torch_fixture_bf16.py, a few
# times the worst reading on the CPU and on the card
FIXTURE_BF16_COS, FIXTURE_BF16_TOL = 1 - 5e-5, 5e-2
DINO_BF16_METRIC_REL, DINO_BF16_NORM_REL, DINO_BF16_DELTA_REL = 5e-3, 1e-3, 5e-2
SERVED_BF16_COS = 1 - 2e-4  # per-row cosine, kernels against plain versions, 12 layers
# the bf16 train path at the canonical batch (scripts/pretrain/
# dino_chada_vit_moyen.yaml: 32 images, 2 global crops); step 1 against the
# plain chains: the loss, and the cosine of every parameter tensor's update.
# The update bounds are a few times the worst reading on an H100 (PERF.md
# section 6): f32 1 - 1.7e-8, bf16 1 - 7.5e-4 (a wgrad kernel that drops the
# last 64 rows of every sequence reads 1 - 6.5e-3)
TRAIN_BF16_B = 32
TRAIN_BF16_LOSS_REL = 5e-5
TRAIN_UPDATE_COS = 1 - 1e-7       # float32, kernels against the plain backbone
TRAIN_BF16_UPDATE_COS = 1 - 3e-3  # bfloat16, kernels against the plain chains
# the pretrain entry point: the canonical recipe on synthetic data through the
# LayerNorm kernels; (a) straight, (b) stop with a step checkpoint, (c) resume
ENTRY = ["data.dataset=synthetic", "backbone.kwargs.ln_impl=pallas", "log_every=1",
         "checkpoint.enabled=true", "auto_resume.enabled=true"]
ENTRY_STEPS, ENTRY_STOP = 4, 2
# block_impl=xla, float32, LayerNorm kernels against plain LayerNorms: step 1's
# loss and update directions, the bounds of the float32 train path (4b)
ENTRY_XLA = ["precision=f32", "backbone.kwargs.block_impl=xla", "optimizer.batch_size=16",
             "checkpoint.step_frequency=1", "checkpoint.keep_prev=true"]
ENTRY_XLA_STEPS = 2
ENTRY_METRICS = ("dino_loss", "lr", "tau", "teacher_temp", "teacher_entropy",
                 "center_norm", "epoch")

# the card's peaks (NVIDIA H100 SXM data sheet): f32 outside the tensor cores,
# dense bf16 on the tensor cores, and HBM3 bandwidth. The bound of a float32
# instance is taken at the f32 rate, of a bfloat16 instance at the bf16 rate.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


class Phase:
    """Prints the start and end of a phase; records a failure."""

    def __init__(self, name: str, failures: list):
        self.name, self.failures = name, failures

    def __enter__(self):
        log(f"phase {self.name}: start")
        return self

    def check(self, ok: bool, what: str) -> None:
        log(f"  {'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            self.failures.append(f"{self.name}: {what}")

    def __exit__(self, *exc):
        log(f"phase {self.name}: end")
        return False


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def valid_rows_err(out, ref, valid_len):
    """(max abs error, max abs error over max |ref|) on the rows < valid_len."""
    err = mag = 0.0
    for i, n in enumerate(valid_len):
        err = max(err, (out[i, :n] - ref[i, :n]).abs().max().item())
        mag = max(mag, ref[i, :n].abs().max().item())
    return err, err / mag


def cosine_rows(a, b):
    import torch

    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_backbone(model, x, cc):
    """The model's CLS embeddings with every layer through the plain
    versions of the kernels (fused_encoder_block_reference, plain autograd),
    on x's device."""
    import torch
    import torch.nn.functional as F

    from chadavit_tpu_torch.ops.fused_block import SEQ_PAD, fused_encoder_block_reference

    emb, _ = model.tokenize(x, cc)
    s = emb.shape[1]
    emb = F.pad(emb, (0, 0, 0, -(-s // SEQ_PAD) * SEQ_PAD - s))
    valid_len = (1 + cc.to(torch.int32) * model.num_patches).to(torch.int32)
    for blk in model.blocks:
        emb = fused_encoder_block_reference(emb, valid_len, *blk.weights(), blk.num_heads,
                                            blk.layer_norm_eps, blk.layer_norm_eps)
    return model.final_norm(emb)[:, 0]


def plain_chain_backbone(model, x, cc):
    """The model's CLS embeddings with every layer through the plain chains
    of ops/fused_block.py: under grad FusedEncoderBlock with the plain steps
    (the plain backward chain, no graph of the layer's insides, so the
    reference fits at the canonical train batch), else the plain forward
    chain; on x's device, in the model's compute dtype."""
    import torch
    import torch.nn.functional as F

    from chadavit_tpu_torch.ops import fused_block

    emb, _ = model.tokenize(x, cc)
    s = emb.shape[1]
    emb = F.pad(emb, (0, 0, 0, -(-s // fused_block.SEQ_PAD) * fused_block.SEQ_PAD - s))
    valid_len = (1 + cc.to(torch.int32) * model.num_patches).to(torch.int32)
    for blk in model.blocks:
        eps = blk.layer_norm_eps
        if torch.is_grad_enabled():
            emb = fused_block.FusedEncoderBlock.apply(
                emb, valid_len, blk.num_heads, eps, eps, fused_block.PLAIN_STEPS,
                *blk.weights())
        else:
            emb = fused_block.layer_forward(fused_block.PLAIN_STEPS, emb, valid_len,
                                            blk.weights(), blk.num_heads, eps, eps,
                                            save=False)
    return model.final_norm(emb)[:, 0]


def check_updates(ph, what, names, kernel_dirs, plain_dirs, spec, bound):
    """Step 1's update of every trainable tensor (``names``, in the train
    state's order), the kernels' run against the plain run from the same
    state: a cosine of at least bound per tensor.
    The update is read from the LARS momentum buffer, which after the first
    step holds the step's direction (the update over -lr) before it meets
    the parameter (an update below half an ulp of a parameter near 1 leaves
    it unchanged). That direction is the gradient's, scaled per tensor, so
    this holds every gradient of the backward. The prototypes frozen in the
    first freeze_last_layer epochs must have a zero update on both sides;
    every other tensor a nonzero one on both (a zero update fails)."""
    import torch

    from chadavit_tpu_torch.train.dino_step import LAST_LAYER

    frozen = LAST_LAYER if spec.freeze_last_layer > 0 else ()
    cosines, still, bad = [], [], []
    for n, dk, dp in zip(names, kernel_dirs, plain_dirs):
        dk, dp = dk.double().flatten(), dp.double().flatten()
        if n in frozen:
            (bad if dk.any() or dp.any() else still).append(n)
        elif not (dk.any() and dp.any()):
            bad.append(n)
        else:
            cosines.append((torch.nn.functional.cosine_similarity(dk, dp, 0).item(), n))
    cosines.sort()
    ph.check(not bad and bool(cosines) and cosines[0][0] >= bound,
             f"{what}, per-tensor cosine of the updates, kernels against plain, "
             f"{len(cosines)} tensors: worst "
             + ", ".join(f"1 - {1 - c:.2e} ({n})" for c, n in cosines[:4])
             + f"; median 1 - {1 - cosines[len(cosines) // 2][0]:.2e} (>= 1 - {1 - bound:.0e}); "
             f"frozen, zero on both sides: {still}; zero update, or frozen and moved: {bad}")


def backward_reference(dy, x, valid_len, res, w, heads, eps):
    """The plain backward chain that FusedEncoderBlock's backward is held
    against, on the residuals ``res`` its own forward saved. In bfloat16 the
    chain's recompute of the FFN hidden is the kernel's, as the Function's
    is: the tensor-core linear_relu sums in another order than the plain
    version (which equals the CUDA-core kernel bit for bit), and a
    pre-activation that the two round to opposite sides of 0 flips a ReLU
    mask and moves a whole gradient row, the kink of ReLU and not a fault of
    a backward kernel. The forward kernels are held to their plain versions
    on their own in phase 2, which counts such flips."""
    import torch
    from types import SimpleNamespace

    from chadavit_tpu_torch.ops import fused_block

    steps = fused_block.PLAIN_STEPS
    if dy.dtype != torch.float32:
        steps = SimpleNamespace(**{**vars(steps), "linear_relu": fused_block.linear_relu})
    return fused_block.layer_backward(steps, dy, x, valid_len, *res, w, heads, eps)


def check_layer_backward(ph, backbone, batch, dt, seed=5):
    """The first encoder layer's backward at the train path's shapes (the
    batch's global crops as one pass, tokenized by backbone), with a seeded
    cotangent on every row the forward computes: FusedEncoderBlock on the card
    against the plain backward chain on the residuals its own forward saves,
    within the bounds of phase 2."""
    import torch
    import torch.nn.functional as F

    from chadavit_tpu_torch.ops import fused_block

    crops, cc = batch["crops"], batch["channel_counts"]
    cc = cc.repeat(crops.shape[0])
    with torch.no_grad():
        x, _ = backbone.tokenize(crops.reshape((-1,) + tuple(crops.shape[2:])), cc)
        s = x.shape[1]
        x = F.pad(x.to(dt), (0, 0, 0, -(-s // fused_block.SEQ_PAD) * fused_block.SEQ_PAD - s))
    valid = (1 + cc.to(torch.int32) * backbone.num_patches).to(torch.int32)
    rows = [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in valid.tolist()]
    blk = backbone.blocks[0]
    w = [t.detach() for t in blk.weights()]
    heads, eps = blk.num_heads, blk.layer_norm_eps
    gen = torch.Generator(device=x.device).manual_seed(seed)
    dy = torch.randn(x.shape, generator=gen, device=x.device)
    for i, n in enumerate(rows):
        dy[i, n:] = 0
    dy = dy.to(dt)
    xg = x.clone().requires_grad_(True)
    wg = [t.clone().requires_grad_(True) for t in w]
    grads = torch.autograd.grad(fused_block.fused_encoder_block(xg, valid, *wg, heads, eps, eps),
                                [xg, *wg], dy)
    with torch.no_grad():
        _, res = fused_block.layer_forward(fused_block.KERNEL_STEPS, x, valid, tuple(w), heads,
                                           eps, eps, save=True)
        same = backward_reference(dy, x, valid, res, w, heads, eps)
    torch.cuda.synchronize()
    pairs = [(gk, gr.reshape(gk.shape)) for gk, gr in zip(grads[1:], same[1:])]
    if dt == torch.float32:
        err = valid_rows_err(grads[0], same[0], rows)[0]
        worst = max((gk - gr).abs().max().item() / gr.abs().max().item() for gk, gr in pairs)
        ok = err <= KERNEL_TOL * max(1.0, same[0].abs().max().item()) and worst <= GRAD_REL
        what = f"dx max abs {err:.3e}, 12 grads worst max abs over max |ref| {worst:.3e}"
    else:
        checks = [bf16_err(grads[0], same[0], rows)] + [bf16_err(gk, gr) for gk, gr in pairs]
        ok = all(e <= t and c >= BF16_COS for e, t, c in checks)
        what = (f"dx and 12 grads, worst max abs over its bound "
                f"{max(e / t for e, t, _ in checks):.3f}, worst cosine "
                f"1 - {1 - min(c for _, _, c in checks):.2e}")
    tail_zero = all(not grads[0][i, n:].any().item() for i, n in enumerate(rows))
    ph.check(ok and tail_zero,
             f"{'bf16 ' if dt != torch.float32 else ''}layer backward at the train path's "
             f"shapes ({x.shape[0]} sequences of {x.shape[1]}, valid_len {min(valid.tolist())}"
             f"..{max(valid.tolist())}), FusedEncoderBlock against the plain backward chain: "
             f"{what}; dx zero on the zero-filled tiles: {tail_zero}")


def entry_cfg(extra):
    """The canonical pretrain config with ENTRY and ``extra`` applied, parsed
    as the entry point parses it."""
    from chadavit_tpu_torch.cli import apply_overrides
    from chadavit_tpu_torch.config import load_yaml, parse_pretrain_cfg

    return parse_pretrain_cfg(apply_overrides(load_yaml(str(CANONICAL)), ENTRY + extra))


def run_dir(base) -> Path:
    (run,) = [p for p in (Path(base) / "dino").iterdir() if p.is_dir()]
    return run


def read_logs(base) -> dict:
    """The run's logged metrics by step."""
    with open(run_dir(base) / "training_logs.txt") as f:
        return {r["step"]: r for r in map(json.loads, f)}


def final_ckpt(base) -> Path:
    (ckpt,) = [p for p in run_dir(base).iterdir() if p.is_dir()]
    return ckpt


def step_ckpt(base, step: int) -> Path:
    (ckpt,) = [p for p in run_dir(base).iterdir() if p.name.endswith(f"-step={step}")]
    return ckpt


def differing_entries(a, b, where="state") -> list:
    """The entries of two saved train states that are not equal bit for bit."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            return [where]
        return [d for k in a for d in differing_entries(a[k], b[k], f"{where}.{k}")]
    if isinstance(a, list):
        if len(a) != len(b):
            return [where]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in differing_entries(x, y, f"{where}[{i}]")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [where]
    return [] if a == b else [where]


def demangle(names):
    """C++ names as c++filt gives them, or as they are where it is missing."""
    import shutil

    if not names or shutil.which("c++filt") is None:
        return list(names)
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def bf16_step(x: float) -> float:
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def bf16_err(out, ref, rows=None):
    """(max abs error, its bound, cosine) of a bf16 kernel instance's output
    against its plain version, over the first rows[i] rows of image i when
    given: the bound is BF16_STEPS bf16 steps at the reference's largest entry
    for a bf16 output, BF16_F32_REL of it for a float32 one."""
    import torch

    mag_bound = (lambda m: BF16_STEPS * bf16_step(m)) if out.dtype == torch.bfloat16 else (
        lambda m: BF16_F32_REL * m)
    out, ref = out.float(), ref.float()
    if rows is not None:
        out = torch.cat([out[i, :n] for i, n in enumerate(rows)])
        ref = torch.cat([ref[i, :n] for i, n in enumerate(rows)])
    cos = torch.nn.functional.cosine_similarity(out.flatten().double(),
                                                ref.flatten().double(), 0).item()
    return (out - ref).abs().max().item(), mag_bound(ref.abs().max().item()), cos


class Recorder:
    """A namespace of the layer's plain steps that records every call (its
    arguments cloned before the call, and its result), so that each kernel
    can be replayed on the very inputs the layer's chain gives it."""

    def __init__(self, steps):
        self.calls = []
        for name, fn in vars(steps).items():
            setattr(self, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        import torch

        def clone(a):
            return a.clone() if isinstance(a, torch.Tensor) else (
                tuple(clone(t) for t in a) if isinstance(a, tuple) else a)

        def call(*args, **kwargs):
            saved = (clone(args), {k: clone(v) for k, v in kwargs.items()})
            out = fn(*args, **kwargs)
            # the result as it is now: layernorm_bwd's dgb is summed into later
            self.calls.append((name, saved, clone(out)))
            return out
        return call


def main() -> int:
    failures: list = []
    import numpy as np
    import torch

    # ---- 0. guard -----------------------------------------------------------
    with Phase("0 guard", failures):
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; the port's smoke run has no CPU path",
                  file=sys.stderr, flush=True)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = nvidia_smi_line()
        print(smi, flush=True)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    import torch.nn.functional as F

    from chadavit_tpu_torch import hub
    from chadavit_tpu_torch.models.chada_vit import chada_vit, random_state_dict
    from chadavit_tpu_torch.ops import _build, _launch, fused_block
    from chadavit_tpu_torch.ops import flash_attention as fa
    from chadavit_tpu_torch.train.pretrain import (
        DinoPretrainSpec,
        build_dino,
        synthetic_dino_batch,
    )

    dev = torch.device("cuda")
    fb_cu = "chadavit_tpu_torch/csrc/fused_block.cu"
    fbb_cu = "chadavit_tpu_torch/csrc/fused_block_bwd.cu"
    tc_cu = "chadavit_tpu_torch/csrc/linear_bwd_bf16.cu"
    fwd_tc_cu = "chadavit_tpu_torch/csrc/linear_fwd_bf16.cu"
    attn_cu = "chadavit_tpu_torch/csrc/prefix_attention.cu"
    attn_bwd_cu = "chadavit_tpu_torch/csrc/prefix_attention_bwd.cu"
    k1, k2 = "chadavit_tpu/ops/fused_block.py:91", "chadavit_tpu/ops/fused_block.py:211"
    from chadavit_tpu_torch.ops import layernorm as ln

    ln_cu = "chadavit_tpu_torch/csrc/layernorm.cu"
    kernels = {  # name -> wrapper, source, the TPU kernel it replaces
        "ln_linear_fwd": (fused_block.ln_linear, fb_cu, k1),
        "prefix_attention_fwd": (fa.prefix_flash_attention, attn_cu,
                                 "chadavit_tpu/ops/flash_attention.py:103"),
        "linear_relu_fwd": (fused_block.linear_relu, fb_cu, k1),
        "linear_residual_ln_fwd": (fused_block.linear_residual_ln, fb_cu, k1),
        "prefix_attention_bwd": (fa.prefix_attention_bwd, attn_bwd_cu,
                                 "chadavit_tpu/ops/flash_attention.py:157"),
        "layernorm_bwd": (fused_block.layernorm_bwd, fbb_cu, k2),
        "linear_dgrad": (fused_block.linear_dgrad, fbb_cu, k2),
        "linear_wgrad": (fused_block.linear_wgrad, fbb_cu, k2),
        "ln_fwd": (ln.ln_fwd, ln_cu, "chadavit_tpu/ops/layernorm.py:38"),
        "ln_bwd": (ln.ln_bwd, ln_cu, "chadavit_tpu/ops/layernorm.py:55"),
    }
    # every kernel instance: the float32 one keeps the kernel's name, the
    # bfloat16 one ends in _bf16 (its C entry point)
    bf16 = torch.bfloat16
    instances = {name + tag: (wrapper, src, replaces, dt)
                 for tag, dt in (("", torch.float32), ("_bf16", bf16))
                 for name, (wrapper, src, replaces) in kernels.items()}
    attn_tc_cu = "chadavit_tpu_torch/csrc/prefix_attention_bf16.cu"
    for name, src in (("ln_linear_fwd_bf16", fwd_tc_cu), ("linear_relu_fwd_bf16", fwd_tc_cu),
                      ("linear_residual_ln_fwd_bf16", fwd_tc_cu),
                      ("linear_dgrad_bf16", tc_cu), ("linear_wgrad_bf16", tc_cu),
                      ("prefix_attention_fwd_bf16", attn_tc_cu),
                      ("prefix_attention_bwd_bf16", attn_tc_cu)):  # the tensor-core kernels
        wrapper, _, replaces, dt = instances[name]
        instances[name] = (wrapper, src, replaces, dt)
    stats = {name: {"max_abs_err": 0.0} for name in instances}

    def reset_launches():
        _launch.LAUNCHES.clear()

    def read_launches():
        return {name: _launch.LAUNCHES[name] for name in instances}

    # ---- 1. build -----------------------------------------------------------
    with Phase("1 build", failures) as ph:
        cold = not (_build.BUILD_DIR / _build.source_hash()).exists()
        t = time.perf_counter()
        # every kernel of the tensor-core sources and of the float32
        # attention forward and backward (K3, K4), the float32 ln_linear
        # (K1a), linear_relu (K1c) and linear_residual_ln (K1b) of
        # fused_block.cu, the two passes of layernorm_bwd (K2a) and of the
        # float32 linear_wgrad (K2c) and the float32 linear_dgrad (K2b) of
        # fused_block_bwd.cu, and the instances of ln_bwd (K6, layernorm.cu)
        ptxas_sources = {fwd_tc_cu: (), tc_cu: (), attn_tc_cu: (), attn_cu: (), attn_bwd_cu: (),
                         fb_cu: ("ln_linear", "linear_relu", "linear_residual_ln"),
                         fbb_cu: ("layernorm_bwd", "reduce_ln_splits", "linear_wgrad",
                                  "reduce_wgrad_splits", "linear_dgrad"),
                         ln_cu: ("ln_bwd",)}
        ptxas = [_build.ptxas_report(Path(src).name)  # beside the build
                 for src in ptxas_sources]
        _build.library()
        ph.check(True, f"{'cold' if cold else 'warm'} build of {len(_build.sources())} "
                       f"sources: {time.perf_counter() - t:.2f} s")
        # registers, shared memory and spills of those kernels
        for (src, only), proc in zip(ptxas_sources.items(), ptxas):
            report = _build.ptxas_lines(proc)
            names = demangle([k["name"] for k in report])
            if only:
                kept = [i for i, n in enumerate(names) if any(o + "_kernel" in n for o in only)]
                report, names = [report[i] for i in kept], [names[i] for i in kept]
            if src == ln_cu:  # ln_bwd's instances at D 192, the model's width
                kept = [i for i, n in enumerate(names) if "16, 3>" in n]
                report, names = [report[i] for i in kept], [names[i] for i in kept]
            for k, short in zip(report, names):
                log(f"  ptxas {short}: {k.get('registers')} registers, {k.get('smem')} bytes "
                    f"static smem, spill stores {k.get('spill_stores')} B, spill loads "
                    f"{k.get('spill_loads')} B")
            ph.check(len(report) > 0 and all(k.get("spill_stores") == 0 == k.get("spill_loads")
                                             for k in report),
                     f"{Path(src).name}: {len(report)} kernels"
                     f"{' (' + ', '.join(only) + ')' if only else ''}, none spills")

    # ---- 2. kernels against their plain versions at hub shapes --------------
    valid_len = [1 + N_PATCHES * c for c in COUNTS]
    inputs = {}  # per dtype tag: the plain chain's intermediates, kept for phase 5
    with Phase("2 kernels vs plain", failures) as ph:
        vl = torch.tensor(valid_len, dtype=torch.int32, device=dev)
        # the tail cotangents cover every row of the tiles the forward computes
        layer_rows = [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in valid_len]
        query_rows = [-(-n // fa.SEQ_BLOCK) * fa.SEQ_BLOCK for n in valid_len]

        def draw(seed):
            """The layer's input, weights and cotangents of one seed."""
            rng = np.random.default_rng(seed)

            def dev_randn(*shape, scale=1.0):
                return torch.from_numpy((rng.standard_normal(shape) * scale)
                                        .astype(np.float32)).to(dev)

            x = dev_randn(B, S_PAD, D)
            w = [dev_randn(3 * D, D, scale=D ** -0.5), dev_randn(3 * D, scale=0.02),
                 dev_randn(D, D, scale=D ** -0.5), dev_randn(D, scale=0.02),
                 1 + dev_randn(D, scale=0.1), dev_randn(D, scale=0.05),
                 1 + dev_randn(D, scale=0.1), dev_randn(D, scale=0.05),
                 dev_randn(FFN, D, scale=D ** -0.5), dev_randn(FFN, scale=0.02),
                 dev_randn(D, FFN, scale=FFN ** -0.5), dev_randn(D, scale=0.02)]
            dy = dev_randn(B, S_PAD, D)
            dy_tail = dev_randn(B, S_PAD, D)
            dout_tail = dev_randn(B, S_PAD, D)
            for i, n in enumerate(valid_len):
                dy[i, n:] = 0
                dy_tail[i, layer_rows[i]:] = 0
                dout_tail[i, query_rows[i]:] = 0
            return x, w, dy, dy_tail, dout_tail

        # the worst bf16 readings over BF16_SEEDS, which the bf16 bounds come from:
        # bf16 steps of a bf16 output, share of the largest entry of an f32
        # output, 1 - cosine
        worst_bf16 = {"steps": (0.0, ""), "f32": (0.0, ""), "1 - cos": (0.0, "")}

        def bf16_check(out, ref, rows=None, what=""):
            err, tol, cos = bf16_err(out, ref, rows)
            key, unit = (("steps", BF16_STEPS) if out.dtype == bf16 else ("f32", BF16_F32_REL))
            for k, v in ((key, err * unit / tol if tol else 0.0), ("1 - cos", 1 - cos)):
                if v > worst_bf16[k][0]:
                    worst_bf16[k] = (v, f"{what}, seed {seed}")
            return err, tol, cos

        for seed, tag, dt in ((0, "", torch.float32),
                              *((s_, "_bf16", bf16) for s_ in BF16_SEEDS)):
            x, w, dy, dy_tail, dout_tail = draw(seed)
            if dt == bf16:
                log(f"  bf16 instances, inputs of seed {seed}")
            f32 = dt == torch.float32
            xd, dyd = x.to(dt), dy.to(dt)
            wd = fused_block.pack_weights(tuple(w), dt)  # the kernels' operands
            wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = wd
            # inputs of each step are the plain chain's own intermediates
            qkv = fused_block.ln_linear_reference(xd, g1, b1, EPS1, wqkv, bqkv)
            q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
            attn = fa.prefix_flash_attention_reference(q, k, v, vl, H)
            x2 = fused_block.linear_residual_ln_reference(attn, wout, bout, xd, g1, b1, EPS1)
            hid = fused_block.linear_relu_reference(x2, w1, b1f)
            inp = dict(x=xd, wd=wd, qkv=qkv, q=q, k=k, v=v, attn=attn, x2=x2, hid=hid, dy=dyd)
            if seed == 0:
                inputs[tag] = inp

            def note(name, err, tol, what):
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
                ph.check(err <= tol, f"{name}{what}: max abs {err:.3e} (tolerance {tol:.3g})")

            def note_bf16(name, out, ref, what, rows=valid_len):
                err, tol, cos = bf16_check(out, ref, rows, name + what)
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
                ph.check(err <= tol and cos >= BF16_COS,
                         f"{name}{what}: max abs {err:.3e} (tolerance {tol:.3g}), cosine "
                         f"1 - {1 - cos:.2e} (>= 1 - {1 - BF16_COS:.0e})")

            cases = {
                "ln_linear_fwd": [(lambda: fused_block.ln_linear(xd, g1, b1, EPS1, wqkv, bqkv, vl),
                                   lambda: qkv)],
                "prefix_attention_fwd": [(lambda: fa.prefix_flash_attention(q, k, v, vl, H),
                                          lambda: attn)],
                "linear_relu_fwd": [(lambda: fused_block.linear_relu(x2, w1, b1f, vl),
                                     lambda: hid)],
                "linear_residual_ln_fwd": [
                    (lambda: fused_block.linear_residual_ln(attn, wout, bout, xd, g1, b1, EPS1,
                                                            vl),
                     lambda: x2),
                    (lambda: fused_block.linear_residual_ln(hid, w2, b2f, x2, g2, b2, EPS2, vl),
                     lambda: fused_block.linear_residual_ln_reference(hid, w2, b2f, x2, g2, b2,
                                                                      EPS2)),
                ],
            }
            for name, runs in cases.items():
                worst = (0.0, 0.0)
                for kernel_fn, plain_fn in runs:
                    out = kernel_fn()
                    torch.cuda.synchronize()
                    if f32:
                        worst = max(worst, valid_rows_err(out, plain_fn(), valid_len))
                    else:
                        ph.check(out.dtype == bf16, f"{name + tag} writes bfloat16")
                        note_bf16(name + tag, out, plain_fn(), "")
                if f32:
                    note(name, worst[0], KERNEL_TOL, f" (max rel {worst[1]:.3e})")
            if f32:
                # the float32 K1b (csrc/fused_block.cu, sgemm_f32.cuh): each site
                # twice, with and without its save outputs, for the same bits
                for site, args, eps in ((" out projection", (attn, wout, bout, xd, g1, b1),
                                         EPS1),
                                        (" FFN2", (hid, w2, b2f, x2, g2, b2), EPS2)):
                    for save in (False, True):
                        first, again = (fused_block.linear_residual_ln(*args, eps, vl, save=save)
                                        for _ in range(2))
                        torch.cuda.synchronize()
                        firsts = first if save else (first,)
                        agains = again if save else (again,)
                        ph.check(all(torch.equal(a_, b_) for a_, b_ in zip(firsts, agains)),
                                 f"linear_residual_ln_fwd{site}{' save' * save}: the same bits "
                                 f"on a second call")
                        del first, again, firsts, agains
            if not f32:
                # the tensor-core K1a, K1c and K1b (csrc/linear_fwd_bf16.cu): K1a
                # and each K1b site also with its save outputs (out, LN stats,
                # and r), every call twice for the same bits, and zeros on the
                # zero-filled tiles
                tc_cases = [("ln_linear_fwd_bf16", "", False,
                             lambda: fused_block.ln_linear(xd, g1, b1, EPS1, wqkv, bqkv, vl),
                             lambda: qkv),
                            ("ln_linear_fwd_bf16", " save", True,
                             lambda: fused_block.ln_linear(xd, g1, b1, EPS1, wqkv, bqkv, vl,
                                                           save=True),
                             lambda: fused_block.ln_linear_reference(xd, g1, b1, EPS1, wqkv,
                                                                     bqkv, save=True)),
                            ("linear_relu_fwd_bf16", "", False,
                             lambda: fused_block.linear_relu(x2, w1, b1f, vl), lambda: hid)]
                for site, args, eps in ((" out projection", (attn, wout, bout, xd, g1, b1),
                                         EPS1),
                                        (" FFN2", (hid, w2, b2f, x2, g2, b2), EPS2)):
                    for save in (False, True):
                        tc_cases.append((
                            "linear_residual_ln_fwd_bf16", site + " save" * save, save,
                            (lambda a=args, e=eps, sv=save: fused_block.linear_residual_ln(
                                *a, e, vl, save=sv)),
                            (lambda a=args, e=eps, sv=save:
                             fused_block.linear_residual_ln_reference(*a, e, save=sv))))
                for name, what, save, kernel_fn, plain_fn in tc_cases:
                    first, again = kernel_fn(), kernel_fn()
                    torch.cuda.synchronize()
                    firsts = first if save else (first,)
                    agains = again if save else (again,)
                    ph.check(all(torch.equal(a_, b_) for a_, b_ in zip(firsts, agains)),
                             f"{name}{what}: the same bits on a second call")
                    ph.check(all(not o[i, n:].any().item() for o in firsts
                                 for i, n in enumerate(layer_rows)),
                             f"{name}{what}: zeros on the 32-row tiles past valid_len")
                    refs = plain_fn()
                    if save:
                        note_bf16(name, first[0], refs[0], what + " out")
                        note_bf16(name, torch.stack(first[1:3], -1),
                                  torch.stack(refs[1:3], -1), what + " mean, rstd")
                        if len(first) > 3:
                            note_bf16(name, first[3], refs[3], what + " r")
                    else:
                        note_bf16(name, first, refs, what + ", run twice")
                del tc_cases

            # the save outputs: LN stats, the pre-LN sum, the lse
            _, (ra, rx2, rr2, rlse, rst) = fused_block.layer_forward(
                fused_block.PLAIN_STEPS, xd, vl, tuple(w), H, EPS1, EPS2, save=True)
            _, (ka, kx2, kr2, klse, kst) = fused_block.layer_forward(
                fused_block.KERNEL_STEPS, xd, vl, tuple(w), H, EPS1, EPS2, save=True)
            torch.cuda.synchronize()
            inp.update(ra=ra, rx2=rx2, rr2=rr2, rlse=rlse, rst=rst)
            if not f32:  # qkv and ReLU masks of the kernels against the plain versions
                qk = fused_block.ln_linear(xd, g1, b1, EPS1, wqkv, bqkv, vl)
                differ = sum(int((qk[i, :n] != qkv[i, :n]).sum()) for i, n in enumerate(layer_rows))
                log(f"  ln_linear_fwd_bf16: {differ} entries of qkv differ from the plain version, "
                    f"in {sum(layer_rows) * 3 * D} entries")
                del qk
                hk = fused_block.linear_relu(kx2, w1, b1f, vl)
                hp = fused_block.linear_relu_reference(kx2, w1, b1f)
                flips = sum(int(((hk[i, :n] > 0) != (hp[i, :n] > 0)).sum())
                            for i, n in enumerate(layer_rows))
                differ = sum(int((hk[i, :n] != hp[i, :n]).sum())
                             for i, n in enumerate(layer_rows))
                log(f"  linear_relu_fwd_bf16 on the layer's own x2: {differ} entries differ "
                    f"from the plain version, {flips} of them ReLU mask flips, in "
                    f"{sum(layer_rows) * FFN} entries (the backward chain it is held against "
                    f"recomputes hid with the kernel)")
                del hk, hp
            st_err = [valid_rows_err(a[..., None], b_[..., None], valid_len)[0]
                      for a, b_ in zip(kst, rst)]
            lse_err = max((klse[i, :, :n] - rlse[i, :, :n]).abs().max().item()
                          for i, n in enumerate(valid_len))
            if f32:
                note("ln_linear_fwd", max(st_err[:2]), KERNEL_TOL, " save outputs mean, rstd")
                note("linear_residual_ln_fwd",
                     max(st_err[2:] + [valid_rows_err(kr2, rr2, valid_len)[0]]),
                     KERNEL_TOL, " save outputs mean, rstd, r2")
                note("prefix_attention_fwd", lse_err, KERNEL_TOL, " save output lse")
                # the 64-query tiles wholly past valid_len: zeros, and lse 1e30
                ko, kl = fa.attention_forward(q, k, v, vl, H, with_lse=True)
                torch.cuda.synchronize()
                ph.check(all(not ko[i, n:].any().item() and (kl[i, :, n:] == 1e30).all().item()
                             for i, n in enumerate(query_rows)),
                         "prefix_attention_fwd: zeros and lse 1e30 on the "
                         f"{sum(S_PAD - n for n in query_rows) // fa.SEQ_BLOCK} 64-query tiles "
                         "past valid_len")
                del ko, kl
            else:
                # f32 stats of bf16 rows that can differ by a rounding step
                ph.check(all(t.dtype == torch.float32 for t in (*kst, klse))
                         and all(t.dtype == bf16 for t in (ka, kx2, kr2)),
                         "bf16 save outputs: activations bf16, stats and lse f32")
                note_bf16("ln_linear_fwd_bf16", torch.stack(kst[:2], -1),
                          torch.stack(rst[:2], -1), " save outputs mean, rstd")
                note_bf16("linear_residual_ln_fwd_bf16", torch.stack(kst[2:], -1),
                          torch.stack(rst[2:], -1), " save outputs mean, rstd")
                note_bf16("linear_residual_ln_fwd_bf16", kr2, rr2, " save output r2")
                note_bf16("prefix_attention_fwd_bf16", klse.transpose(1, 2),
                          rlse.transpose(1, 2), " save output lse")

            # every backward step on the inputs the layer's backward chain gives it
            rec = Recorder(fused_block.PLAIN_STEPS)
            fused_block.layer_backward(rec, dyd, xd, vl, ra, rx2, rr2, rlse, rst, w, H, EPS1)
            kernel_step = {"layernorm_bwd": fused_block.layernorm_bwd,
                           "linear_dgrad": fused_block.linear_dgrad,
                           "linear_wgrad": fused_block.linear_wgrad,
                           "attention_bwd": fa.prefix_attention_bwd}
            bwd_inputs = inp["bwd_inputs"] = {name: [] for name in kernel_step}
            for name, (args, kwargs), ref_out in rec.calls:
                if name not in kernel_step:
                    continue
                bwd_inputs[name].append((args, kwargs))
                out = kernel_step[name](*args, **kwargs)
                torch.cuda.synchronize()
                outs = out if isinstance(out, tuple) else (out,)
                if name in ("linear_dgrad", "linear_wgrad", "attention_bwd"):  # fixed-order sums
                    again = kernel_step[name](*args, **kwargs)
                    again = again if isinstance(again, tuple) else (again,)
                    ph.check(all(torch.equal(a_, b_) for a_, b_ in zip(outs, again)),
                             f"{name}{tag} ({tuple(outs[0].shape)}): the same bits on a "
                             f"second call")
                refs = ref_out if isinstance(ref_out, tuple) else (ref_out,)
                kname = ("prefix_attention_bwd" if name == "attention_bwd" else name) + tag
                for o, r in zip(outs, refs):
                    if o.dim() == 3:  # rows of the activation: the valid ones, and zeros past
                        pad_ok = all(not o[i, n:].any().item() for i, n in enumerate(valid_len))
                        ph.check(pad_ok, f"{name}{tag}: rows past valid_len are zero")
                    if not f32:
                        ph.check(o.dtype == (bf16 if o.dim() == 3 else torch.float32),
                                 f"{kname} writes {o.dtype}")
                        note_bf16(kname, o, r, f" ({tuple(o.shape)})",
                                  valid_len if o.dim() == 3 else None)
                        continue
                    if o.dim() == 3:
                        err = valid_rows_err(o, r, valid_len)[0]
                        mag = max(r[i, :n].abs().max().item() for i, n in enumerate(valid_len))
                    else:
                        err, mag = (o - r).abs().max().item(), r.abs().max().item()
                    note(kname, err, GRAD_REL * max(1.0, mag), f" (output scale {mag:.3g})")

            layer = fused_block.fused_encoder_block(xd, vl, *w, H, EPS1, EPS2)
            layer_ref = fused_block.fused_encoder_block_reference(xd, vl, *w, H, EPS1, EPS2)
            torch.cuda.synchronize()
            if f32:
                err, rel = valid_rows_err(layer, layer_ref, valid_len)
                ph.check(err <= LAYER_TOL, f"fused_encoder_block chain: max abs {err:.3e}, "
                                           f"max rel {rel:.3e} (tolerance {LAYER_TOL:g} abs)")
            else:
                err, tol, cos = bf16_check(layer, layer_ref, valid_len, "layer chain")
                ph.check(layer.dtype == bf16 and err <= tol and cos >= BF16_COS,
                         f"fused_encoder_block chain, bf16: max abs {err:.3e} (tolerance "
                         f"{tol:.3g}), cosine 1 - {1 - cos:.2e}")

            # the layer's backward: FusedEncoderBlock against the plain backward
            # chain on the residuals the Function's own forward saves, which
            # isolates the backward kernels (in bf16 the chain recomputes the FFN
            # hidden with the kernel: backward_reference); in f32 also against
            # plain autograd. A pre-activation within rounding of 0 can flip its
            # ReLU mask between the kernel and the plain forward and move a whole
            # gradient row (the kink of ReLU; the seeded f32 inputs have none, and
            # in bf16 such flips are common), so the autograd comparison is made
            # in f32 only
            names = ["wqkv", "bqkv", "wout", "bout", "g1", "b1", "g2", "b2", "w1", "b1f", "w2",
                     "b2f"]
            xg = xd.clone().requires_grad_(True)
            wg = [t.clone().requires_grad_(True) for t in w]
            before = read_launches()
            y = fused_block.fused_encoder_block(xg, vl, *wg, H, EPS1, EPS2)
            ph.check(type(y.grad_fn).__name__ == "FusedEncoderBlockBackward",
                     f"grad_fn of the layer on CUDA: {type(y.grad_fn).__name__}")
            grads = torch.autograd.grad(y, [xg, *wg], dyd)
            torch.cuda.synchronize()
            bwd_launched = {n: read_launches()[n + tag] - before[n + tag] for n in
                            ("prefix_attention_bwd", "layernorm_bwd", "linear_dgrad",
                             "linear_wgrad")}
            ph.check(bwd_launched == {"prefix_attention_bwd": 1, "layernorm_bwd": 3,
                                      "linear_dgrad": 4, "linear_wgrad": 4},
                     f"one layer backward launched {bwd_launched} ({tag or 'f32'} instances)")
            ph.check(grads[0].dtype == dt and all(g.dtype == torch.float32 for g in grads[1:]),
                     f"layer backward: dx {grads[0].dtype}, parameter grads "
                     f"{sorted({str(g.dtype) for g in grads[1:]})}")
            if f32:
                y_ref = fused_block.fused_encoder_block_reference(xg, vl, *wg, H, EPS1, EPS2)
                grads_ref = torch.autograd.grad(y_ref, [xg, *wg], dy)
                err, rel = valid_rows_err(grads[0], grads_ref[0], valid_len)
                ph.check(err <= KERNEL_TOL * max(1.0, grads_ref[0].abs().max().item()),
                         f"layer backward dx on valid rows: max abs {err:.3e}, max rel {rel:.3e}")
                worst = max(((gk - gr).abs().max().item() / gr.abs().max().item(), n)
                            for n, gk, gr in zip(names, grads[1:], grads_ref[1:]))
                ph.check(worst[0] <= GRAD_REL, f"layer backward, 12 parameter grads: worst max "
                                               f"abs over max |ref| {worst[0]:.3e} ({worst[1]}; "
                                               f"tolerance {GRAD_REL:g})")
                del y_ref, grads_ref
            ph.check(all(not grads[0][i, n:].any().item() for i, n in enumerate(valid_len)),
                     f"layer backward{tag} dx past valid_len is exactly zero")
            same = backward_reference(dyd, xd, vl, (ka, kx2, kr2, klse, kst), w, H, EPS1)
            if f32:
                err = valid_rows_err(grads[0], same[0], valid_len)[0]
                worst = max(((gk - gr.reshape(gk.shape)).abs().max().item()
                             / gr.abs().max().item(), n)
                            for n, gk, gr in zip(names, grads[1:], same[1:]))
                ph.check(err <= KERNEL_TOL * max(1.0, same[0].abs().max().item())
                         and worst[0] <= GRAD_REL,
                         f"layer backward against the plain backward chain on the Function's "
                         f"own residuals: dx max abs {err:.3e}, 12 grads worst max abs over max "
                         f"|ref| {worst[0]:.3e} ({worst[1]})")
            else:
                checks = [("dx", *bf16_check(grads[0], same[0], valid_len, "layer bwd dx"))] + [
                    (n, *bf16_check(gk, gr.reshape(gk.shape), None, f"layer bwd {n}"))
                    for n, gk, gr in zip(names, grads[1:], same[1:])]
                bad = [c for c in checks if c[1] > c[2] or c[3] < BF16_COS]
                worst_cos = min(checks, key=lambda c: c[3])
                ph.check(not bad, f"layer backward, bf16, against the plain backward chain on "
                                  f"the Function's own residuals: dx and 12 grads, worst cosine "
                                  f"1 - {1 - worst_cos[3]:.2e} ({worst_cos[0]}); out of bounds: "
                                  f"{[c[0] for c in bad]}")
            del xg, wg, y, grads, rec, same

            # the tail rows: K2 and K4 with a cotangent on every row the forward
            # computes, against the plain backward chains on the Functions' own
            # forwards; the zero-filled tiles get exact zeros
            dyt = dy_tail.to(dt)
            xg = xd.clone().requires_grad_(True)
            wg = [t.clone().requires_grad_(True) for t in w]
            grads = torch.autograd.grad(fused_block.fused_encoder_block(xg, vl, *wg, H, EPS1,
                                                                        EPS2), [xg, *wg], dyt)
            same = backward_reference(dyt, xd, vl, (ka, kx2, kr2, klse, kst), w, H, EPS1)
            tail_zero = all(not grads[0][i, n:].any().item() for i, n in enumerate(layer_rows))
            if f32:
                err = valid_rows_err(grads[0], same[0], layer_rows)[0]
                worst = max((gk - gr.reshape(gk.shape)).abs().max().item()
                            / gr.abs().max().item() for gk, gr in zip(grads[1:], same[1:]))
                ok = (err <= KERNEL_TOL * max(1.0, same[0].abs().max().item())
                      and worst <= GRAD_REL)
                what = f"dx max abs {err:.3e}, 12 grads worst max abs over max |ref| {worst:.3e}"
            else:
                checks = [bf16_check(grads[0], same[0], layer_rows, "K2 tail dx")] + [
                    bf16_check(gk, gr.reshape(gk.shape), None, f"K2 tail {n}")
                    for n, gk, gr in zip(names, grads[1:], same[1:])]
                ok = all(e <= t and c >= BF16_COS for e, t, c in checks)
                what = f"dx and 12 grads, worst cosine 1 - {1 - min(c[2] for c in checks):.2e}"
            ph.check(ok and tail_zero,
                     f"K2 tail{tag}: a cotangent on every row of the 32-row tiles that hold a "
                     f"valid row; FusedEncoderBlock against the plain backward chain: {what}; "
                     f"dx zero on the zero-filled tiles: {tail_zero}")
            del xg, wg, grads, same
            t = qkv.clone().requires_grad_(True)
            out = fa.prefix_flash_attention(t[..., :D], t[..., D:2 * D], t[..., 2 * D:], vl, H)
            got = torch.autograd.grad(out, t, dout_tail.to(dt))[0]
            with torch.no_grad():
                o, lse = fa.attention_forward(q, k, v, vl, H, with_lse=True)
                ref = fa.prefix_flash_attention_backward_reference(q, k, v, o, lse,
                                                                   dout_tail.to(dt), vl, H)
            torch.cuda.synchronize()
            tail_zero = all(not got[i, n:].any().item() for i, n in enumerate(query_rows))
            if f32:
                err = valid_rows_err(got, ref, query_rows)[0]
                mag = max(ref[i, :n].abs().max().item() for i, n in enumerate(query_rows))
                ok, what = err <= GRAD_REL * max(1.0, mag), f"max abs {err:.3e}"
            else:
                err, tol, cos = bf16_check(got, ref, query_rows, "K4 tail")
                ok = err <= tol and cos >= BF16_COS
                what = f"max abs {err:.3e} (tolerance {tol:.3g}), cosine 1 - {1 - cos:.2e}"
            ph.check(ok and tail_zero,
                     f"K4 tail{tag}: a cotangent on every row of the 64-query tiles that hold a "
                     f"valid query; PrefixFlashAttention against the plain backward: {what}; "
                     f"zero on the zero-filled tiles: {tail_zero}")
            del t, out, got, o, lse, ref

            # K5/K6, the LayerNorm kernels, on every row of the layer input (the
            # function has no valid_len), with the attention output as the
            # residual; the backward from the forward's own stats
            for res, eps in ((None, EPS1), (None, 1e-6), (attn, EPS1), (attn, 1e-6)):
                what = f" ({'LN(x + r)' if res is not None else 'LN(x)'}, eps {eps:g})"
                y, mu, rstd = ln.ln_fwd(xd, res, g1, b1, eps)
                dxl, dgl, dbl = ln.ln_bwd(xd, res, g1, mu, rstd, dyd)
                again = ln.ln_bwd(xd, res, g1, mu, rstd, dyd)
                torch.cuda.synchronize()
                ry, rmu, rrstd = ln.ln_fwd_reference(xd, res, g1, b1, eps)
                rdx, rdg, rdb = ln.ln_bwd_reference(xd, res, g1, mu, rstd, dyd)
                ph.check(all(torch.equal(a_, b_) for a_, b_ in zip((dxl, dgl, dbl), again)),
                         f"ln_bwd{tag}{what}: the same bits on a second run")
                ph.check(y.dtype == dxl.dtype == dt and all(
                    t_.dtype == torch.float32 for t_ in (mu, rstd, dgl, dbl)),
                         f"ln_fwd{tag}/ln_bwd{tag}: y, dx {dt}; stats, dgamma, dbeta f32")
                if f32:
                    note("ln_fwd", max((a_ - b_).abs().max().item() for a_, b_ in
                                       ((y, ry), (mu, rmu), (rstd, rrstd))),
                         KERNEL_TOL, what + " y, mean, rstd")
                    for out_, ref_, part in ((dxl, rdx, "dx"), (dgl, rdg, "dgamma"),
                                             (dbl, rdb, "dbeta")):
                        mag = ref_.abs().max().item()
                        note("ln_bwd", (out_ - ref_).abs().max().item(),
                             GRAD_REL * max(1.0, mag), f"{what} {part} (output scale {mag:.3g})")
                else:
                    note_bf16("ln_fwd_bf16", y, ry, what + " y", None)
                    note_bf16("ln_fwd_bf16", torch.stack((mu, rstd), -1),
                              torch.stack((rmu, rrstd), -1), what + " mean, rstd", None)
                    for out_, ref_, part in ((dxl, rdx, "dx"), (dgl, rdg, "dgamma"),
                                             (dbl, rdb, "dbeta")):
                        note_bf16("ln_bwd_bf16", out_, ref_, f"{what} {part}", None)
                if res is None and eps == 1e-6:  # the final norm's site, timed in phase 5
                    inp["ln"] = dict(mu=mu, rstd=rstd)
                del y, mu, rstd, dxl, dgl, dbl, again, ry, rmu, rrstd, rdx, rdg, rdb
        log("  bf16 instances, worst readings over seeds "
            f"{', '.join(map(str, BF16_SEEDS))}: " + "; ".join(
                f"{k} {v:.3g} ({where})" for k, (v, where) in worst_bf16.items())
            + f" (bounds {BF16_STEPS} steps, {BF16_F32_REL:g}, {1 - BF16_COS:.0e})")

    # ---- 3. the JAX fixtures --------------------------------------------------
    with Phase("3 JAX fixtures", failures) as ph:
        with np.load(FIXTURE) as f:
            fx = {key: f[key] for key in f.files}
        depth, img = int(fx["depth"]), int(fx["img_size"])
        model2 = chada_vit(depth=depth, return_all_tokens=False, img_size=img)
        model2.load_state_dict(random_state_dict(model2, int(fx["weight_seed"])))
        model2 = model2.to(dev).eval()
        images = hub.random_images(fx["counts"].tolist(), img, int(fx["image_seed"]))
        xf, ccf = hub.collate_images(images)
        with torch.inference_mode():
            cls = model2(xf.to(dev), ccf.to(dev)).cpu()
        ref = torch.from_numpy(fx["cls"])
        cos = cosine_rows(cls, ref)
        err = (cls - ref).abs().max().item()
        spread = (ref - ref[0]).abs().max().item()
        ph.check(bool(torch.isfinite(cls).all()) and cls.shape == ref.shape,
                 f"CLS shape {tuple(cls.shape)}, finite")
        ph.check(cos.min().item() >= FIXTURE_COS and err <= FIXTURE_TOL,
                 f"against the JAX fixture: min cosine 1 - {1 - cos.min().item():.2e} "
                 f"(>= 1 - {1 - FIXTURE_COS:.0e}), max abs {err:.3e} (<= {FIXTURE_TOL:g}); "
                 f"rows differ from each other by up to {spread:.3e}")
        del model2

        # three DINO steps of the depth-2 backbone and the canonical head
        with np.load(DINO_FIXTURE) as f:
            dx_ = {key: f[key] for key in f.files}
        spec2 = DinoPretrainSpec(
            backbone_kwargs=dict(embed_dim=D, patch_size=16, return_all_tokens=False,
                                 max_number_channels=10, depth=int(dx_["depth"])),
            steps_per_epoch=2, freeze_last_layer=1, clip_grad=3.0,
            warmup_teacher_temperature_epochs=2)
        state2, step2, _, _ = build_dino(spec2, seed=int(dx_["weight_seed"]))
        batch2 = synthetic_dino_batch(spec2, len(dx_["counts"]), int(dx_["batch_seed"]),
                                      dx_["counts"].tolist())
        before = {n: p.detach().clone() for n, p in state2.trainable()}
        worst = {}
        for i in range(int(dx_["steps"])):
            state2, m = step2(state2, batch2)
            for key in ("dino_loss", "center_norm", "lr", "tau", "teacher_temp"):
                r = abs(float(m[key]) / dx_[key][i] - 1)
                worst[key] = max(worst.get(key, 0.0), r)
        ph.check(max(worst.values()) <= DINO_METRIC_REL,
                 "3 steps against the JAX DINO fixture, per-step metrics: worst rel "
                 + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                 + f" (tolerance {DINO_METRIC_REL:g})")
        named = {side: {f"{part}.{n}": t for part in ("backbone", "head")
                        for n, t in getattr(state2, side)[part].state_dict().items()}
                 for side in ("student", "teacher")}
        names = [str(n) for n in dx_["names"]]
        norm_err = max(abs(named[side][n].double().norm().item() / dx_[f"{side}_norms"][i] - 1)
                       for side in ("student", "teacher") for i, n in enumerate(names))
        delta_err = max(abs((named["student"][n] - before[n]).double().norm().item()
                            / dx_["student_delta_norms"][i] - 1)
                        for i, n in enumerate(names)
                        if n in before and dx_["student_delta_norms"][i] > 0)
        ph.check(norm_err <= DINO_NORM_REL and delta_err <= DINO_DELTA_REL,
                 f"after 3 steps, {len(names)} student and teacher parameter norms: worst rel "
                 f"{norm_err:.2e} (<= {DINO_NORM_REL:g}); norms of the student's changes: "
                 f"worst rel {delta_err:.2e} (<= {DINO_DELTA_REL:g})")
        del state2, step2, batch2, before, named

        # both again in bfloat16, against the JAX package's bfloat16 runs
        with np.load(FIXTURE_BF16) as f:
            fxb = {key: f[key] for key in f.files}
        model2 = chada_vit(depth=int(fxb["depth"]), return_all_tokens=False,
                           img_size=int(fxb["img_size"]), dtype=bf16)
        model2.load_state_dict(random_state_dict(model2, int(fxb["weight_seed"])))
        model2 = model2.to(dev).eval()
        images = hub.random_images(fxb["counts"].tolist(), int(fxb["img_size"]),
                                   int(fxb["image_seed"]))
        xf, ccf = hub.collate_images(images)
        with torch.inference_mode():
            cls = model2(xf.to(dev), ccf.to(dev))
        ref = torch.from_numpy(fxb["cls"])
        ph.check(cls.dtype == bf16 and cls.shape == ref.shape
                 and bool(torch.isfinite(cls.float()).all()),
                 f"bf16 CLS {cls.dtype} {tuple(cls.shape)}, finite")
        cls = cls.float().cpu()
        cos = cosine_rows(cls, ref)
        err = (cls - ref).abs().max().item()
        ph.check(cos.min().item() >= FIXTURE_BF16_COS and err <= FIXTURE_BF16_TOL,
                 f"bf16, against the JAX bf16 fixture: min cosine 1 - {1 - cos.min().item():.2e}"
                 f" (>= 1 - {1 - FIXTURE_BF16_COS:.0e}), max abs {err:.3e} "
                 f"(<= {FIXTURE_BF16_TOL:g})")
        del model2

        with np.load(DINO_FIXTURE_BF16) as f:
            dxb = {key: f[key] for key in f.files}
        spec2b = DinoPretrainSpec(
            backbone_kwargs=dict(embed_dim=D, patch_size=16, return_all_tokens=False,
                                 max_number_channels=10, depth=int(dxb["depth"])),
            steps_per_epoch=2, freeze_last_layer=1, clip_grad=3.0,
            warmup_teacher_temperature_epochs=2, dtype=bf16)
        state2, step2, _, _ = build_dino(spec2b, seed=int(dxb["weight_seed"]))
        batch2 = synthetic_dino_batch(spec2b, len(dxb["counts"]), int(dxb["batch_seed"]),
                                      dxb["counts"].tolist())
        before = {n: p.detach().clone() for n, p in state2.trainable()}
        worst = {}
        for i in range(int(dxb["steps"])):
            state2, m = step2(state2, batch2)
            for key in ("dino_loss", "center_norm", "lr", "tau", "teacher_temp"):
                worst[key] = max(worst.get(key, 0.0), abs(float(m[key]) / dxb[key][i] - 1))
        ph.check(max(worst.values()) <= DINO_BF16_METRIC_REL,
                 "bf16, 3 steps against the JAX bf16 DINO fixture, per-step metrics: worst rel "
                 + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                 + f" (tolerance {DINO_BF16_METRIC_REL:g})")
        named = {side: {f"{part}.{n}": t for part in ("backbone", "head")
                        for n, t in getattr(state2, side)[part].state_dict().items()}
                 for side in ("student", "teacher")}
        names = [str(n) for n in dxb["names"]]
        all_f32 = all(t.dtype == torch.float32 for side in named.values() for t in side.values())
        norm_err = max(abs(named[side][n].double().norm().item() / dxb[f"{side}_norms"][i] - 1)
                       for side in ("student", "teacher") for i, n in enumerate(names))
        delta_err = max(abs((named["student"][n] - before[n]).double().norm().item()
                            / dxb["student_delta_norms"][i] - 1)
                        for i, n in enumerate(names)
                        if n in before and dxb["student_delta_norms"][i] > 0)
        ph.check(all_f32 and norm_err <= DINO_BF16_NORM_REL
                 and delta_err <= DINO_BF16_DELTA_REL,
                 f"bf16, after 3 steps, {len(names)} student and teacher parameter norms (all "
                 f"f32: {all_f32}): worst rel {norm_err:.2e} (<= {DINO_BF16_NORM_REL:g}); norms "
                 f"of the student's changes: worst rel {delta_err:.2e} "
                 f"(<= {DINO_BF16_DELTA_REL:g})")
        del state2, step2, batch2, before, named

    # ---- 4. the served path -------------------------------------------------
    n_served, batch = 24, 8
    with Phase("4 served path", failures) as ph:
        model = hub.load_chadavit16_moyen(seed=0)  # device=None: the card
        counts = [1 + i % 10 for i in range(n_served)]
        images = hub.random_images(counts, 224, seed=2)
        reset_launches()
        t = time.perf_counter()
        emb = hub.extract_embeddings(model, images, batch_size=batch)
        served_s = time.perf_counter() - t
        launches = read_launches()
        layer_batches = len(model.blocks) * math.ceil(n_served / batch)
        expected = {name: 0 for name in instances}
        expected.update({"ln_linear_fwd": layer_batches, "prefix_attention_fwd": layer_batches,
                         "linear_relu_fwd": layer_batches,
                         "linear_residual_ln_fwd": 2 * layer_batches})
        ph.check(emb.shape == (n_served, D) and bool(np.isfinite(emb).all()),
                 f"embeddings {emb.shape}, all finite ({served_s:.2f} s for {n_served} images)")
        ph.check(launches == expected, f"launches {launches} == expected {expected}")
        with torch.inference_mode():
            plain = []
            for s in range(0, n_served, batch):
                xb, cb = hub.collate_images(images[s:s + batch])
                plain.append(plain_backbone(model, xb.to(dev), cb.to(dev)).cpu())
        plain = torch.cat(plain)
        cos = cosine_rows(torch.from_numpy(emb), plain)
        err = (torch.from_numpy(emb) - plain).abs().max().item()
        ph.check(cos.min().item() >= SERVED_COS,
                 f"kernels against plain versions on the card: min cosine "
                 f"1 - {1 - cos.min().item():.2e} (>= 1 - {1 - SERVED_COS:.0e}), max abs {err:.3e}")

        # the served path in bfloat16: the compute dtype, float32 parameters
        model_b = hub.load_chadavit16_moyen(seed=0, dtype=bf16)
        ph.check(all(t.dtype == torch.float32 for t in model_b.state_dict().values()),
                 "bf16 model: every parameter float32 on the card, LN scale/bias included")
        reset_launches()
        t = time.perf_counter()
        emb_b = hub.extract_embeddings(model_b, images, batch_size=batch)
        served_b_s = time.perf_counter() - t
        launches = read_launches()
        expected_b = {name: 0 for name in instances}
        expected_b.update({f"{name}_bf16": n for name, n in expected.items() if n})
        ph.check(emb_b.shape == (n_served, D) and emb_b.dtype == np.float32
                 and bool(np.isfinite(emb_b).all()),
                 f"bf16 embeddings {emb_b.shape} {emb_b.dtype}, all finite "
                 f"({served_b_s:.2f} s for {n_served} images)")
        ph.check(launches == expected_b, f"bf16 launches {launches} == expected {expected_b}")
        with torch.inference_mode():
            plain_b = []
            for s in range(0, n_served, batch):
                xb, cb = hub.collate_images(images[s:s + batch])
                plain_b.append(plain_backbone(model_b, xb.to(dev, bf16), cb.to(dev))
                               .float().cpu())
        plain_b = torch.cat(plain_b)
        cos = cosine_rows(torch.from_numpy(emb_b), plain_b)
        err = (torch.from_numpy(emb_b) - plain_b).abs().max().item()
        ph.check(cos.min().item() >= SERVED_BF16_COS,
                 f"bf16 kernels against plain bf16 versions on the card: min cosine "
                 f"1 - {1 - cos.min().item():.2e} (>= 1 - {1 - SERVED_BF16_COS:.0e}), "
                 f"max abs {err:.3e}; "
                 f"against the f32 embeddings: min cosine "
                 f"1 - {1 - cosine_rows(torch.from_numpy(emb_b), torch.from_numpy(emb)).min().item():.2e}")

    # ---- 4b. the train path ---------------------------------------------------
    with Phase("4b train path", failures) as ph:
        spec = DinoPretrainSpec()
        state, step, backbone, _ = build_dino(spec)  # device=None: the card
        train_batch = synthetic_dino_batch(spec, TRAIN_B, seed=4)
        tcounts = train_batch["channel_counts"].tolist()
        reset_launches()
        losses = []
        t = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state, m = step(state, train_batch)
            losses.append(float(m["dino_loss"]))
            if len(losses) == 1:
                after_step1 = {n: p.detach().clone() for n, p in state.trainable()}
                dirs_step1 = [b.clone() for b in state.opt_state.momentum]
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        launches = read_launches()
        runs = len(backbone.blocks) * TRAIN_STEPS  # layer runs of each model per path
        per_path = {"ln_linear_fwd": 3 * runs, "prefix_attention_fwd": 2 * runs,
                    "linear_relu_fwd": 3 * runs, "linear_residual_ln_fwd": 5 * runs,
                    "prefix_attention_bwd": runs, "layernorm_bwd": 3 * runs,
                    "linear_dgrad": 4 * runs, "linear_wgrad": 4 * runs}
        expected = {name: 0 for name in instances}
        expected.update(per_path)
        for name in kernels:  # the slice's main path: what the JSON line reports
            stats[name]["launches"] = launches[name]
        ph.check(all(math.isfinite(v) for v in losses),
                 f"{TRAIN_STEPS} steps of B {TRAIN_B} (channels {tcounts}), depth "
                 f"{len(backbone.blocks)}: "
                 f"dino_loss {losses}, finite ({train_s:.2f} s)")
        ph.check(launches == expected, f"launches {launches} == expected {expected} "
                 f"({len(backbone.blocks)} layers x {TRAIN_STEPS} steps: teacher forward, "
                 "student forward "
                 "with the save outputs, student backward with its three recomputes)")

        # step 1 again, the same state, through a plain backbone
        pstate, pstep, _, _ = build_dino(spec, backbone_apply=plain_backbone)
        pstate, pm = pstep(pstate, train_batch)
        loss_rel = abs(float(pm["dino_loss"]) / losses[0] - 1)
        worst_cos = min(torch.nn.functional.cosine_similarity(
            after_step1[n].double().flatten(), p.detach().double().flatten(), 0).item()
            for n, p in pstate.trainable())
        ph.check(loss_rel <= TRAIN_LOSS_REL and worst_cos >= TRAIN_PARAM_COS,
                 f"step 1, kernels against the plain backbone: loss rel {loss_rel:.2e} "
                 f"(<= {TRAIN_LOSS_REL:g}), worst per-tensor cosine of the updated "
                 f"parameters 1 - {1 - worst_cos:.2e} (>= 1 - {1 - TRAIN_PARAM_COS:.0e})")
        check_updates(ph, "step 1", [n for n, _ in pstate.trainable()], dirs_step1,
                      pstate.opt_state.momentum, spec, TRAIN_UPDATE_COS)
        del pstate, pstep, after_step1, dirs_step1
        torch.cuda.empty_cache()
        check_layer_backward(ph, backbone, train_batch, torch.float32)

        # the bf16 train path, the canonical precision, at the canonical batch
        spec_b = DinoPretrainSpec(dtype=bf16)
        state_b, step_b, backbone_b, _ = build_dino(spec_b)  # device=None: the card
        ph.check(all(p.dtype == torch.float32 for _, p in state_b.trainable())
                 and all(t.dtype == torch.float32 for part in state_b.teacher.values()
                         for t in part.state_dict().values()),
                 "bf16 trainer: student and teacher parameters float32")
        train_batch_b = synthetic_dino_batch(spec_b, TRAIN_BF16_B, seed=4)
        tcounts_b = train_batch_b["channel_counts"].tolist()
        reset_launches()
        losses_b = []
        t = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state_b, m = step_b(state_b, train_batch_b)
            losses_b.append(float(m["dino_loss"]))
            if len(losses_b) == 1:
                dirs_step1 = [b.clone() for b in state_b.opt_state.momentum]
        torch.cuda.synchronize()
        train_b_s = time.perf_counter() - t
        launches = read_launches()
        expected_b = {name: 0 for name in instances}  # the same depth as the f32 path
        expected_b.update({f"{name}_bf16": n for name, n in per_path.items()})
        for name in kernels:
            stats[name + "_bf16"]["launches"] = launches[name + "_bf16"]
        ph.check(train_batch_b["crops"].dtype == bf16 and all(math.isfinite(v) for v in losses_b),
                 f"bf16: {TRAIN_STEPS} steps of B {TRAIN_BF16_B} x 2 global crops (channels "
                 f"{tcounts_b}), depth {len(backbone_b.blocks)}: dino_loss {losses_b}, finite "
                 f"({train_b_s:.2f} s)")
        ph.check(launches == expected_b, f"bf16 launches {launches} == expected {expected_b}")
        # the partial sums of linear_wgrad_bf16 at this batch (2 crops a
        # sequence, s_pad up to 2048), and of the float32 linear_wgrad at the
        # float32 train batch and at this one: a plan that does not grow with
        # the batch
        s_max = 2048
        for tag, dt, batches in (("_bf16", bf16, (2 * TRAIN_BF16_B,)),
                                 ("", torch.float32, (2 * TRAIN_B, 2 * TRAIN_BF16_B))):
            for seqs in batches:
                scratch = []
                for n, k in fused_block.WGRAD_BF16_TILES:
                    splits = fused_block.wgrad_splits(seqs, s_max, n, k, dt)
                    scratch.append(f"({n}, {k}) {splits} splits "
                                   f"{splits * (n * k + n) * 4 / 1e6:.2f} MB")
                log(f"  linear_wgrad{tag} partial scratch per weight shape (N, K) at {seqs} "
                    f"sequences of {s_max} rows: " + ", ".join(scratch))
        splits = fused_block.layernorm_bwd_splits(seqs, s_max)
        log(f"  layernorm_bwd partial scratch at {seqs} sequences of {s_max} rows: {splits} splits "
            f"{splits * 2 * D * 4 / 1e6:.2f} MB (one partial per 32-row tile: "
            f"{seqs * s_max // fused_block.ROW_BLOCK * 2 * D * 4 / 1e6:.2f} MB)")

        # step 1 again, the same state, through the plain chains
        pstate, pstep, _, _ = build_dino(spec_b, backbone_apply=plain_chain_backbone)
        pstate, pm = pstep(pstate, train_batch_b)
        loss_rel = abs(float(pm["dino_loss"]) / losses_b[0] - 1)
        ph.check(loss_rel <= TRAIN_BF16_LOSS_REL,
                 f"bf16 step 1, kernels against the plain chains: loss rel {loss_rel:.2e} "
                 f"(<= {TRAIN_BF16_LOSS_REL:g})")
        check_updates(ph, "bf16 step 1", [n for n, _ in pstate.trainable()], dirs_step1,
                      pstate.opt_state.momentum, spec_b, TRAIN_BF16_UPDATE_COS)
        del pstate, pstep, dirs_step1
        torch.cuda.empty_cache()
        check_layer_backward(ph, backbone_b, train_batch_b, bf16)
        torch.cuda.empty_cache()

    # ---- 4c. the pretrain entry point ------------------------------------------
    with Phase("4c pretrain entry point", failures) as ph, \
            tempfile.TemporaryDirectory() as tmp:
        from chadavit_tpu_torch import main_pretrain
        from chadavit_tpu_torch.train import loop
        from chadavit_tpu_torch.utils.checkpoint import STATE_FILE

        # every step's device span: CUDA events around the step the loop builds
        spans = []
        real_build = loop.build_dino

        def timed_build(*args, **kwargs):
            st_, stp_, m_, h_ = real_build(*args, **kwargs)

            def timed_step(state_, batch_):
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = stp_(state_, batch_)
                ev[1].record()
                spans.append(ev)
                return out
            return st_, timed_step, m_, h_

        cfg_a = entry_cfg([f"checkpoint.dir={tmp}/a"])
        ph.check(cfg_a.optimizer.batch_size == 32 and cfg_a.precision == "bf16"
                 and cfg_a.data.num_large_crops == 2,
                 f"canonical recipe: batch {cfg_a.optimizer.batch_size}, precision "
                 f"{cfg_a.precision}, {cfg_a.data.num_large_crops} global crops of "
                 f"{cfg_a['augmentations'][0]['crop_size']} px, lr {cfg_a.optimizer.lr:g}")
        loop.build_dino = timed_build
        try:
            reset_launches()
            t = time.perf_counter()
            # (a) through the command line a user types, as its argument list
            metrics_a = main_pretrain.main(
                ["--config-path", str(CANONICAL.parent), "--config-name", CANONICAL.name,
                 *ENTRY, f"checkpoint.dir={tmp}/a", f"max_steps={ENTRY_STEPS}"])
            torch.cuda.synchronize()
            entry_s = time.perf_counter() - t
            launches = read_launches()
        finally:
            loop.build_dino = real_build
        depth = 12
        runs = depth * ENTRY_STEPS
        expected = {name: 0 for name in instances}
        expected.update({f"{name}_bf16": n for name, n in {
            "ln_linear_fwd": 3 * runs, "prefix_attention_fwd": 2 * runs,
            "linear_relu_fwd": 3 * runs, "linear_residual_ln_fwd": 5 * runs,
            "prefix_attention_bwd": runs, "layernorm_bwd": 3 * runs, "linear_dgrad": 4 * runs,
            "linear_wgrad": 4 * runs, "ln_fwd": 2 * ENTRY_STEPS, "ln_bwd": ENTRY_STEPS}.items()})
        for name in ("ln_fwd_bf16", "ln_bwd_bf16"):
            stats[name]["launches"] = launches[name]
        logs_a = read_logs(f"{tmp}/a")
        ph.check(sorted(logs_a) == list(range(1, ENTRY_STEPS + 1))
                 and all(math.isfinite(logs_a[i]["dino_loss"]) for i in logs_a),
                 f"(a) python -m chadavit_tpu_torch.main_pretrain ... max_steps={ENTRY_STEPS}: "
                 f"dino_loss "
                 f"{[logs_a[i]['dino_loss'] for i in sorted(logs_a)]}, finite "
                 f"({entry_s:.2f} s with set-up)")
        ph.check(launches == expected, f"(a) launches {launches} == expected {expected} "
                 f"({depth} layers x {ENTRY_STEPS} steps x (teacher + student), the final "
                 "norm's ln_fwd twice and ln_bwd once a step)")

        # the host loader beside the step: wall time, device span, the wait
        steady = [i for i in sorted(logs_a) if i > 2]
        step_ms = 1e3 * logs_a[steady[-1]]["step_time_s"]
        wait_ms = 1e3 * logs_a[steady[-1]]["data_wait_s"]
        span_ms = [s_.elapsed_time(e_) for s_, e_ in spans]
        loader = loop.build_pretrain_loader(cfg_a, seed=5)
        it = iter(loader)
        next(it)  # the workers' first batch
        t = time.perf_counter()
        n_batches = min(4, len(loader) - 1)
        for _ in range(n_batches):
            next(it)
        loader_ms = 1e3 * (time.perf_counter() - t) / n_batches
        del it, loader
        log(f"  entry point, {cfg_a.precision}, B {cfg_a.optimizer.batch_size} x "
            f"{cfg_a.data.num_large_crops} crops of {cfg_a['augmentations'][0]['crop_size']} "
            f"px, {cfg_a.data.num_workers} loader "
            f"threads: host loader {loader_ms:.1f} ms per batch on its own; steps 3-{ENTRY_STEPS}"
            f": wall {step_ms:.1f} ms per step, waiting for the batch {wait_ms:.1f} ms "
            f"({100 * wait_ms / step_ms:.1f} % of the step, the card idle); device span of "
            f"each step {', '.join(f'{v:.1f}' for v in span_ms)} ms ({smi})")

        # (b) stop at step 2 with a step checkpoint; (c) auto-resume to step 4
        cfg_b = entry_cfg([f"checkpoint.dir={tmp}/b", f"checkpoint.step_frequency={ENTRY_STOP}"])
        loop.run_dino_pretrain(cfg_b, max_steps=ENTRY_STOP)
        metrics_c = loop.run_dino_pretrain(cfg_b, max_steps=ENTRY_STEPS - ENTRY_STOP)
        logs_c = read_logs(f"{tmp}/b")
        same_logs = all(logs_a[i][k] == logs_c[i][k] for i in range(ENTRY_STOP + 1,
                                                                    ENTRY_STEPS + 1)
                        for k in ENTRY_METRICS)
        state_a, state_c = (torch.load(final_ckpt(f"{tmp}/{d}") / STATE_FILE,
                                       weights_only=True) for d in ("a", "b"))
        diff = differing_entries(state_a, state_c)
        ph.check(sorted(logs_c) == list(range(1, ENTRY_STEPS + 1)) and same_logs
                 and metrics_c == metrics_a and state_c["step"] == ENTRY_STEPS and not diff,
                 f"(b) {ENTRY_STOP} steps + (c) auto-resume to step {ENTRY_STEPS}: metrics of "
                 f"steps {ENTRY_STOP + 1}-{ENTRY_STEPS} equal (a)'s bit for bit: {same_logs}; "
                 f"final train state (step {state_c['step']}) equal bit for bit: entries that "
                 f"differ {diff[:5]}")
        del state_a, state_c
        torch.cuda.empty_cache()

        # block_impl=xla, float32: every LayerNorm through ln_fwd / ln_bwd, step 1
        # against the same run with plain LayerNorms (ln_impl=xla)
        cfg_x = entry_cfg(ENTRY_XLA + [f"checkpoint.dir={tmp}/x"])
        reset_launches()
        loop.run_dino_pretrain(cfg_x, max_steps=ENTRY_XLA_STEPS)
        launches = read_launches()
        n = ENTRY_XLA_STEPS
        expected = {name: 0 for name in instances}
        expected.update({"prefix_attention_fwd": 2 * depth * n, "prefix_attention_bwd": depth * n,
                         "ln_fwd": 2 * (3 * depth + 1) * n, "ln_bwd": (3 * depth + 1) * n})
        for name in ("ln_fwd", "ln_bwd"):
            stats[name]["launches"] = launches[name]
        ph.check(launches == expected, f"block_impl=xla, f32, {n} steps: launches {launches} == "
                 f"expected {expected} (3 LayerNorms a layer and the final norm, teacher and "
                 "student; the attention kernels; the projections in torch.matmul)")
        cfg_y = entry_cfg(ENTRY_XLA + [f"checkpoint.dir={tmp}/y", "backbone.kwargs.ln_impl=xla"])
        loop.run_dino_pretrain(cfg_y, max_steps=1)
        logs_x, logs_y = read_logs(f"{tmp}/x"), read_logs(f"{tmp}/y")
        loss_rel = abs(logs_x[1]["dino_loss"] / logs_y[1]["dino_loss"] - 1)
        ph.check(loss_rel <= TRAIN_LOSS_REL and all(math.isfinite(logs_x[i]["dino_loss"])
                                                    for i in logs_x),
                 f"block_impl=xla step 1, LayerNorm kernels against plain LayerNorms: loss "
                 f"{logs_x[1]['dino_loss']:.6f} vs {logs_y[1]['dino_loss']:.6f}, rel "
                 f"{loss_rel:.2e} (<= {TRAIN_LOSS_REL:g}); step 2 loss "
                 f"{logs_x[n]['dino_loss']:.6f}")
        st_x, st_y = (torch.load(step_ckpt(f"{tmp}/{d}", 1) / STATE_FILE, weights_only=True)
                      for d in ("x", "y"))
        spec_x = loop.spec_from_cfg(cfg_x, 1)
        ph.check(st_x["opt_state"]["names"] == st_y["opt_state"]["names"],
                 "the two runs train the same tensors")
        check_updates(ph, "block_impl=xla step 1", st_x["opt_state"]["names"],
                          st_x["opt_state"]["momentum"], st_y["opt_state"]["momentum"],
                          spec_x, TRAIN_UPDATE_COS)
        del st_x, st_y
        torch.cuda.empty_cache()

    # ---- 5. times -------------------------------------------------------------
    with Phase("5 times", failures) as ph:
        rows = sum(valid_len)  # rows the kernels must compute
        m_all = B * S_PAD
        key_ok = (torch.arange(S_PAD, device=dev)[None, :] < vl[:, None])[:, None, None, :]
        saved = dict(_launch.LAUNCHES)  # timing launches do not count

        def site(kernel_fn, plain_fn, lib_fn, ops, nbytes):
            return kernel_fn, plain_fn, lib_fn, ops, nbytes

        def heads(t):
            return t.reshape(B, S_PAD, H, D // H).transpose(1, 2)

        plain_step = {"layernorm_bwd": fused_block.layernorm_bwd_reference,
                      "linear_dgrad": fused_block.linear_dgrad_reference,
                      "linear_wgrad": fused_block.linear_wgrad_reference,
                      "attention_bwd": fa.prefix_flash_attention_backward_reference}
        kernel_step = {"layernorm_bwd": fused_block.layernorm_bwd,
                       "linear_dgrad": fused_block.linear_dgrad,
                       "linear_wgrad": fused_block.linear_wgrad,
                       "attention_bwd": fa.prefix_attention_bwd}

        def fresh(kwargs):  # layernorm_bwd sums into dgb in place: a copy per call
            return {k: (v.clone() if k == "dgb" else v) for k, v in kwargs.items()}

        def ln_bwd_library(args, kwargs):  # the site-1 residual add is left out
            dy_, xin, mean, rstd, g = args[:5]
            g = g.to(dy_.dtype)
            args2 = (dy_.reshape(-1, D), xin.reshape(-1, D), [D], mean.reshape(-1, 1),
                     rstd.reshape(-1, 1), g, g, [True, True, True])
            return lambda: torch.ops.aten.native_layer_norm_backward(*args2)

        def dgrad_library(args, kwargs):
            dy_, wmat = args[0], args[1]
            res = kwargs.get("residual")
            if res is not None:
                return lambda: torch.addmm(res.reshape(-1, res.shape[-1]),
                                           dy_.reshape(-1, dy_.shape[-1]), wmat)
            return lambda: torch.mm(dy_.reshape(-1, dy_.shape[-1]), wmat)

        def wgrad_library(args, kwargs):
            dy_, xin = args[0], args[1]
            return lambda: torch.mm(dy_.reshape(-1, dy_.shape[-1]).t(),
                                    xin.reshape(-1, xin.shape[-1]))

        def attention_bwd_library(args, kwargs):
            q_, k_, v_ = (heads(t.detach()).requires_grad_(True) for t in args[:3])
            do_ = heads(args[5])
            out = F.scaled_dot_product_attention(q_, k_, v_, attn_mask=key_ok)
            return lambda: torch.autograd.grad(out, (q_, k_, v_), do_, retain_graph=True)

        library_of = {"layernorm_bwd": ln_bwd_library, "linear_dgrad": dgrad_library,
                      "linear_wgrad": wgrad_library, "attention_bwd": attention_bwd_library}

        for tag, dt in (("", torch.float32), ("_bf16", bf16)):
            f32 = dt == torch.float32
            es = 4 if f32 else 2  # bytes of an activation or weight element
            peak = PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS
            inp = inputs[tag]
            xd, q, k, v, attn, x2, hid, dyd = (inp[n] for n in ("x", "q", "k", "v", "attn",
                                                                 "x2", "hid", "dy"))
            wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = inp["wd"]
            # the library calls take the LN parameters in the activation dtype
            gl1, bl1, gl2, bl2 = (t.to(dt) for t in (g1, b1, g2, b2))
            x2d, attn2d, x22d, hid2d = (t.reshape(-1, t.shape[-1]) for t in (xd, attn, x2, hid))
            qh, kh, vh = heads(q), heads(k), heads(v)

            def bwd_cost(name, args, kwargs):
                """(operations, bytes) the step must do on this run's rows; f32
                stats, LN parameters and parameter gradients are 4 bytes."""
                if name == "layernorm_bwd":
                    nres = kwargs.get("residual") is not None
                    return 10 * rows * D, (es * ((2 + nres) * rows * D + m_all * D)
                                           + 4 * (2 * rows + D + 2 * D))
                if name == "linear_dgrad":
                    kk, nn_ = args[1].shape
                    aux = kwargs.get("relu_of") is not None or kwargs.get("residual") is not None
                    return 2 * rows * kk * nn_, es * (rows * kk + kk * nn_ + aux * rows * nn_
                                                      + m_all * nn_)
                if name == "linear_wgrad":
                    nn_, kk = args[0].shape[-1], args[1].shape[-1]
                    return (2 * rows * nn_ * kk + rows * nn_,
                            es * rows * (nn_ + kk) + 4 * (nn_ * kk + nn_))
                return (sum(10 * n * n * D for n in valid_len),
                        es * (5 * rows * D + 3 * m_all * D) + 4 * (2 * H * rows))

            runs = {
                "ln_linear_fwd": [site(
                    lambda: fused_block.ln_linear(xd, g1, b1, EPS1, wqkv, bqkv, vl),
                    lambda: fused_block.ln_linear_reference(xd, g1, b1, EPS1, wqkv, bqkv),
                    lambda: torch.addmm(bqkv, F.layer_norm(x2d, (D,), gl1, bl1, EPS1), wqkv.t()),
                    2 * rows * D * 3 * D,
                    es * (rows * D + 3 * D * D + 3 * D + m_all * 3 * D) + 4 * 2 * D)],
                "prefix_attention_fwd": [site(
                    lambda: fa.prefix_flash_attention(q, k, v, vl, H),
                    lambda: fa.prefix_flash_attention_reference(q, k, v, vl, H),
                    lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok),
                    sum(4 * n * n * D for n in valid_len), es * (3 * rows * D + m_all * D))],
                "linear_relu_fwd": [site(
                    lambda: fused_block.linear_relu(x2, w1, b1f, vl),
                    lambda: fused_block.linear_relu_reference(x2, w1, b1f),
                    lambda: torch.relu(torch.addmm(b1f, x22d, w1.t())),
                    2 * rows * D * FFN, es * (rows * D + FFN * D + FFN + m_all * FFN))],
                "linear_residual_ln_fwd": [site(  # both sites of a layer, summed
                    lambda: fused_block.linear_residual_ln(attn, wout, bout, xd, g1, b1, EPS1,
                                                           vl),
                    lambda: fused_block.linear_residual_ln_reference(attn, wout, bout, xd, g1,
                                                                     b1, EPS1),
                    lambda: F.layer_norm(torch.addmm(bout, attn2d, wout.t()) + x2d, (D,), gl1,
                                         bl1, EPS1),
                    2 * rows * D * D,
                    es * (2 * rows * D + D * D + D + m_all * D) + 4 * 2 * D), site(
                    lambda: fused_block.linear_residual_ln(hid, w2, b2f, x2, g2, b2, EPS2, vl),
                    lambda: fused_block.linear_residual_ln_reference(hid, w2, b2f, x2, g2, b2,
                                                                     EPS2),
                    lambda: F.layer_norm(torch.addmm(b2f, hid2d, w2.t()) + x22d, (D,), gl2,
                                         bl2, EPS2),
                    2 * rows * FFN * D,
                    es * (rows * FFN + rows * D + FFN * D + D + m_all * D) + 4 * 2 * D)],
            }
            # K5/K6 at the final norm's site (LN(x), eps 1e-6) on the hub rows;
            # the bound counts every row: ln_fwd and ln_bwd take no valid_len
            # (the JAX package's plain LayerNorm over all M rows), so they read
            # and write all of them
            mu_l, rstd_l = inp["ln"]["mu"], inp["ln"]["rstd"]
            dy2d = dyd.reshape(-1, D)
            runs["ln_fwd"] = [site(
                lambda: ln.ln_fwd(xd, None, g1, b1, 1e-6),
                lambda: ln.ln_fwd_reference(xd, None, g1, b1, 1e-6),
                lambda: F.layer_norm(x2d, (D,), gl1, bl1, 1e-6),
                8 * m_all * D, es * (2 * m_all * D + 2 * D) + 4 * 2 * m_all)]
            runs["ln_bwd"] = [site(
                lambda: ln.ln_bwd(xd, None, g1, mu_l, rstd_l, dyd),
                lambda: ln.ln_bwd_reference(xd, None, g1, mu_l, rstd_l, dyd),
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dy2d, x2d, [D], mu_l.reshape(-1, 1), rstd_l.reshape(-1, 1), gl1, bl1,
                    [True, True, True]),
                12 * m_all * D, es * (3 * m_all * D + D) + 4 * (2 * m_all + 2 * D))]
            # the backward steps, every site of one layer's backward summed, on
            # the inputs recorded in phase 2
            # the GEMM sites by their weight, (out, in) as in nn.Linear
            site_weights = {"linear_residual_ln_fwd": [(D, D), (D, FFN)]}
            site_ms = {}  # (name, site index): CUDA events of the site alone
            for name, calls in inp["bwd_inputs"].items():
                kname = "prefix_attention_bwd" if name == "attention_bwd" else name
                runs[kname] = [site(
                    (lambda a=a, kw=kw, n=name: kernel_step[n](*a, **fresh(kw))),
                    (lambda a=a, kw=kw, n=name: plain_step[n](*a, **fresh(kw))),
                    library_of[name](a, kw), *bwd_cost(name, a, kw)) for a, kw in calls]
                site_weights[kname] = [tuple(a[1].shape) if name == "linear_dgrad"
                                       else (a[0].shape[-1], a[1].shape[-1]) for a, _ in calls]

            layer_bound = 0.0
            for name, sites in runs.items():
                ms = plain_ms = lib_ms = bound = 0.0
                ops_bound = bytes_bound = 0.0
                for i_site, (kernel_fn, plain_fn, lib_fn, ops, nbytes) in enumerate(sites):
                    # kernel, plain, plain, kernel: two readings each, in turns
                    t1 = time_ms(kernel_fn)
                    p1 = time_ms(plain_fn)
                    p2 = time_ms(plain_fn)
                    t2 = time_ms(kernel_fn)
                    ms += (t1 + t2) / 2
                    site_ms[name, i_site] = (t1 + t2) / 2
                    plain_ms += (p1 + p2) / 2
                    lib_before = lib_ms
                    lib_ms += time_ms(lib_fn)
                    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
                    if name in ("linear_residual_ln_fwd", "linear_dgrad", "linear_wgrad"):
                        # each site on its own
                        log(f"    {name + tag} site, weight {site_weights[name][i_site]}: kernel "
                            f"{(t1 + t2) / 2:.4f} ms, library {lib_ms - lib_before:.4f} ms, "
                            f"bound {max(t_ops, t_bytes):.4f} ms")
                    bound += max(t_ops, t_bytes)
                    ops_bound += t_ops
                    bytes_bound += t_bytes
                if name.endswith("_fwd") and name != "ln_fwd":  # the layer's own steps
                    layer_bound += bound
                stats[name + tag].update(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                    bound_by="operations" if ops_bound >= bytes_bound else "bytes")
                log(f"  {name + tag} ({len(sites)} site{'s' * (len(sites) > 1)} of a layer): "
                    f"kernel {ms:.4f} ms ({100 * bound / ms:.1f} % of its bound), plain "
                    f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bound:.4f} ms "
                    f"({stats[name + tag]['bound_by']})")

            # K5/K6 finish on the device faster than the host launches them, so
            # CUDA events read the launch rate; the profiler reads their kernels
            from torch.profiler import ProfilerActivity, profile

            reps = 20
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    ln.ln_fwd(xd, None, g1, b1, 1e-6)
                    ln.ln_bwd(xd, None, g1, mu_l, rstd_l, dyd)
                torch.cuda.synchronize()
            ln_dev = {"ln_fwd": 0.0, "ln_bwd": 0.0}
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    for name, kernels_of in (("ln_fwd", ("ln_fwd_kernel",)),
                                             ("ln_bwd", ("ln_bwd_kernel", "ln_reduce_kernel"))):
                        if any(k in e.key for k in kernels_of):
                            ln_dev[name] += e.self_device_time_total / 1e3 / reps
            # the loop above reads its 12.6 MB tensors back to back from the 50
            # MB L2; ln_bwd once more with the L2 cold, as a caller that has
            # run other work between calls finds it: a 128 MB buffer written
            # before each call (its kernel not counted)
            flush = torch.empty(32 * 2 ** 20, device=dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    flush.zero_()
                    ln.ln_bwd(xd, None, g1, mu_l, rstd_l, dyd)
                torch.cuda.synchronize()
            ln_cold = sum(e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and any(k in e.key for k in ("ln_bwd_kernel", "ln_reduce_kernel")))
            del flush
            log(f"  ln_fwd{tag} / ln_bwd{tag} device time per call (profiler, {reps} calls): "
                f"{ln_dev['ln_fwd']:.4f} / {ln_dev['ln_bwd']:.4f} ms warm, ln_bwd{tag} "
                f"{ln_cold:.4f} ms with the L2 cold; bound (every row) "
                f"{stats['ln_fwd' + tag]['bound_ms']:.4f} / {stats['ln_bwd' + tag]['bound_ms']:.4f} ms")
            # the GEMM steps (K1a, K1b, K1c, K2b, K2c), layernorm_bwd (K2a)
            # and the attention (K3, K4) by the profiler too: at the small
            # sites CUDA events read the wrapper's launch rate; every kernel of
            # the call (K2a's and wgrad's second pass, the attention backward's
            # launches), the layer's sites summed, each kernel also on its own;
            # K1b and K2b also site by site
            def device_ms(fns, attempts=3):
                # a trace can come back without device events (one of 24 such
                # traces in one run on an H100): it is taken again
                for _ in range(attempts):
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(reps):
                            for fn in fns:
                                fn()
                        torch.cuda.synchronize()
                    found = {e.key: e.self_device_time_total / 1e3 / reps
                             for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA}
                    if found:
                        return found
                raise RuntimeError(f"the profiler recorded no device time in {attempts} traces")

            for name in ("ln_linear_fwd", "linear_relu_fwd", "linear_residual_ln_fwd",
                         "layernorm_bwd", "linear_dgrad", "linear_wgrad", "prefix_attention_fwd",
                         "prefix_attention_bwd"):
                per_kernel = device_ms([kernel_fn for kernel_fn, *_ in runs[name]])
                dev_ms = sum(per_kernel.values())
                log(f"  {name + tag} device time per layer (profiler, {reps} x {len(runs[name])} "
                    f"sites): {dev_ms:.4f} ms, bound {stats[name + tag]['bound_ms']:.4f} ms "
                    f"({100 * stats[name + tag]['bound_ms'] / dev_ms:.1f} %); CUDA events "
                    f"{stats[name + tag]['ms']:.4f} ms; "
                    + ", ".join(f"{k[:60]} {v:.4f}" for k, v in
                                sorted(per_kernel.items(), key=lambda kv: -kv[1])))
                if name in ("linear_residual_ln_fwd", "linear_dgrad"):
                    for i_site, (kernel_fn, *_, ops, nbytes) in enumerate(runs[name]):
                        site_dev = sum(device_ms([kernel_fn]).values())
                        site_bound = max(ops / peak, nbytes / PEAK_BYTES) * 1e3
                        log(f"    {name + tag} site, weight {site_weights[name][i_site]}: "
                            f"device {site_dev:.4f} ms (profiler), CUDA events "
                            f"{site_ms[name, i_site]:.4f} ms, bound {site_bound:.4f} ms")
            # K3 and K4 repeat their bits: fixed-order sums, no atomics
            for name in ("prefix_attention_fwd", "prefix_attention_bwd"):
                for kernel_fn, *_ in runs[name]:
                    first, again = kernel_fn(), kernel_fn()
                    torch.cuda.synchronize()
                    ph.check(torch.equal(first, again),
                             f"{name + tag} ({tuple(first.shape)}): the same bits on a second call")

            layer_ms = time_ms(lambda: fused_block.fused_encoder_block(xd, vl, *w, H, EPS1, EPS2))
            layer_plain_ms = time_ms(
                lambda: fused_block.fused_encoder_block_reference(xd, vl, *w, H, EPS1, EPS2))

            def library_layer(x_, ws):  # addmm / SDPA / layer_norm, the yardstick
                wqkv_, bqkv_, wout_, bout_, g1_, b1_, g2_, b2_, w1_, b1f_, w2_, b2f_ = ws
                xf_ = x_.reshape(-1, D)
                qkv_ = torch.addmm(bqkv_, F.layer_norm(xf_, (D,), g1_, b1_, EPS1), wqkv_.t())
                qh_, kh_, vh_ = (heads(t) for t in qkv_.reshape(B, S_PAD, 3 * D).split(D, -1))
                a_ = F.scaled_dot_product_attention(qh_, kh_, vh_, attn_mask=key_ok)
                a_ = a_.transpose(1, 2).reshape(-1, D)
                x2_ = F.layer_norm(torch.addmm(bout_, a_, wout_.t()) + xf_, (D,), g1_, b1_, EPS1)
                h_ = torch.relu(torch.addmm(b1f_, x2_, w1_.t()))
                return F.layer_norm(torch.addmm(b2f_, h_, w2_.t()) + x2_, (D,), g2_, b2_, EPS2)

            lib_ws = (wqkv, bqkv, wout, bout, gl1, bl1, gl2, bl2, w1, b1f, w2, b2f)
            layer_lib_ms = time_ms(lambda: library_layer(xd, lib_ws))
            log(f"  fused_encoder_block{tag} forward (B {B}, S_pad {S_PAD}): kernels "
                f"{layer_ms:.4f} ms, plain {layer_plain_ms:.4f} ms, library "
                f"{layer_lib_ms:.4f} ms, bound {layer_bound:.4f} ms (sum of its steps' bounds)")
            bwd_args = (dyd, xd, vl, inp["ra"], inp["rx2"], inp["rr2"], inp["rlse"], inp["rst"],
                        w, H, EPS1)
            layer_bwd_ms = time_ms(lambda: fused_block.layer_backward(fused_block.KERNEL_STEPS,
                                                                       *bwd_args))
            layer_bwd_plain_ms = time_ms(
                lambda: fused_block.fused_encoder_block_backward_reference(*bwd_args))
            # the library's backward of the same layer: autograd through the
            # addmm / SDPA / layer_norm chain, on one graph kept for the timing
            xl = xd.detach().clone().requires_grad_(True)
            wl = [t.detach().clone().requires_grad_(True) for t in lib_ws]
            yl = library_layer(xl, wl)
            layer_bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
                yl, [xl, *wl], dyd.reshape(-1, D), retain_graph=True))
            del xl, wl, yl
            layer_bwd_bound = sum(stats[n + tag]["bound_ms"] for n in
                                  ("prefix_attention_bwd", "layernorm_bwd", "linear_dgrad",
                                   "linear_wgrad"))
            log(f"  fused_encoder_block{tag} backward (B {B}, S_pad {S_PAD}): kernels "
                f"{layer_bwd_ms:.4f} ms, plain {layer_bwd_plain_ms:.4f} ms, library "
                f"{layer_bwd_lib_ms:.4f} ms (autograd of the addmm/SDPA/layer_norm chain), "
                f"bound of its backward steps {layer_bwd_bound:.4f} ms (the three forward "
                f"recomputes not counted)")

        xb, cb = hub.collate_images(images[:batch])
        xb, cb = xb.to(dev), cb.to(dev)
        for served_model, tag in ((model, ""), (model_b, " bf16")):
            with torch.inference_mode():
                served_model(xb, cb)
                torch.cuda.synchronize()
                t = time.perf_counter()
                reps = 5
                for _ in range(reps):
                    served_model(xb, cb)
                torch.cuda.synchronize()
                per_batch = (time.perf_counter() - t) / reps
            log(f"  served batch{tag} of {batch} images (channels {counts[:batch]}), depth 12: "
                f"{per_batch * 1e3:.2f} ms, {batch / per_batch:.1f} embeddings/s")

        from torch.profiler import ProfilerActivity, profile

        for tag, st, stp, tb, nb, tc, top in (("", state, step, train_batch, TRAIN_B, tcounts, 20),
                                              (" bf16", state_b, step_b, train_batch_b,
                                               TRAIN_BF16_B, tcounts_b, 24)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            reps = 3
            for _ in range(reps):
                st, m = stp(st, tb)
            float(m["dino_loss"])
            torch.cuda.synchronize()
            per_step = (time.perf_counter() - t) / reps
            log(f"  DINO train step{tag}, B {nb} images x 2 global crops (channels {tc}), "
                f"depth 12: {per_step * 1e3:.2f} ms, {nb / per_step:.2f} training images/s "
                f"({smi})")
            # one more step under the profiler: device time by kernel, and the
            # share of the step's wall time the device was busy (the profiler's
            # own cost is in the wall time, so the busy share reads low)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                st, m = stp(st, tb)
                float(m["dino_loss"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            # kernels only: an autograd Function's range also carries the device
            # time of the kernels launched inside it
            events = [e for e in prof.key_averages() if e.self_device_time_total > 0
                      and e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in events) / 1e3
            log(f"  profiled train step{tag}: wall {wall * 1e3:.2f} ms, device busy "
                f"{busy:.2f} ms ({100 * busy / (wall * 1e3):.1f} %), {len(events)} kernel "
                f"names; by device time:")
            ranked = sorted(events, key=lambda e: -e.self_device_time_total)
            # the top kernels, and K1a's, K1b's and the two passes of K2a and
            # K2c wherever they rank
            for rank, e in enumerate(ranked):
                if rank < top or any(k in e.key for k in (
                        "ln_linear", "linear_residual_ln", "layernorm_bwd", "reduce_ln_splits",
                        "linear_wgrad", "reduce_wgrad_splits")):
                    ms = e.self_device_time_total / 1e3
                    log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f} % x{e.count:<5d} "
                        f"#{rank + 1:<3d} {e.key[:90]}")
        _launch.LAUNCHES.clear()
        _launch.LAUNCHES.update(saved)
        ph.check(all(math.isfinite(stats[n]["ms"]) for n in instances),
                 "all kernel instances timed")

    # ---- 6. report ------------------------------------------------------------
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": stats[name]["launches"], "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"], "bound_by": stats[name]["bound_by"],
         "library_ms": stats[name]["library_ms"]}
        for name, (_, src, replaces, _) in instances.items()]}
    if failures:
        for f in failures:
            print(f"FAILED {f}", file=sys.stderr, flush=True)
        return 1
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    sys.exit(main())
