#!/usr/bin/env python3
"""Smoke run of chadavit_tpu_torch on one NVIDIA GPU: the served embedding path
and the DINO train step of ChAdaViT-moyen through the port's hand-written CUDA
kernels.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds at its start and end:

0. guard: a watchdog ends a hang after WATCHDOG_S with a traceback; no CUDA
   device means exit 1 (there is no CPU path); TF32 off; the card's name and
   power limit from nvidia-smi.
1. build: nvcc compiles csrc/*.cu, one process per source, into one library
   (cold build seconds).
2. each kernel against its plain PyTorch version at hub shapes (B 8,
   S_pad 2048, D 192, F 2048, 2 heads, 1..10 channels): the forward kernels,
   their save outputs (LN stats, pre-LN sum, lse), then every backward kernel
   on the inputs the layer's backward gives it; the whole layer forward; the
   layer's backward through FusedEncoderBlock against torch.autograd.grad of
   fused_encoder_block_reference, with a cotangent that is zero past valid_len.
3. the JAX fixtures: the depth-2, full-width model's CLS embeddings
   (tests/goldens/torch_port_cls_depth2.npz) and three DINO train steps of
   that backbone with the canonical head (tests/goldens/torch_port_dino_depth2.npz).
4. the served path: load_chadavit16_moyen() at depth 12 with seeded weights,
   extract_embeddings on 24 images in batches of 8; the launch count of every
   kernel must be what 12 layers x 3 batches imply, and the embeddings must
   match the same model run through the plain versions on the card.
4b. the train path: build_dino(DinoPretrainSpec()) at depth 12 on the card,
   synthetic_dino_batch of 8 images, 3 steps: the loss is finite, the launch
   count of every kernel is what 12 layers x 3 steps x (teacher + student)
   imply, and step 1 agrees with step 1 of a plain backbone
   (fused_encoder_block_reference) from the same state.
5. times with CUDA events: each kernel, its plain version, one PyTorch call
   for the same function (a yardstick the port never calls), its bound; the
   whole layer forward and backward; the served batch and the train step.
6. one JSON line with every kernel, then the last line
   {"ok": true, "device": {...}}. A failed phase prints no last line and
   exits 1.
"""

import faulthandler
import json
import math
import subprocess
import sys
import time
from pathlib import Path

WATCHDOG_S = 480
GOLDENS = Path(__file__).resolve().parent / "tests" / "goldens"
FIXTURE = GOLDENS / "torch_port_cls_depth2.npz"
DINO_FIXTURE = GOLDENS / "torch_port_dino_depth2.npz"

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

# the card's peaks (NVIDIA H100 SXM data sheet): f32 outside the tensor cores,
# and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
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
    from chadavit_tpu_torch.ops import _build, fused_block
    from chadavit_tpu_torch.ops import flash_attention as fa
    from chadavit_tpu_torch.train.pretrain import (
        DinoPretrainSpec,
        build_dino,
        synthetic_dino_batch,
    )

    dev = torch.device("cuda")
    fb_cu = "chadavit_tpu_torch/csrc/fused_block.cu"
    fbb_cu = "chadavit_tpu_torch/csrc/fused_block_bwd.cu"
    k1, k2 = "chadavit_tpu/ops/fused_block.py:91", "chadavit_tpu/ops/fused_block.py:211"
    kernels = {  # name -> wrapper, source, the TPU kernel it replaces
        "ln_linear_fwd": (fused_block.ln_linear, fb_cu, k1),
        "prefix_attention_fwd": (fa.prefix_flash_attention,
                                 "chadavit_tpu_torch/csrc/prefix_attention.cu",
                                 "chadavit_tpu/ops/flash_attention.py:103"),
        "linear_relu_fwd": (fused_block.linear_relu, fb_cu, k1),
        "linear_residual_ln_fwd": (fused_block.linear_residual_ln, fb_cu, k1),
        "prefix_attention_bwd": (fa.prefix_attention_bwd,
                                 "chadavit_tpu_torch/csrc/prefix_attention_bwd.cu",
                                 "chadavit_tpu/ops/flash_attention.py:157"),
        "layernorm_bwd": (fused_block.layernorm_bwd, fbb_cu, k2),
        "linear_dgrad": (fused_block.linear_dgrad, fbb_cu, k2),
        "linear_wgrad": (fused_block.linear_wgrad, fbb_cu, k2),
    }
    stats = {name: {"max_abs_err": 0.0} for name in kernels}

    def reset_launches():
        for wrapper, _, _ in kernels.values():
            wrapper.launches = 0

    def read_launches():
        return {name: wrapper.launches for name, (wrapper, _, _) in kernels.items()}

    # ---- 1. build -----------------------------------------------------------
    with Phase("1 build", failures) as ph:
        cold = not (_build.BUILD_DIR / _build.source_hash()).exists()
        t = time.perf_counter()
        _build.library()
        ph.check(True, f"{'cold' if cold else 'warm'} build of {len(_build.sources())} "
                       f"sources: {time.perf_counter() - t:.2f} s")

    # ---- 2. kernels against their plain versions at hub shapes --------------
    valid_len = [1 + N_PATCHES * c for c in COUNTS]
    with Phase("2 kernels vs plain", failures) as ph:
        rng = np.random.default_rng(0)

        def dev_randn(*shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

        x = dev_randn(B, S_PAD, D)
        vl = torch.tensor(valid_len, dtype=torch.int32, device=dev)
        w = [dev_randn(3 * D, D, scale=D ** -0.5), dev_randn(3 * D, scale=0.02),
             dev_randn(D, D, scale=D ** -0.5), dev_randn(D, scale=0.02),
             1 + dev_randn(D, scale=0.1), dev_randn(D, scale=0.05),
             1 + dev_randn(D, scale=0.1), dev_randn(D, scale=0.05),
             dev_randn(FFN, D, scale=D ** -0.5), dev_randn(FFN, scale=0.02),
             dev_randn(D, FFN, scale=FFN ** -0.5), dev_randn(D, scale=0.02)]
        wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = w
        # inputs of each step are the plain chain's own intermediates
        qkv = fused_block.ln_linear_reference(x, g1, b1, EPS1, wqkv, bqkv)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        attn = fa.prefix_flash_attention_reference(q, k, v, vl, H)
        x2 = fused_block.linear_residual_ln_reference(attn, wout, bout, x, g1, b1, EPS1)
        hid = fused_block.linear_relu_reference(x2, w1, b1f)

        def note(name, err, tol, what):
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            ph.check(err <= tol, f"{name}{what}: max abs {err:.3e} (tolerance {tol:.3g})")

        cases = {
            "ln_linear_fwd": [(lambda: fused_block.ln_linear(x, g1, b1, EPS1, wqkv, bqkv, vl),
                               lambda: qkv)],
            "prefix_attention_fwd": [(lambda: fa.prefix_flash_attention(q, k, v, vl, H),
                                      lambda: attn)],
            "linear_relu_fwd": [(lambda: fused_block.linear_relu(x2, w1, b1f, vl), lambda: hid)],
            "linear_residual_ln_fwd": [
                (lambda: fused_block.linear_residual_ln(attn, wout, bout, x, g1, b1, EPS1, vl),
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
                worst = max(worst, valid_rows_err(out, plain_fn(), valid_len))
            note(name, worst[0], KERNEL_TOL, f" (max rel {worst[1]:.3e})")

        # the save outputs: LN stats, the pre-LN sum, the lse
        _, (ra, rx2, rr2, rlse, rst) = fused_block.layer_forward(
            fused_block.PLAIN_STEPS, x, vl, tuple(w), H, EPS1, EPS2, save=True)
        _, (ka, kx2, kr2, klse, kst) = fused_block.layer_forward(
            fused_block.KERNEL_STEPS, x, vl, tuple(w), H, EPS1, EPS2, save=True)
        torch.cuda.synchronize()
        st_err = [valid_rows_err(a[..., None], b_[..., None], valid_len)[0]
                  for a, b_ in zip(kst, rst)]
        note("ln_linear_fwd", max(st_err[:2]), KERNEL_TOL, " save outputs mean, rstd")
        note("linear_residual_ln_fwd", max(st_err[2:] + [valid_rows_err(kr2, rr2, valid_len)[0]]),
             KERNEL_TOL, " save outputs mean, rstd, r2")
        lse_err = max((klse[i, :, :n] - rlse[i, :, :n]).abs().max().item()
                      for i, n in enumerate(valid_len))
        note("prefix_attention_fwd", lse_err, KERNEL_TOL, " save output lse")

        # every backward step on the inputs the layer's backward chain gives it
        dy = dev_randn(B, S_PAD, D)
        for i, n in enumerate(valid_len):
            dy[i, n:] = 0
        rec = Recorder(fused_block.PLAIN_STEPS)
        fused_block.layer_backward(rec, dy, x, vl, ra, rx2, rr2, rlse, rst, w, H, EPS1)
        kernel_step = {"layernorm_bwd": fused_block.layernorm_bwd,
                       "linear_dgrad": fused_block.linear_dgrad,
                       "linear_wgrad": fused_block.linear_wgrad,
                       "attention_bwd": fa.prefix_attention_bwd}
        bwd_inputs = {name: [] for name in kernel_step}  # kept for phase 5
        for name, (args, kwargs), ref_out in rec.calls:
            if name not in kernel_step:
                continue
            bwd_inputs[name].append((args, kwargs))
            out = kernel_step[name](*args, **kwargs)
            torch.cuda.synchronize()
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref_out if isinstance(ref_out, tuple) else (ref_out,)
            for o, r in zip(outs, refs):
                if o.dim() == 3:  # rows of the activation: the valid ones, and zeros past
                    err = valid_rows_err(o, r, valid_len)[0]
                    mag = max(r[i, :n].abs().max().item() for i, n in enumerate(valid_len))
                    pad_ok = all(not o[i, n:].any().item() for i, n in enumerate(valid_len))
                    ph.check(pad_ok, f"{name}: rows past valid_len are zero")
                else:
                    err, mag = (o - r).abs().max().item(), r.abs().max().item()
                kname = "prefix_attention_bwd" if name == "attention_bwd" else name
                note(kname, err, GRAD_REL * max(1.0, mag), f" (output scale {mag:.3g})")

        layer = fused_block.fused_encoder_block(x, vl, *w, H, EPS1, EPS2)
        layer_ref = fused_block.fused_encoder_block_reference(x, vl, *w, H, EPS1, EPS2)
        torch.cuda.synchronize()
        err, rel = valid_rows_err(layer, layer_ref, valid_len)
        ph.check(err <= LAYER_TOL, f"fused_encoder_block chain: max abs {err:.3e}, "
                                   f"max rel {rel:.3e} (tolerance {LAYER_TOL:g} abs)")

        # the layer's backward: FusedEncoderBlock against plain autograd. A
        # pre-activation within rounding of 0 can flip its ReLU mask between
        # the kernel and the plain forward and move a whole gradient row (the
        # kink of ReLU; these seeded inputs have none), so the same backward is
        # also held against the plain backward chain on the residuals the
        # Function's own forward saves, which isolates the backward kernels
        xg = x.clone().requires_grad_(True)
        wg = [t.clone().requires_grad_(True) for t in w]
        before = read_launches()
        y = fused_block.fused_encoder_block(xg, vl, *wg, H, EPS1, EPS2)
        ph.check(type(y.grad_fn).__name__ == "FusedEncoderBlockBackward",
                 f"grad_fn of the layer on CUDA: {type(y.grad_fn).__name__}")
        grads = torch.autograd.grad(y, [xg, *wg], dy)
        torch.cuda.synchronize()
        bwd_launched = {n: read_launches()[n] - before[n] for n in
                        ("prefix_attention_bwd", "layernorm_bwd", "linear_dgrad", "linear_wgrad")}
        ph.check(bwd_launched == {"prefix_attention_bwd": 1, "layernorm_bwd": 3,
                                  "linear_dgrad": 4, "linear_wgrad": 4},
                 f"one layer backward launched {bwd_launched}")
        y_ref = fused_block.fused_encoder_block_reference(xg, vl, *wg, H, EPS1, EPS2)
        grads_ref = torch.autograd.grad(y_ref, [xg, *wg], dy)
        err, rel = valid_rows_err(grads[0], grads_ref[0], valid_len)
        ph.check(err <= KERNEL_TOL * max(1.0, grads_ref[0].abs().max().item()),
                 f"layer backward dx on valid rows: max abs {err:.3e}, max rel {rel:.3e}")
        ph.check(all(not grads[0][i, n:].any().item() for i, n in enumerate(valid_len)),
                 "layer backward dx past valid_len is exactly zero")
        names = ["wqkv", "bqkv", "wout", "bout", "g1", "b1", "g2", "b2", "w1", "b1f", "w2",
                 "b2f"]
        worst = max(((gk - gr).abs().max().item() / gr.abs().max().item(), n)
                    for n, gk, gr in zip(names, grads[1:], grads_ref[1:]))
        ph.check(worst[0] <= GRAD_REL, f"layer backward, 12 parameter grads: worst max abs "
                                       f"over max |ref| {worst[0]:.3e} ({worst[1]}; "
                                       f"tolerance {GRAD_REL:g})")
        same = fused_block.fused_encoder_block_backward_reference(
            dy, x, vl, ka, kx2, kr2, klse, kst, w, H, EPS1)
        err = valid_rows_err(grads[0], same[0], valid_len)[0]
        worst = max(((gk - gr.reshape(gk.shape)).abs().max().item() / gr.abs().max().item(), n)
                    for n, gk, gr in zip(names, grads[1:], same[1:]))
        ph.check(err <= KERNEL_TOL * max(1.0, same[0].abs().max().item())
                 and worst[0] <= GRAD_REL,
                 f"layer backward against the plain backward chain on the Function's own "
                 f"residuals: dx max abs {err:.3e}, 12 grads worst max abs over max |ref| "
                 f"{worst[0]:.3e} ({worst[1]})")
        del xg, wg, y, grads, y_ref, grads_ref, rec, same

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
        expected = {name: 0 for name in kernels}
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

    # ---- 4b. the train path ---------------------------------------------------
    with Phase("4b train path", failures) as ph:
        spec = DinoPretrainSpec()
        state, step, backbone, _ = build_dino(spec)  # device=None: the card
        train_batch = synthetic_dino_batch(spec, TRAIN_B, seed=4)
        tcounts = train_batch["channel_counts"].tolist()
        start = {n: p.detach().clone() for n, p in state.trainable()}
        reset_launches()
        losses = []
        t = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state, m = step(state, train_batch)
            losses.append(float(m["dino_loss"]))
            if len(losses) == 1:
                after_step1 = {n: p.detach().clone() for n, p in state.trainable()}
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        launches = read_launches()
        runs = len(backbone.blocks) * TRAIN_STEPS  # layer runs of each model per path
        expected = {"ln_linear_fwd": 3 * runs, "prefix_attention_fwd": 2 * runs,
                    "linear_relu_fwd": 3 * runs, "linear_residual_ln_fwd": 5 * runs,
                    "prefix_attention_bwd": runs, "layernorm_bwd": 3 * runs,
                    "linear_dgrad": 4 * runs, "linear_wgrad": 4 * runs}
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
        worst_cos, worst_delta = 1.0, 1.0
        for n, p in pstate.trainable():
            a, b_ = after_step1[n].double().flatten(), p.detach().double().flatten()
            worst_cos = min(worst_cos, torch.nn.functional.cosine_similarity(a, b_, 0).item())
            da, db_ = a - start[n].double().flatten(), b_ - start[n].double().flatten()
            if da.norm() > 0 and db_.norm() > 0:
                worst_delta = min(worst_delta,
                                  torch.nn.functional.cosine_similarity(da, db_, 0).item())
        ph.check(loss_rel <= TRAIN_LOSS_REL and worst_cos >= TRAIN_PARAM_COS,
                 f"step 1, kernels against the plain backbone: loss rel {loss_rel:.2e} "
                 f"(<= {TRAIN_LOSS_REL:g}), worst per-tensor cosine of the updated "
                 f"parameters 1 - {1 - worst_cos:.2e} (>= 1 - {1 - TRAIN_PARAM_COS:.0e}); "
                 f"worst cosine of the updates themselves 1 - {1 - worst_delta:.2e}")
        del pstate, pstep, start, after_step1
        torch.cuda.empty_cache()

    # ---- 5. times -------------------------------------------------------------
    with Phase("5 times", failures) as ph:
        rows = sum(valid_len)  # rows the kernels must compute
        m_all = B * S_PAD
        x2d, attn2d, x22d, hid2d = (t.reshape(-1, t.shape[-1]) for t in (x, attn, x2, hid))
        key_ok = (torch.arange(S_PAD, device=dev)[None, :] < vl[:, None])[:, None, None, :]
        qh, kh, vh = (t.reshape(B, S_PAD, H, D // H).transpose(1, 2) for t in (q, k, v))

        def site(kernel_fn, plain_fn, lib_fn, ops, nbytes):
            return kernel_fn, plain_fn, lib_fn, ops, nbytes

        runs = {
            "ln_linear_fwd": [site(
                lambda: fused_block.ln_linear(x, g1, b1, EPS1, wqkv, bqkv, vl),
                lambda: fused_block.ln_linear_reference(x, g1, b1, EPS1, wqkv, bqkv),
                lambda: torch.addmm(bqkv, F.layer_norm(x2d, (D,), g1, b1, EPS1), wqkv.t()),
                2 * rows * D * 3 * D, 4 * (rows * D + 3 * D * D + 3 * D + 2 * D + m_all * 3 * D))],
            "prefix_attention_fwd": [site(
                lambda: fa.prefix_flash_attention(q, k, v, vl, H),
                lambda: fa.prefix_flash_attention_reference(q, k, v, vl, H),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok),
                sum(4 * n * n * D for n in valid_len), 4 * (3 * rows * D + m_all * D))],
            "linear_relu_fwd": [site(
                lambda: fused_block.linear_relu(x2, w1, b1f, vl),
                lambda: fused_block.linear_relu_reference(x2, w1, b1f),
                lambda: torch.relu(torch.addmm(b1f, x22d, w1.t())),
                2 * rows * D * FFN, 4 * (rows * D + FFN * D + FFN + m_all * FFN))],
            "linear_residual_ln_fwd": [site(  # both sites of a layer, summed
                lambda: fused_block.linear_residual_ln(attn, wout, bout, x, g1, b1, EPS1, vl),
                lambda: fused_block.linear_residual_ln_reference(attn, wout, bout, x, g1, b1, EPS1),
                lambda: F.layer_norm(torch.addmm(bout, attn2d, wout.t()) + x2d, (D,), g1, b1, EPS1),
                2 * rows * D * D, 4 * (2 * rows * D + D * D + 3 * D + m_all * D)), site(
                lambda: fused_block.linear_residual_ln(hid, w2, b2f, x2, g2, b2, EPS2, vl),
                lambda: fused_block.linear_residual_ln_reference(hid, w2, b2f, x2, g2, b2, EPS2),
                lambda: F.layer_norm(torch.addmm(b2f, hid2d, w2.t()) + x22d, (D,), g2, b2, EPS2),
                2 * rows * FFN * D, 4 * (rows * FFN + rows * D + FFN * D + 3 * D + m_all * D))],
        }

        # the backward steps, every site of one layer's backward summed, on the
        # inputs recorded in phase 2
        plain_step = {"layernorm_bwd": fused_block.layernorm_bwd_reference,
                      "linear_dgrad": fused_block.linear_dgrad_reference,
                      "linear_wgrad": fused_block.linear_wgrad_reference,
                      "attention_bwd": fa.prefix_flash_attention_backward_reference}

        def fresh(kwargs):  # layernorm_bwd sums into dgb in place: a copy per call
            return {k: (v.clone() if k == "dgb" else v) for k, v in kwargs.items()}

        def ln_bwd_library(args, kwargs):  # the site-1 residual add is left out
            dy_, xin, mean, rstd, g = args[:5]
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
            q_, k_, v_ = (t.detach().reshape(B, S_PAD, H, D // H).transpose(1, 2)
                          .requires_grad_(True) for t in args[:3])
            do_ = args[5].reshape(B, S_PAD, H, D // H).transpose(1, 2)
            out = F.scaled_dot_product_attention(q_, k_, v_, attn_mask=key_ok)
            return lambda: torch.autograd.grad(out, (q_, k_, v_), do_, retain_graph=True)

        def bwd_cost(name, args, kwargs):
            """(operations, bytes) the step must do on this run's rows."""
            if name == "layernorm_bwd":
                nres = kwargs.get("residual") is not None
                return 10 * rows * D, 4 * ((2 + nres) * rows * D + 2 * rows + D
                                           + m_all * D + 2 * D)
            if name == "linear_dgrad":
                kk, nn_ = args[1].shape
                aux = kwargs.get("relu_of") is not None or kwargs.get("residual") is not None
                return 2 * rows * kk * nn_, 4 * (rows * kk + kk * nn_ + aux * rows * nn_
                                                 + m_all * nn_)
            if name == "linear_wgrad":
                nn_, kk = args[0].shape[-1], args[1].shape[-1]
                return 2 * rows * nn_ * kk + rows * nn_, 4 * (rows * (nn_ + kk) + nn_ * kk + nn_)
            return (sum(10 * n * n * D for n in valid_len),
                    4 * (5 * rows * D + 2 * H * rows + 3 * m_all * D))

        library_of = {"layernorm_bwd": ln_bwd_library, "linear_dgrad": dgrad_library,
                      "linear_wgrad": wgrad_library, "attention_bwd": attention_bwd_library}
        for name, calls in bwd_inputs.items():
            kname = "prefix_attention_bwd" if name == "attention_bwd" else name
            runs[kname] = [site(
                (lambda a=a, kw=kw, n=name: kernel_step[n](*a, **fresh(kw))),
                (lambda a=a, kw=kw, n=name: plain_step[n](*a, **fresh(kw))),
                library_of[name](a, kw), *bwd_cost(name, a, kw)) for a, kw in calls]

        saved = read_launches()
        layer_bound = 0.0
        for name, sites in runs.items():
            ms = plain_ms = lib_ms = bound = 0.0
            ops_bound = bytes_bound = 0.0
            for kernel_fn, plain_fn, lib_fn, ops, nbytes in sites:
                # kernel, plain, plain, kernel: two readings each, in turns
                t1 = time_ms(kernel_fn)
                p1 = time_ms(plain_fn)
                p2 = time_ms(plain_fn)
                t2 = time_ms(kernel_fn)
                ms += (t1 + t2) / 2
                plain_ms += (p1 + p2) / 2
                lib_ms += time_ms(lib_fn)
                t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
                bound += max(t_ops, t_bytes)
                ops_bound += t_ops
                bytes_bound += t_bytes
            if name.endswith("_fwd"):
                layer_bound += bound
            stats[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                               bound_by="operations" if ops_bound >= bytes_bound else "bytes")
            log(f"  {name} ({len(sites)} site{'s' * (len(sites) > 1)} of a layer): kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
                f"bound {bound:.4f} ms ({stats[name]['bound_by']})")
        for name, (wrapper, _, _) in kernels.items():  # timing launches do not count
            wrapper.launches = saved[name]

        layer_ms = time_ms(lambda: fused_block.fused_encoder_block(x, vl, *w, H, EPS1, EPS2))
        layer_plain_ms = time_ms(
            lambda: fused_block.fused_encoder_block_reference(x, vl, *w, H, EPS1, EPS2))

        def library_layer():  # addmm / SDPA / layer_norm, the yardstick of the forward
            qkv_ = torch.addmm(bqkv, F.layer_norm(x2d, (D,), g1, b1, EPS1), wqkv.t())
            qh_, kh_, vh_ = (t.reshape(B, S_PAD, H, D // H).transpose(1, 2)
                             for t in qkv_.reshape(B, S_PAD, 3 * D).split(D, -1))
            a_ = F.scaled_dot_product_attention(qh_, kh_, vh_, attn_mask=key_ok)
            a_ = a_.transpose(1, 2).reshape(-1, D)
            x2_ = F.layer_norm(torch.addmm(bout, a_, wout.t()) + x2d, (D,), g1, b1, EPS1)
            h_ = torch.relu(torch.addmm(b1f, x2_, w1.t()))
            return F.layer_norm(torch.addmm(b2f, h_, w2.t()) + x2_, (D,), g2, b2, EPS2)

        layer_lib_ms = time_ms(library_layer)
        log(f"  fused_encoder_block forward (B {B}, S_pad {S_PAD}): kernels {layer_ms:.4f} ms, "
            f"plain {layer_plain_ms:.4f} ms, library {layer_lib_ms:.4f} ms, "
            f"bound {layer_bound:.4f} ms (sum of its steps' bounds)")
        bwd_args = (dy, x, vl, ra, rx2, rr2, rlse, rst, w, H, EPS1)
        layer_bwd_ms = time_ms(lambda: fused_block.layer_backward(fused_block.KERNEL_STEPS,
                                                                   *bwd_args))
        layer_bwd_plain_ms = time_ms(
            lambda: fused_block.fused_encoder_block_backward_reference(*bwd_args))
        layer_bwd_bound = sum(stats[n]["bound_ms"] for n in
                              ("prefix_attention_bwd", "layernorm_bwd", "linear_dgrad",
                               "linear_wgrad"))
        log(f"  fused_encoder_block backward (B {B}, S_pad {S_PAD}): kernels "
            f"{layer_bwd_ms:.4f} ms, plain {layer_bwd_plain_ms:.4f} ms, bound of its "
            f"backward steps {layer_bwd_bound:.4f} ms (the three forward recomputes not counted)")
        for name, (wrapper, _, _) in kernels.items():
            wrapper.launches = saved[name]

        xb, cb = hub.collate_images(images[:batch])
        xb, cb = xb.to(dev), cb.to(dev)
        with torch.inference_mode():
            model(xb, cb)
            torch.cuda.synchronize()
            t = time.perf_counter()
            reps = 5
            for _ in range(reps):
                model(xb, cb)
            torch.cuda.synchronize()
            per_batch = (time.perf_counter() - t) / reps
        log(f"  served batch of {batch} images (channels {counts[:batch]}), depth 12: "
            f"{per_batch * 1e3:.2f} ms, {batch / per_batch:.1f} embeddings/s")

        torch.cuda.synchronize()
        t = time.perf_counter()
        reps = 3
        for _ in range(reps):
            state, m = step(state, train_batch)
        float(m["dino_loss"])
        torch.cuda.synchronize()
        per_step = (time.perf_counter() - t) / reps
        log(f"  DINO train step, B {TRAIN_B} images x 2 global crops (channels {tcounts}), "
            f"depth 12: {per_step * 1e3:.2f} ms, {TRAIN_B / per_step:.2f} training images/s "
            f"({smi})")
        # one more step under the profiler: device time by kernel, and the share
        # of the step's wall time the device was busy (the profiler's own cost
        # is in the wall time, so the busy share reads low)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            state, m = step(state, train_batch)
            float(m["dino_loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        # kernels only: an autograd Function's range also carries the device time
        # of the kernels launched inside it
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0
                  and e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        log(f"  profiled train step: wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy / (wall * 1e3):.1f} %), {len(events)} kernel names; by device time:")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
            ms = e.self_device_time_total / 1e3
            log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f} % x{e.count:<5d} {e.key[:90]}")
        for name, (wrapper, _, _) in kernels.items():
            wrapper.launches = saved[name]
        ph.check(all(math.isfinite(stats[n]["ms"]) for n in kernels), "all kernels timed")

    # ---- 6. report ------------------------------------------------------------
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": stats[name]["launches"], "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"], "bound_by": stats[name]["bound_by"],
         "library_ms": stats[name]["library_ms"]}
        for name, (_, src, replaces) in kernels.items()]}
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
