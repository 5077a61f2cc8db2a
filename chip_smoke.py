#!/usr/bin/env python3
"""Smoke run of chadavit_tpu_torch on one NVIDIA GPU: the served embedding path
of ChAdaViT-moyen through the port's hand-written CUDA kernels.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds at its start and end:

0. guard: a watchdog ends a hang after WATCHDOG_S with a traceback; no CUDA
   device means exit 1 (there is no CPU path); TF32 off; the card's name and
   power limit from nvidia-smi.
1. build: nvcc compiles csrc/*.cu into one library (cold build seconds).
2. each kernel against its plain PyTorch version at hub shapes (B 8,
   S_pad 2048, D 192, F 2048, 2 heads, 1..10 channels), then the whole layer.
3. the depth-2, full-width model on the card against the committed JAX
   fixture tests/goldens/torch_port_cls_depth2.npz.
4. the served path: load_chadavit16_moyen() at depth 12 with seeded weights,
   extract_embeddings on 24 images in batches of 8; the launch count of every
   kernel must be what 12 layers x 3 batches imply, and the embeddings must
   match the same model run through the plain versions on the card.
5. times with CUDA events: each kernel, its plain version, one PyTorch call
   for the same function (a yardstick the port never calls), its bound.
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
FIXTURE = Path(__file__).resolve().parent / "tests" / "goldens" / "torch_port_cls_depth2.npz"

# hub shapes
B, S_PAD, D, H, FFN = 8, 2048, 192, 2, 2048
COUNTS = [1, 3, 5, 10, 2, 7, 9, 10]
N_PATCHES = 196
EPS1, EPS2 = 1e-5, 1e-5

# max abs error against the plain version on rows < valid_len (f32 on both
# sides; the kernels sum in another order than cuBLAS)
KERNEL_TOL = 1e-4
LAYER_TOL = 2e-4
FIXTURE_COS = 1 - 1e-5  # per-row cosine against the JAX fixture
FIXTURE_TOL = 5e-4      # max abs against the JAX fixture, after 2 layers
SERVED_COS = 1 - 1e-5   # per-row cosine, kernels against plain versions, 12 layers

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


def plain_embeddings(model, x, cc):
    """The model's CLS embeddings with every layer through the plain
    versions of the kernels (fused_encoder_block_reference), on x's device."""
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

    dev = torch.device("cuda")
    kernels = {  # name -> wrapper, source, the TPU kernel it replaces
        "ln_linear_fwd": (fused_block.ln_linear, "chadavit_tpu_torch/csrc/fused_block.cu",
                          "chadavit_tpu/ops/fused_block.py:91"),
        "prefix_attention_fwd": (fa.prefix_flash_attention,
                                 "chadavit_tpu_torch/csrc/prefix_attention.cu",
                                 "chadavit_tpu/ops/flash_attention.py:103"),
        "linear_relu_fwd": (fused_block.linear_relu, "chadavit_tpu_torch/csrc/fused_block.cu",
                            "chadavit_tpu/ops/fused_block.py:91"),
        "linear_residual_ln_fwd": (fused_block.linear_residual_ln,
                                   "chadavit_tpu_torch/csrc/fused_block.cu",
                                   "chadavit_tpu/ops/fused_block.py:91"),
    }
    stats = {name: {} for name in kernels}

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
            stats[name]["max_abs_err"] = worst[0]
            ph.check(worst[0] <= KERNEL_TOL,
                     f"{name}: max abs {worst[0]:.3e}, max rel {worst[1]:.3e} "
                     f"(tolerance {KERNEL_TOL:g} abs)")
        layer = fused_block.fused_encoder_block(x, vl, *w, H, EPS1, EPS2)
        layer_ref = fused_block.fused_encoder_block_reference(x, vl, *w, H, EPS1, EPS2)
        torch.cuda.synchronize()
        err, rel = valid_rows_err(layer, layer_ref, valid_len)
        ph.check(err <= LAYER_TOL, f"fused_encoder_block chain: max abs {err:.3e}, "
                                   f"max rel {rel:.3e} (tolerance {LAYER_TOL:g} abs)")

    # ---- 3. the depth-2 model against the JAX fixture -----------------------
    with Phase("3 JAX fixture", failures) as ph:
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

    # ---- 4. the served path -------------------------------------------------
    n_served, batch = 24, 8
    with Phase("4 served path", failures) as ph:
        model = hub.load_chadavit16_moyen(seed=0)  # device=None: the card
        counts = [1 + i % 10 for i in range(n_served)]
        images = hub.random_images(counts, 224, seed=2)
        for wrapper, _, _ in kernels.values():
            wrapper.launches = 0
        t = time.perf_counter()
        emb = hub.extract_embeddings(model, images, batch_size=batch)
        served_s = time.perf_counter() - t
        launches = {name: wrapper.launches for name, (wrapper, _, _) in kernels.items()}
        layer_batches = len(model.blocks) * math.ceil(n_served / batch)
        expected = {"ln_linear_fwd": layer_batches, "prefix_attention_fwd": layer_batches,
                    "linear_relu_fwd": layer_batches, "linear_residual_ln_fwd": 2 * layer_batches}
        for name in kernels:
            stats[name]["launches"] = launches[name]
        ph.check(emb.shape == (n_served, D) and bool(np.isfinite(emb).all()),
                 f"embeddings {emb.shape}, all finite ({served_s:.2f} s for {n_served} images)")
        ph.check(launches == expected, f"launches {launches} == expected {expected}")
        with torch.inference_mode():
            plain = []
            for s in range(0, n_served, batch):
                xb, cb = hub.collate_images(images[s:s + batch])
                plain.append(plain_embeddings(model, xb.to(dev), cb.to(dev)).cpu())
        plain = torch.cat(plain)
        cos = cosine_rows(torch.from_numpy(emb), plain)
        err = (torch.from_numpy(emb) - plain).abs().max().item()
        ph.check(cos.min().item() >= SERVED_COS,
                 f"kernels against plain versions on the card: min cosine "
                 f"1 - {1 - cos.min().item():.2e} (>= 1 - {1 - SERVED_COS:.0e}), max abs {err:.3e}")

    # ---- 5. times -------------------------------------------------------------
    with Phase("5 times", failures) as ph:
        rows = sum(valid_len)  # rows the kernels must compute
        m_all = B * S_PAD
        x2d, attn2d, x22d, hid2d = (t.reshape(-1, t.shape[-1]) for t in (x, attn, x2, hid))
        key_ok = (torch.arange(S_PAD, device=dev)[None, :] < vl[:, None])[:, None, None, :]
        qh, kh, vh = (t.reshape(B, S_PAD, H, D // H).transpose(1, 2) for t in (q, k, v))
        runs = {
            "ln_linear_fwd": [(
                lambda: fused_block.ln_linear(x, g1, b1, EPS1, wqkv, bqkv, vl),
                lambda: fused_block.ln_linear_reference(x, g1, b1, EPS1, wqkv, bqkv),
                lambda: torch.addmm(bqkv, F.layer_norm(x2d, (D,), g1, b1, EPS1), wqkv.t()),
                2 * rows * D * 3 * D, 4 * (rows * D + 3 * D * D + 3 * D + 2 * D + m_all * 3 * D))],
            "prefix_attention_fwd": [(
                lambda: fa.prefix_flash_attention(q, k, v, vl, H),
                lambda: fa.prefix_flash_attention_reference(q, k, v, vl, H),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok),
                sum(4 * n * n * D for n in valid_len), 4 * (3 * rows * D + m_all * D))],
            "linear_relu_fwd": [(
                lambda: fused_block.linear_relu(x2, w1, b1f, vl),
                lambda: fused_block.linear_relu_reference(x2, w1, b1f),
                lambda: torch.relu(torch.addmm(b1f, x22d, w1.t())),
                2 * rows * D * FFN, 4 * (rows * D + FFN * D + FFN + m_all * FFN))],
            "linear_residual_ln_fwd": [(  # both sites of a layer, summed
                lambda: fused_block.linear_residual_ln(attn, wout, bout, x, g1, b1, EPS1, vl),
                lambda: fused_block.linear_residual_ln_reference(attn, wout, bout, x, g1, b1, EPS1),
                lambda: F.layer_norm(torch.addmm(bout, attn2d, wout.t()) + x2d, (D,), g1, b1, EPS1),
                2 * rows * D * D, 4 * (2 * rows * D + D * D + 3 * D + m_all * D)), (
                lambda: fused_block.linear_residual_ln(hid, w2, b2f, x2, g2, b2, EPS2, vl),
                lambda: fused_block.linear_residual_ln_reference(hid, w2, b2f, x2, g2, b2, EPS2),
                lambda: F.layer_norm(torch.addmm(b2f, hid2d, w2.t()) + x22d, (D,), g2, b2, EPS2),
                2 * rows * FFN * D, 4 * (rows * FFN + rows * D + FFN * D + 3 * D + m_all * D))],
        }
        saved = {name: wrapper.launches for name, (wrapper, _, _) in kernels.items()}
        for name, sites in runs.items():
            ms = plain_ms = lib_ms = bound = 0.0
            ops_bound = bytes_bound = 0.0
            for kernel_fn, plain_fn, lib_fn, ops, nbytes in sites:
                # kernel, plain, plain, kernel: two readings each, in turns
                k1 = time_ms(kernel_fn)
                p1 = time_ms(plain_fn)
                p2 = time_ms(plain_fn)
                k2 = time_ms(kernel_fn)
                ms += (k1 + k2) / 2
                plain_ms += (p1 + p2) / 2
                lib_ms += time_ms(lib_fn)
                t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
                bound += max(t_ops, t_bytes)
                ops_bound += t_ops
                bytes_bound += t_bytes
            stats[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                               bound_by="operations" if ops_bound >= bytes_bound else "bytes")
            log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {lib_ms:.4f} ms, bound {bound:.4f} ms ({stats[name]['bound_by']})")
        for name, (wrapper, _, _) in kernels.items():  # timing launches do not count
            wrapper.launches = saved[name]
        layer_ms = time_ms(lambda: fused_block.fused_encoder_block(x, vl, *w, H, EPS1, EPS2))
        layer_plain_ms = time_ms(
            lambda: fused_block.fused_encoder_block_reference(x, vl, *w, H, EPS1, EPS2))
        log(f"  fused_encoder_block (B {B}, S_pad {S_PAD}): kernels {layer_ms:.4f} ms, "
            f"plain {layer_plain_ms:.4f} ms")
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
