#!/usr/bin/env python3
"""Times the float32 prefix-attention forward (K3) of
``chadavit_tpu_torch/csrc/prefix_attention.cu`` and backward (K4) of
``chadavit_tpu_torch/csrc/prefix_attention_bwd.cu`` on one NVIDIA GPU: the
forward's one launch, and the backward's two (the prep pass, then dk/dv and
dq in one kernel), by CUDA events and by the profiler's device time, as built
and in diagnostic builds of the same sources:

- ``no_copy``: the ``cp.async`` copies do nothing (``-DSGEMM_NO_COPY``), so
  the kernels multiply whatever shared memory holds: the time left is the FMA
  loops, the shared-memory reads, the barriers, the exponentials and the
  writes;
- ``no_fma``: each operand the FMA loops read is added once instead of
  multiplied into every sum (``-DSGEMM_NO_FMA``): the time left is the
  copies, the shared-memory reads, the barriers, the exponentials and the
  writes;
- ``in_order``: the blocks of both take the images in index order rather
  than longest first (``-DATTN_FWD_IN_ORDER``, ``-DATTN_BWD_IN_ORDER``): what
  the order is worth;
- ``fwd_split1``, ``fwd_split2``: the forward's key walk whole in one block,
  or split across a cluster of two blocks whose shares are added in rank
  order through distributed shared memory (``-DATTN_FWD_SPLIT``; as built
  1): what the ragged tail of the long walks costs.

A kernel near ``no_copy`` is held by its loops, one near ``no_fma`` by its
loads. The diagnostic builds ``no_copy`` and ``no_fma`` compute nothing
meaningful; only their times are read. The others print the largest
difference of their forward's o and lse from the build as built. Each build
also prints the registers, shared memory and spills of the three kernels
(``nvcc -Xptxas -v``). Run from the root of the repository:

    python3 scripts/bench_attention_f32.py [train|hub]

``train`` (the default): the float32 train batch, 16 sequences (8 images x 2
crops of the first 8 channel counts of chip_smoke.py's bf16 train batch) of
2048 rows; ``hub``: chip_smoke.py's hub shapes (8 images, 2048 rows). q, k and
v are the column slices of one packed qkv (rows of 576), as the layer passes
them; the backward's o and lse come from the forward kernel as built. Each
call is one launch of the C entry point, without the Python wrapper; the
forward (with its lse) and the whole backward are timed with CUDA events over
20 calls after 3 of warm-up, and each kernel by the profiler's device time
over the same 20 calls. Prints one line per build, the bounds (the
functions' operations at the f32 peak), one PyTorch call for each function
(``scaled_dot_product_attention`` and its autograd, which the port never
calls) and the card's name and power limit.
"""

import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the channel counts of chip_smoke.py's bf16 train batch (synthetic_dino_batch, seed 4)
TRAIN_CHANNELS = [2, 5, 10, 8, 2, 10, 8, 7, 1, 5, 1, 6, 6, 10, 9, 6, 7, 10, 2, 2, 1, 3, 2, 3,
                  6, 3, 8, 4, 6, 3, 9, 3]
HUB_CHANNELS = [1, 3, 5, 10, 2, 7, 9, 10]
S_PAD, D, HEADS = 2048, 192, 2
PEAK_F32_FLOPS = 67e12  # f32 FMA outside the tensor cores, NVIDIA H100 SXM data sheet
KERNELS = ("prefix_attention_kernel", "attention_bwd_prep_kernel", "attention_bwd_kernel")
SOURCES = ("prefix_attention_bwd.cu", "prefix_attention.cu", "attention_f32.cuh",
           "sgemm_f32.cuh", "storage.cuh")
BUILDS = {"as built": [], "no_copy": ["-DSGEMM_NO_COPY"], "no_fma": ["-DSGEMM_NO_FMA"],
          "in_order": ["-DATTN_FWD_IN_ORDER", "-DATTN_BWD_IN_ORDER"],
          **{f"fwd_split{n}": [f"-DATTN_FWD_SPLIT={n}"] for n in (1, 2)}}


def build(out_dir: Path) -> dict:
    """One library of the forward and the backward per build, all compiled at once."""
    from chadavit_tpu_torch.ops import _build

    procs = {}
    for name, flags in BUILDS.items():
        d = out_dir / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
            (d / src).write_text((_build.CSRC / src).read_text())
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-shared", "-o",
             str(d / "lib.so"), str(d / "prefix_attention_bwd.cu"), str(d / "prefix_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for _, proc in procs.values():  # every nvcc ends before any failure is raised
        proc.wait()
    libs = {}
    for name, (path, proc) in procs.items():
        proc.obj = path.with_suffix(".none")  # ptxas_lines removes it; nvcc wrote none
        report = _build.ptxas_lines(proc)  # raises if nvcc failed
        print(f"{name}: ptxas " + ", ".join(
            f"{next(kn for kn in KERNELS if kn in k['name'])} {k.get('registers')} regs "
            f"{k.get('smem')} B static smem {k.get('spill_stores')}/{k.get('spill_loads')} B "
            "spilled" for k in report if any(kn in k["name"] for kn in KERNELS)), flush=True)
        lib = ctypes.CDLL(str(path))
        for fn in ("prefix_attention_fwd", "prefix_attention_bwd"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from chadavit_tpu_torch.ops import flash_attention as fa
    from chadavit_tpu_torch.ops._build import BUILD_DIR

    if not torch.cuda.is_available():
        print("bench_attention_f32: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    which = sys.argv[1] if len(sys.argv) > 1 else "train"
    channels = TRAIN_CHANNELS[:8] * 2 if which == "train" else HUB_CHANNELS
    valid = [1 + 196 * c for c in channels]
    dev = torch.device("cuda")
    libs = build(BUILD_DIR / "bench_attention_f32")
    bsz, hd = len(valid), D // HEADS
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(bsz, S_PAD, 3 * D, device=dev, generator=gen)
    dout = torch.randn(bsz, S_PAD, D, device=dev, generator=gen)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    out = torch.empty(bsz, S_PAD, D, device=dev)
    lse = torch.empty(bsz, HEADS, S_PAD, device=dev)
    dqkv = torch.empty(bsz, S_PAD, 3 * D, device=dev)
    delta, _ = fa._bwd_scratch(bsz, HEADS, S_PAD, D, torch.float32, dev)
    qscale = fa._qscale(hd, torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    third = D * 4
    fwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), 3 * D, vl.data_ptr(), out.data_ptr(),
                D, lse.data_ptr(), bsz, HEADS, hd, S_PAD, qscale, stream)
    bwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), 3 * D, out.data_ptr(),
                dout.data_ptr(), D, lse.data_ptr(), delta.data_ptr(), vl.data_ptr(),
                dqkv.data_ptr(), dqkv.data_ptr() + third, dqkv.data_ptr() + 2 * third, 3 * D,
                bsz, HEADS, hd, S_PAD, qscale, 1.0 / math.sqrt(hd), stream)
    iters = 20

    def time_ms(fn):
        for _ in range(3):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    sq = sum(n * n for n in valid) * HEADS * hd  # sum of vl^2 hd over images and heads
    print(f"{which}: {bsz} sequences of {S_PAD} rows, {sum(valid)} valid; bound (f32 "
          f"operations at {PEAK_F32_FLOPS / 1e12:g} TFLOP/s): forward "
          f"{4 * sq / PEAK_F32_FLOPS * 1e3:.4f} ms, backward "
          f"{10 * sq / PEAK_F32_FLOPS * 1e3:.4f} ms", flush=True)

    def device_ms(fn):
        """Each kernel's profiler device time a call, over iters calls of fn."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return {kn: sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA and kn in e.key)
                / 1e3 / iters for kn in KERNELS}

    assert libs["as built"].prefix_attention_fwd(*fwd_args) == 0
    torch.cuda.synchronize()
    ref_out, ref_lse = out.clone(), lse.clone()
    for name, lib in libs.items():
        assert lib.prefix_attention_fwd(*fwd_args) == 0
        torch.cuda.synchronize()
        diff = ("" if name.startswith("no_") else
                f", o and lse differ from as built by at most "
                f"{(out - ref_out).abs().max().item():.3e} and "
                f"{(lse - ref_lse).abs().max().item():.3e}")
        fwd_ms = time_ms(lambda: lib.prefix_attention_fwd(*fwd_args))
        fwd_dev = device_ms(lambda: lib.prefix_attention_fwd(*fwd_args))[KERNELS[0]]
        # the backward reads the forward's o and lse as built
        assert libs["as built"].prefix_attention_fwd(*fwd_args) == 0
        assert lib.prefix_attention_bwd(*bwd_args) == 0
        bwd_ms = time_ms(lambda: lib.prefix_attention_bwd(*bwd_args))
        dev_ms = device_ms(lambda: lib.prefix_attention_bwd(*bwd_args))
        print(f"{name}: forward {fwd_ms:.4f} ms ({fwd_dev:.4f} ms device time{diff}); backward "
              f"{bwd_ms:.4f} ms (prep {dev_ms[KERNELS[1]]:.4f}, dk/dv and dq "
              f"{dev_ms[KERNELS[2]]:.4f} ms device time)", flush=True)

    def heads(t):
        return t.reshape(bsz, S_PAD, HEADS, hd).transpose(1, 2)

    key_ok = (torch.arange(S_PAD, device=dev)[None, :] < vl[:, None])[:, None, None, :]
    qh, kh, vh = (heads(t).detach().requires_grad_(True) for t in (q, k, v))
    with torch.no_grad():
        fwd_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                    attn_mask=key_ok))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok)
    lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), heads(dout),
                                                 retain_graph=True))
    print(f"library: scaled_dot_product_attention {fwd_lib_ms:.4f} ms, its autograd "
          f"{lib_ms:.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
