#!/usr/bin/env python3
"""Times the bf16 tensor-core prefix attention of
``chadavit_tpu_torch/csrc/prefix_attention_bf16.cu`` on one NVIDIA GPU: the
forward (K3, with the lse, as the train path calls it) and the three launches
of the backward (K4: the prep pass, dk/dv, dq), as built and in two
diagnostic builds of the same source:

- ``no_copy``: the ``cp.async`` copies do nothing, so the kernels multiply
  whatever shared memory holds: the time left is the tensor-core loop, the
  softmax, the barriers, the epilogue and the writes;
- ``no_mma``: each ``mma.sync`` is an integer add on its registers, so the
  time left is the copies, the ``ldmatrix`` loads, the softmax, the barriers
  and the writes.

The two bracket what bounds each kernel: one near ``no_copy`` is held by its
loop, one near ``no_mma`` by its loads. The diagnostic builds compute nothing
meaningful; only their times are read. Run from the root of the repository:

    python3 scripts/bench_attention_bf16.py [train|hub]

``train`` (the default): 64 sequences (32 images x 2 crops of the channel
counts of chip_smoke.py's bf16 train batch) of 2048 rows; ``hub``:
chip_smoke.py's hub shapes (8 images, 2048 rows). q, k and v are the column
slices of one packed qkv (rows of 576), as the layer passes them. Each call
is one launch of the C entry point, without the Python wrapper; the forward
and the whole backward are timed with CUDA events over 20 calls after 3 of
warm-up, and each backward kernel by the profiler's device time over the
same 20 calls. Prints one line per build, the bound of each function (its
operations at the bf16 tensor-core peak) and the card's name and power limit.
"""

import ctypes
import math
import re
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
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor cores, NVIDIA H100 SXM data sheet
KERNELS = ("attention_bwd_prep_kernel", "attention_dkdv_bf16_kernel",
           "attention_dq_bf16_kernel")


def _no_copy(header: str) -> str:
    return re.sub(r'asm volatile\("cp\.async\.cg.*?\);', "", header, flags=re.S)


def _no_mma(header: str) -> str:
    return re.sub(r'asm volatile\(\s*"mma\.sync.*?\);',
                  "c[0] += __uint_as_float(a[0] ^ b0); c[1] += __uint_as_float(a[1] ^ b1);",
                  header, flags=re.S)


BUILDS = {"as built": None, "no_copy": _no_copy, "no_mma": _no_mma}


def build(out_dir: Path) -> dict:
    """One library of prefix_attention_bf16.cu per build, compiled in parallel."""
    from chadavit_tpu_torch.ops import _build

    sources = ("prefix_attention_bf16.cu", "mma_bf16.cuh", "storage.cuh")
    procs = {}
    for name, patch in BUILDS.items():
        d = out_dir / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for src in sources:
            text = (_build.CSRC / src).read_text()
            (d / src).write_text(patch(text) if patch and src == "mma_bf16.cuh" else text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "prefix_attention_bf16.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(path))
        for fn in ("prefix_attention_fwd_bf16", "prefix_attention_bwd_bf16"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chadavit_tpu_torch.ops import flash_attention as fa
    from chadavit_tpu_torch.ops._build import BUILD_DIR

    if not torch.cuda.is_available():
        print("bench_attention_bf16: needs a CUDA device", file=sys.stderr)
        return 1
    which = sys.argv[1] if len(sys.argv) > 1 else "train"
    channels = TRAIN_CHANNELS * 2 if which == "train" else HUB_CHANNELS
    valid = [1 + 196 * c for c in channels]
    dev = torch.device("cuda")
    libs = build(BUILD_DIR / "bench_attention_bf16")
    bsz, hd = len(valid), D // HEADS
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def bf(*shape):
        return torch.randn(*shape, device=dev, generator=gen).bfloat16()

    qkv, dout = bf(bsz, S_PAD, 3 * D), bf(bsz, S_PAD, D)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    out = torch.empty(bsz, S_PAD, D, dtype=torch.bfloat16, device=dev)
    lse = torch.empty(bsz, HEADS, S_PAD, device=dev)
    dqkv = torch.empty(bsz, S_PAD, 3 * D, dtype=torch.bfloat16, device=dev)
    delta, _ = fa._bwd_scratch(bsz, HEADS, S_PAD, D, torch.bfloat16, dev)
    qscale = fa._qscale(hd, torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    third = D * 2
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
    print(f"{which}: {bsz} sequences of {S_PAD} rows, {sum(valid)} valid; bound (bf16 "
          f"operations at {PEAK_BF16_FLOPS / 1e12:g} TFLOP/s): forward "
          f"{4 * sq / PEAK_BF16_FLOPS * 1e3:.4f} ms, backward "
          f"{10 * sq / PEAK_BF16_FLOPS * 1e3:.4f} ms", flush=True)
    for name, lib in libs.items():
        assert lib.prefix_attention_fwd_bf16(*fwd_args) == 0
        fwd_ms = time_ms(lambda: lib.prefix_attention_fwd_bf16(*fwd_args))
        if name == "as built":  # the diagnostic builds leave garbage in out and lse
            ref_lse = lse.clone()
        else:
            lse.copy_(ref_lse)
        assert lib.prefix_attention_bwd_bf16(*bwd_args) == 0
        bwd_ms = time_ms(lambda: lib.prefix_attention_bwd_bf16(*bwd_args))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                lib.prefix_attention_bwd_bf16(*bwd_args)
            torch.cuda.synchronize()
        dev_ms = {kn: sum(e.self_device_time_total for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA and kn in e.key)
                  / 1e3 / iters for kn in KERNELS}
        print(f"{name}: forward {fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms (prep "
              f"{dev_ms[KERNELS[0]]:.4f}, dkdv {dev_ms[KERNELS[1]]:.4f}, dq "
              f"{dev_ms[KERNELS[2]]:.4f} ms device time)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
