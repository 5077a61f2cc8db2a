#!/usr/bin/env python3
"""Times the bf16 tensor-core ``ln_linear_fwd`` (K1a, LN1 + QKV),
``linear_relu_fwd`` (K1c) and ``linear_residual_ln_fwd`` (K1b, at the out
projection, K 192, and at FFN2, K 2048) of
``chadavit_tpu_torch/csrc/linear_fwd_bf16.cu`` site by site on one NVIDIA GPU,
as built and in two diagnostic builds of the same source:

- ``no_copy``: the ``cp.async`` copies do nothing, so the kernels multiply
  whatever shared memory holds: the time left is the tensor-core loop, the
  barriers, the epilogue and the writes;
- ``no_mma``: each ``mma.sync`` is an integer add on its registers, so the
  time left is the copies, the ``ldmatrix`` loads, the barriers, the
  epilogue and the writes.

The two bracket what holds each site: a site near ``no_copy`` is held by its
products, one near ``no_mma`` by its copies, and one near both by what both
keep (the ``ldmatrix`` loads, the barriers, the epilogue and its writes). The diagnostic builds
compute nothing meaningful; only their times are read. Run from the root of
the repository:

    python3 scripts/bench_linear_fwd_bf16.py [train|hub]

``train`` (the default): 64 sequences (32 images x 2 crops of the channel
counts of chip_smoke.py's bf16 train batch) padded to 2048 rows; ``hub``:
chip_smoke.py's hub shapes (8 images, 2048 rows). Times are CUDA events over
20 calls after 3 of warm-up and the profiler's device time per call over the
same 20, each call one launch of the C entry point, without the Python
wrapper. K1a and the K1b sites run without and with the save outputs (LN
stats, and r at K1b, as the train step's student forward writes them). Each site's bound is
the larger of its operations over 989 TFLOP/s and its bytes over 3.35 TB/s
(inputs on the rows < valid_len read once, the whole output written once),
as chip_smoke.py counts them. Prints one line per build, then what holds each
site and the card's name and power limit.
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
S_PAD = 2048
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
ENTRIES = ("linear_relu_fwd_bf16", "linear_residual_ln_fwd_bf16", "ln_linear_fwd_bf16")


def _no_copy(header: str) -> str:
    return re.sub(r'asm volatile\("cp\.async\.cg.*?\);', "", header, flags=re.S)


def _no_mma(header: str) -> str:
    return re.sub(r'asm volatile\(\s*"mma\.sync.*?\);',
                  "c[0] += __uint_as_float(a[0] ^ b0); c[1] += __uint_as_float(a[1] ^ b1);",
                  header, flags=re.S)


BUILDS = {"as built": None, "no_copy": _no_copy, "no_mma": _no_mma}


def build(out_dir: Path) -> dict:
    """One library of linear_fwd_bf16.cu per build, compiled in parallel."""
    from chadavit_tpu_torch.ops import _build

    sources = ("linear_fwd_bf16.cu", "mma_bf16.cuh", "gemm_common.cuh", "storage.cuh")
    procs = {}
    for name, patch in BUILDS.items():
        d = out_dir / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for src in sources:
            text = (_build.CSRC / src).read_text()
            (d / src).write_text(patch(text) if patch and src == "mma_bf16.cuh" else text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "linear_fwd_bf16.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(path))
        for fn in ENTRIES:
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chadavit_tpu_torch.ops import fused_block
    from chadavit_tpu_torch.ops._build import BUILD_DIR

    if not torch.cuda.is_available():
        print("bench_linear_fwd_bf16: needs a CUDA device", file=sys.stderr)
        return 1
    which = sys.argv[1] if len(sys.argv) > 1 else "train"
    channels = TRAIN_CHANNELS * 2 if which == "train" else HUB_CHANNELS
    valid = [1 + 196 * c for c in channels]
    dev = torch.device("cuda")
    libs = build(BUILD_DIR / "bench_linear_fwd_bf16")
    bsz, m = len(valid), len(valid) * S_PAD
    rows = sum(valid)
    d, f = fused_block.D_MODEL, fused_block.D_FFN
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def bf(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).bfloat16()

    x, hid, res = bf(m, d), bf(m, f), bf(m, d)
    w1, b1 = bf(f, d, scale=d ** -0.5), bf(f, scale=0.1)
    wqkv, bqkv = bf(3 * d, d, scale=d ** -0.5), bf(3 * d, scale=0.1)
    out_qkv = torch.empty(m, 3 * d, dtype=torch.bfloat16, device=dev)
    wk = {d: bf(d, d, scale=d ** -0.5), f: bf(d, f, scale=f ** -0.5)}
    bk = bf(d, scale=0.1)
    g, beta = torch.ones(d, device=dev), torch.zeros(d, device=dev)
    out_relu = torch.empty(m, f, dtype=torch.bfloat16, device=dev)
    out_ln, r = torch.empty(m, d, dtype=torch.bfloat16, device=dev), torch.empty_like(res)
    mean, rstd = torch.empty(m, device=dev), torch.empty(m, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    # (site, entry, its arguments but the library, operations, bytes)
    sites = []
    for save in (False, True):
        stats = (mean.data_ptr(), rstd.data_ptr()) if save else (None, None)
        sites.append((
            f"K1a LN1+QKV 192->576{' save' if save else ''}", ENTRIES[2],
            (x.data_ptr(), g.data_ptr(), beta.data_ptr(), 1e-5, wqkv.data_ptr(), bqkv.data_ptr(),
             out_qkv.data_ptr(), *stats, vl.data_ptr(), m, d, 3 * d, S_PAD, stream),
            2 * rows * d * 3 * d,
            2 * (rows * d + 3 * d * d + 3 * d + m * 3 * d) + 4 * 2 * d + save * 4 * 2 * m))
    sites.append(("K1c relu 192->2048", ENTRIES[0],
                  (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), out_relu.data_ptr(),
                   vl.data_ptr(), m, d, f, S_PAD, stream),
                  2 * rows * d * f, 2 * (rows * d + f * d + f + m * f)))
    for k, a in ((d, x), (f, hid)):
        for save in (False, True):
            saved = (mean.data_ptr(), rstd.data_ptr(), r.data_ptr()) if save else (None,) * 3
            sites.append((
                f"K1b K {k}{' save' if save else ''}", ENTRIES[1],
                (a.data_ptr(), wk[k].data_ptr(), bk.data_ptr(), res.data_ptr(), g.data_ptr(),
                 beta.data_ptr(), 1e-5, out_ln.data_ptr(), *saved, vl.data_ptr(), m, k, d, S_PAD,
                 stream),
                2 * rows * k * d,
                2 * (rows * k + rows * d + k * d + d + m * d) + 4 * 2 * d
                + save * (2 * m * d + 4 * 2 * m)))

    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        a_, b_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a_.record()
        for _ in range(iters):
            fn()
        b_.record()
        torch.cuda.synchronize()
        return a_.elapsed_time(b_) / iters

    def device_ms(fn, iters=20):
        """The profiler's device time per call; a second window when the first
        reads nothing (the profiler can drop a window's events)."""
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters
            if ms > 0:
                return ms
        return math.nan

    print(f"{which}: {bsz} sequences of {S_PAD} rows, {rows} valid", flush=True)
    times = {}
    for name, lib in libs.items():
        cells = []
        for site, entry, args, _, _ in sites:
            fn = getattr(lib, entry)
            assert fn(*args) == 0, (name, site)
            call = (lambda fn=fn, args=args: fn(*args))
            times[name, site] = (time_ms(call), device_ms(call))
            cells.append(f"{site} {times[name, site][0]:.4f} / {times[name, site][1]:.4f}")
        print(f"{name} (CUDA events / profiler device ms): " + ", ".join(cells), flush=True)
    for site, _, _, ops, nbytes in sites:
        # the profiler's device times, or CUDA events where it read nothing
        built, no_copy, no_mma = (times[b, site][1] if times[b, site][1] > 0
                                  else times[b, site][0] for b in BUILDS)
        t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        # what is left without the loads, and without the products
        if no_copy >= 0.8 * built and no_mma >= 0.8 * built:
            held = ("what both diagnostic builds keep: the ldmatrix loads, the barriers, "
                    "the epilogue and its writes")
        elif no_copy >= 0.8 * built:
            held = "its products (the copies hide behind them)"
        elif no_mma >= 0.8 * built:
            held = "its copies (the products hide behind them)"
        else:
            held = "copies and products together: each keeps part of the time"
        print(f"{site}: device {built:.4f} ms, bound {bound:.4f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}; {100 * bound / built:.1f} %); "
              f"without the copies {100 * no_copy / built:.0f} %, without the mma "
              f"{100 * no_mma / built:.0f} % of its time: held by {held}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
