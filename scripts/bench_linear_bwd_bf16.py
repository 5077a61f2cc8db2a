#!/usr/bin/env python3
"""Times the bf16 tensor-core ``linear_dgrad`` / ``linear_wgrad`` of
``chadavit_tpu_torch/csrc/linear_bwd_bf16.cu`` site by site on one NVIDIA GPU,
as built and in two diagnostic builds of the same source:

- ``no_copy``: the ``cp.async`` copies do nothing, so the kernels multiply
  whatever shared memory holds: the time left is the tensor-core loop, the
  barriers, the epilogue and the writes;
- ``no_mma``: each ``mma.sync`` is an integer add on its registers, so the
  time left is the copies, the ``ldmatrix`` loads, the barriers and the writes.

The two bracket what bounds each site: a site near ``no_copy`` is held by its
loop, one near ``no_mma`` by its loads. The diagnostic builds compute nothing
meaningful; only their times are read. Run from the root of the repository:

    python3 scripts/bench_linear_bwd_bf16.py [train|hub|d64]

``train`` (the default): 64 sequences (32 images x 2 crops of the channel
counts of chip_smoke.py's bf16 train batch) padded to 2048 rows; ``hub``:
chip_smoke.py's hub shapes (8 images, 2048 rows). Times are CUDA events over
20 calls after 3 of warm-up, each call one launch of the C entry point (and
wgrad's second pass), without the Python wrapper. Prints one line per build
and the card's name and power limit.

``d64``: the four data-gradient sites of the smoke width (D 64, FFN 2048) at
the hub shapes, as built, each by CUDA events and by the profiler's device
time, beside one PyTorch call for the same function: ``torch.addmm`` with the
residual, ``torch.mm`` elsewhere, and at the ReLU-mask site (K 64 -> N 2048)
two readings, ``torch.mm`` then ``masked_fill_`` where ``hid <= 0`` (the
kernel's function) and ``torch.mm`` alone (the mask left out); the sites'
sums at the end. The port never calls these library functions.
"""

import ctypes
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


def _no_copy(header: str) -> str:
    return re.sub(r'asm volatile\("cp\.async\.cg.*?\);', "", header, flags=re.S)


def _no_mma(header: str) -> str:
    return re.sub(r'asm volatile\(\s*"mma\.sync.*?\);',
                  "c[0] += __uint_as_float(a[0] ^ b0); c[1] += __uint_as_float(a[1] ^ b1);",
                  header, flags=re.S)


BUILDS = {"as built": None, "no_copy": _no_copy, "no_mma": _no_mma}


def build(out_dir: Path) -> dict:
    """One library of linear_bwd_bf16.cu per build, compiled in parallel."""
    from chadavit_tpu_torch.ops import _build

    sources = ("linear_bwd_bf16.cu", "mma_bf16.cuh", "gemm_common.cuh", "storage.cuh")
    procs = {}
    for name, patch in BUILDS.items():
        d = out_dir / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for src in sources:
            text = (_build.CSRC / src).read_text()
            (d / src).write_text(patch(text) if patch and src == "mma_bf16.cuh" else text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "linear_bwd_bf16.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(path))
        for fn in ("linear_dgrad_bf16", "linear_wgrad_bf16"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    from chadavit_tpu_torch.ops import fused_block
    from chadavit_tpu_torch.ops._build import BUILD_DIR

    if not torch.cuda.is_available():
        print("bench_linear_bwd_bf16: needs a CUDA device", file=sys.stderr)
        return 1
    which = sys.argv[1] if len(sys.argv) > 1 else "train"
    if which == "d64":
        return main_d64()
    channels = TRAIN_CHANNELS * 2 if which == "train" else HUB_CHANNELS
    valid = [1 + 196 * c for c in channels]
    dev = torch.device("cuda")
    libs = build(BUILD_DIR / "bench_linear_bwd_bf16")
    bsz, m = len(valid), len(valid) * S_PAD
    d, f = fused_block.D_MODEL, fused_block.D_FFN
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def bf(*shape):
        return torch.randn(*shape, device=dev, generator=gen).bfloat16()

    dy = {d: bf(m, d), 3 * d: bf(m, 3 * d), f: bf(m, f)}
    x = {d: bf(m, d), f: bf(m, f)}
    mean, rstd = torch.zeros(m, device=dev), torch.ones(m, device=dev)
    g, beta = torch.ones(d, device=dev), torch.zeros(d, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def time_ms(fn, iters=20):
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

    print(f"{which}: {bsz} sequences of {S_PAD} rows, {sum(valid)} valid", flush=True)
    for name, lib in libs.items():
        cells = []
        for n, k in ((3 * d, d), (d, d), (f, d), (d, f)):  # wgrad, (N, K)
            splits = fused_block.wgrad_splits(bsz, S_PAD, n, k)
            partial = torch.empty(splits, n * k + n, device=dev)
            dwb = torch.empty(n * k + n, device=dev)
            ln = (mean.data_ptr(), rstd.data_ptr(), g.data_ptr(), beta.data_ptr()) \
                if n == 3 * d else (None,) * 4
            args = (dy[n].data_ptr(), x[k].data_ptr(), *ln, partial.data_ptr(), dwb.data_ptr(),
                    vl.data_ptr(), m, n, k, S_PAD, splits, stream)
            assert lib.linear_wgrad_bf16(*args) == 0
            cells.append(f"wgrad ({n}, {k}) {time_ms(lambda: lib.linear_wgrad_bf16(*args)):.4f}")
        for k, n, epi in ((d, f, 1), (f, d, 2), (d, d, 0), (3 * d, d, 0)):  # dgrad, K -> N
            w = bf(k, n)
            aux = x[n] if epi else None
            out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
            args = (dy[k].data_ptr(), w.data_ptr(), None if aux is None else aux.data_ptr(),
                    out.data_ptr(), epi, vl.data_ptr(), m, k, n, S_PAD, stream)
            assert lib.linear_dgrad_bf16(*args) == 0
            cells.append(f"dgrad {k}->{n} {time_ms(lambda: lib.linear_dgrad_bf16(*args)):.4f}")
        print(f"{name}: " + ", ".join(cells) + " (ms)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


def main_d64() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chadavit_tpu_torch.ops import fused_block
    from chadavit_tpu_torch.ops._build import BUILD_DIR

    valid = [1 + 196 * c for c in HUB_CHANNELS]
    dev = torch.device("cuda")
    lib = build(BUILD_DIR / "bench_linear_bwd_bf16")["as built"]
    bsz, m = len(valid), len(valid) * S_PAD
    d, f = fused_block.D_SMALL, fused_block.D_FFN
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def bf(*shape):
        return torch.randn(*shape, device=dev, generator=gen).bfloat16()

    def events(fn, iters=20):
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

    def device(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters

    print(f"d64 hub: {bsz} sequences of {S_PAD} rows, {sum(valid)} valid, D {d}, FFN {f}",
          flush=True)
    totals = {"kernel": [0.0, 0.0], "library": [0.0, 0.0], "library, mask left out": [0.0, 0.0]}
    for k, n, epi in ((d, f, 1), (f, d, 2), (d, d, 0), (3 * d, d, 0)):  # K -> N
        dy, w = bf(m, k), bf(k, n)
        aux = bf(m, n) if epi else None
        out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        args = (dy.data_ptr(), w.data_ptr(), None if aux is None else aux.data_ptr(),
                out.data_ptr(), epi, vl.data_ptr(), m, k, n, S_PAD, stream)

        def kernel(args=args):
            assert lib.linear_dgrad_bf16(*args) == 0

        if epi == 1:  # the ReLU mask of hid = aux
            readings = {"library": lambda dy=dy, w=w, aux=aux: torch.mm(dy, w).masked_fill_(
                            aux <= 0, 0.0),
                        "library, mask left out": lambda dy=dy, w=w: torch.mm(dy, w)}
        elif epi == 2:
            readings = {"library": lambda dy=dy, w=w, aux=aux: torch.addmm(aux, dy, w)}
        else:
            readings = {"library": lambda dy=dy, w=w: torch.mm(dy, w)}
        if epi != 1:
            readings["library, mask left out"] = readings["library"]
        cells = []
        for name, fn in (("kernel", kernel), *readings.items()):
            ev, dv = events(fn), device(fn)
            totals[name][0] += ev
            totals[name][1] += dv
            if epi == 1 or name != "library, mask left out":
                cells.append(f"{name} {ev:.4f} ms (device {dv:.4f})")
        print(f"dgrad {k}->{n}" + (" (ReLU mask)" if epi == 1 else " (residual)" if epi == 2
                                   else "") + ": " + ", ".join(cells), flush=True)
    print("the four sites: " + ", ".join(f"{name} {ev:.4f} ms (device {dv:.4f})"
                                         for name, (ev, dv) in totals.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
