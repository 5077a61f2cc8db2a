#!/usr/bin/env python3
"""Times the float32 ``linear_relu_fwd`` (K1c), ``linear_residual_ln_fwd``
(K1b, both sites), ``linear_wgrad`` (K2c, all four sites, both passes) and
``linear_dgrad`` (K2b, all four sites) of
``chadavit_tpu_torch/csrc/fused_block.cu`` and
``fused_block_bwd.cu`` on one NVIDIA GPU, as built and in diagnostic builds of
the same sources:

- ``no_copy``: the ``cp.async`` copies do nothing (``-DSGEMM_NO_COPY``), so the
  kernels multiply whatever shared memory holds: the time left is the FMA
  loop, the shared-memory reads, the barriers and the epilogue;
- ``no_fma``: each operand the FMA loop reads is added once instead of
  multiplied into every sum (``-DSGEMM_NO_FMA``): the time left is the copies,
  the shared-memory reads, the barriers and the epilogue;
- ``split_ffn1`` ... ``split_ffn8``: K1b's FFN2 site, K2b's FFN1 site
  (both K 2048) and K2b's QKV site (K 576) with clusters of 1, 2, 4 or 8
  blocks splitting K (``-DLRN_SPLIT_FFN``, ``-DDG_SPLIT_FFN``,
  ``-DDG_SPLIT_QKV``; as built 2 each). More blocks even out the SMs'
  share of the row tiles; fewer leave each block a longer K loop;
- ``k1c_slabs1`` ... ``k1c_slabs8``: K1c's block walks 1, 2, 4 or 8 slabs of
  256 output columns (``-DLR_SLABS``; as built 1): more slabs copy the
  block's x rows and fill the ring fewer times, fewer make more blocks;
- ``k1c_stages2``, ``k1c_stages4``: K1c's ring of 2 or 4 slots
  (``-DLR_STAGES``; as built 3).

A site near ``no_copy`` is held by its loop, one near ``no_fma`` by its
loads. Each build also prints the registers and spills of the two kernels
(``nvcc -Xptxas -v``). The diagnostic builds compute nothing meaningful; only their times are
read. It also times each wgrad site at other split counts than the plan
(``ops/fused_block.py::wgrad_splits``), one PyTorch call for the same function
per site (``torch.mm``; ``addmm``, with ``layer_norm`` for K1b and ``relu``
for K1c), and prints the
wgrad partial scratch at 8, 16 and 64 sequences. Run from the root of the
repository:

    python3 scripts/bench_linear_f32.py [train|hub]

``train`` (the default): the float32 train batch, 8 images x 2 crops (the
first 8 channel counts of chip_smoke.py's bf16 train batch) padded to 2048
rows; ``hub``: chip_smoke.py's hub shapes (8 images, 2048 rows). Times are
CUDA events over 20 calls after 3 of warm-up, each call one launch of the C
entry point (wgrad: both passes), without the Python wrapper. Prints one
line per build, the bound of K1c and of each K2b site (its operations at the
f32 peak) and the card's name and power limit.
"""

import ctypes
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
SOURCES = ("fused_block.cu", "fused_block_bwd.cu", "sgemm_f32.cuh", "gemm_common.cuh",
           "storage.cuh")
BUILDS = {"as built": [], "no_copy": ["-DSGEMM_NO_COPY"], "no_fma": ["-DSGEMM_NO_FMA"],
          **{f"split_ffn{n}": [f"-DLRN_SPLIT_FFN={n}", f"-DDG_SPLIT_FFN={n}",
                               f"-DDG_SPLIT_QKV={n}"] for n in (1, 2, 4, 8)},
          **{f"k1c_slabs{n}": [f"-DLR_SLABS={n}"] for n in (1, 2, 4, 8)},
          **{f"k1c_stages{n}": [f"-DLR_STAGES={n}"] for n in (2, 4)}}
PEAK_F32_FLOPS = 67e12  # f32 FMA outside the tensor cores, NVIDIA H100 SXM data sheet
KERNELS = ("linear_relu", "linear_residual_ln", "linear_wgrad", "linear_dgrad")


def build(out_dir: Path) -> dict:
    """One library of the two sources per build (the K1c builds: of
    fused_block.cu alone), all compiled at once."""
    from chadavit_tpu_torch.ops import _build

    procs = {}
    for name, flags in BUILDS.items():
        d = out_dir / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
            (d / src).write_text((_build.CSRC / src).read_text())
        files = ("fused_block.cu",) if name.startswith("k1c") else ("fused_block.cu",
                                                                     "fused_block_bwd.cu")
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-shared", "-o",
             str(d / "lib.so"), *(str(d / f) for f in files)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for _, proc in procs.values():  # every nvcc ends before any failure is raised
        proc.wait()
    libs = {}
    for name, (path, proc) in procs.items():
        proc.obj = path.with_suffix(".none")  # ptxas_lines removes it; nvcc wrote none
        report = _build.ptxas_lines(proc)  # raises if nvcc failed
        print(f"{name}: ptxas " + ", ".join(
            f"{k['name'].split('_kernel')[0][-18:]}{'<' + k['name'].split('ILi')[1][:8] if 'ILi' in k['name'] else ''}"
            f" {k.get('registers')} regs {k.get('spill_stores')}/{k.get('spill_loads')} B spilled"
            for k in report if any(n in k["name"] for n in KERNELS)), flush=True)
        lib = ctypes.CDLL(str(path))
        for fn in ("linear_relu_fwd", "linear_residual_ln_fwd") + (
                () if name.startswith("k1c") else ("linear_wgrad", "linear_dgrad")):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F

    from chadavit_tpu_torch.ops import fused_block
    from chadavit_tpu_torch.ops._build import BUILD_DIR

    if not torch.cuda.is_available():
        print("bench_linear_f32: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    which = sys.argv[1] if len(sys.argv) > 1 else "train"
    channels = TRAIN_CHANNELS[:8] * 2 if which == "train" else HUB_CHANNELS
    valid = [1 + 196 * c for c in channels]
    dev = torch.device("cuda")
    libs = build(BUILD_DIR / "bench_linear_f32")
    bsz, m = len(valid), len(valid) * S_PAD
    d, f = fused_block.D_MODEL, fused_block.D_FFN
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    act = {d: rn(m, d), 3 * d: rn(m, 3 * d), f: rn(m, f)}
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

    rows = sum(-(-n // 32) * 32 for n in valid)
    print(f"{which}: {bsz} sequences of {S_PAD} rows, {sum(valid)} valid, {rows} in computed "
          "32-row tiles", flush=True)
    lrn_sites = []
    for k in (d, f):  # K1b: a (M, K), w (192, K)
        w, bias = rn(d, k, scale=k ** -0.5), rn(d, scale=0.1)
        out, res = torch.empty(m, d, device=dev), act[d]
        lrn_sites.append((k, w, bias, res, out))

    def lrn_args(k, w, bias, res, out):
        return (act[k].data_ptr(), w.data_ptr(), bias.data_ptr(), res.data_ptr(), g.data_ptr(),
                beta.data_ptr(), 1e-5, out.data_ptr(), None, None, None, vl.data_ptr(), m, k,
                d, S_PAD, stream)

    def wgrad_args(n, k, splits):
        partial = torch.empty(splits, n * k + n, device=dev)
        dwb = torch.empty(n * k + n, device=dev)
        ln = (mean.data_ptr(), rstd.data_ptr(), g.data_ptr(), beta.data_ptr()) \
            if n == 3 * d else (None,) * 4
        return (act[n].data_ptr(), act[k].data_ptr(), *ln, partial.data_ptr(), dwb.data_ptr(),
                vl.data_ptr(), m, n, k, S_PAD, splits, stream), (partial, dwb)

    wgrad_shapes = ((3 * d, d), (d, d), (f, d), (d, f))
    # K2b: dy (M, K) @ w (K, N), epilogue 1 (ReLU mask from aux) or 2 (aux + ...)
    dgrad_sites = ((d, f, 1), (f, d, 2), (d, d, 0), (3 * d, d, 0))
    dgrad_w = {(k, n): rn(k, n, scale=k ** -0.5) for k, n, _ in dgrad_sites}
    dgrad_out = {n: torch.empty(m, n, device=dev) for n in (d, f)}

    def dgrad_args(k, n, epi):
        return (act[k].data_ptr(), dgrad_w[k, n].data_ptr(), act[n].data_ptr() if epi else None,
                dgrad_out[n].data_ptr(), epi, vl.data_ptr(), m, k, n, S_PAD, stream)

    w1, b1 = rn(f, d, scale=d ** -0.5), rn(f, scale=0.1)
    hid = torch.empty(m, f, device=dev)
    k1c_args = (act[d].data_ptr(), w1.data_ptr(), b1.data_ptr(), hid.data_ptr(), vl.data_ptr(),
                m, d, f, S_PAD, stream)
    for name, lib in libs.items():
        assert lib.linear_relu_fwd(*k1c_args) == 0
        cells = [f"K1c {time_ms(lambda: lib.linear_relu_fwd(*k1c_args)):.4f}"]
        if name.startswith("k1c"):  # the K1c builds change K1c only
            print(f"{name}: " + ", ".join(cells) + " (ms)", flush=True)
            continue
        for site in lrn_sites:
            args = lrn_args(*site)
            assert lib.linear_residual_ln_fwd(*args) == 0
            cells.append(f"K1b K {site[0]} {time_ms(lambda: lib.linear_residual_ln_fwd(*args)):.4f}")
        for k, n, epi in dgrad_sites:
            if name.startswith("split") and (n != d or k == d or name == "split_ffn8" and k != f):
                continue  # the splits change the K 2048 and 576 sites; 576 / 8 is no K slice
            args = dgrad_args(k, n, epi)
            assert lib.linear_dgrad(*args) == 0
            cells.append(f"K2b K {k} -> N {n} {time_ms(lambda: lib.linear_dgrad(*args)):.4f}")
        if not name.startswith("split"):  # the splits change K1b and K2b only
            for n, k in wgrad_shapes:
                args, keep = wgrad_args(n, k, fused_block.wgrad_splits(bsz, S_PAD, n, k,
                                                                       torch.float32))
                assert lib.linear_wgrad(*args) == 0
                cells.append(f"K2c ({n}, {k}) {time_ms(lambda: lib.linear_wgrad(*args)):.4f}")
        print(f"{name}: " + ", ".join(cells) + " (ms)", flush=True)
    print("K1c and K2b bound (operations on the rows of computed tiles at "
          f"{PEAK_F32_FLOPS / 1e12:g} TFLOP/s): K1c {2 * rows * d * f / PEAK_F32_FLOPS * 1e3:.4f}, "
          + ", ".join(
              f"K {k} -> N {n} {2 * rows * k * n / PEAK_F32_FLOPS * 1e3:.4f}"
              for k, n, _ in dgrad_sites) + " (ms)", flush=True)

    # wgrad at other split counts than the plan, as built
    lib = libs["as built"]
    for n, k in wgrad_shapes:
        plan = fused_block.wgrad_splits(bsz, S_PAD, n, k, torch.float32)
        cells = []
        for splits in sorted({max(1, plan // 2), plan, min(2 * plan, 1024, m // 32)}):
            args, keep = wgrad_args(n, k, splits)
            assert lib.linear_wgrad(*args) == 0
            cells.append(f"{splits} splits {time_ms(lambda: lib.linear_wgrad(*args)):.4f}"
                         + (" (plan)" if splits == plan else ""))
        print(f"K2c ({n}, {k}) as built: " + ", ".join(cells) + " (ms)", flush=True)

    # one PyTorch call for the same function (all M rows: the library skips none)
    cells = [f"K1c {time_ms(lambda: torch.relu(torch.addmm(b1, act[d], w1.t()))):.4f}"]
    for k, w, bias, res, _ in lrn_sites:
        a = act[k]
        cells.append(f"K1b K {k} {time_ms(lambda: F.layer_norm(torch.addmm(bias, a, w.t()) + res, (d,), g, beta, 1e-5)):.4f}")
    for n, k in wgrad_shapes:
        cells.append(f"K2c ({n}, {k}) {time_ms(lambda: torch.mm(act[n].t(), act[k])):.4f}")
    for k, n, epi in dgrad_sites:
        wk = dgrad_w[k, n]
        fn = ((lambda: torch.addmm(act[n], act[k], wk)) if epi == 2 else
              (lambda: torch.mm(act[k], wk)))
        cells.append(f"K2b K {k} -> N {n} {time_ms(fn):.4f}")
    print("library: " + ", ".join(cells) + " (ms)", flush=True)

    cells = []
    for n, k in wgrad_shapes:
        mb = [fused_block.wgrad_splits(seqs, S_PAD, n, k, torch.float32) * (n * k + n) * 4 / 1e6
              for seqs in (8, 16, 64)]
        cells.append(f"({n}, {k}) " + " / ".join(f"{x:.2f}" for x in mb))
    print("K2c partial scratch at 8 / 16 / 64 sequences of 2048 rows (MB): " + ", ".join(cells),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
