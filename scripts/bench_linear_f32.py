#!/usr/bin/env python3
"""Times the float32 ``ln_linear_fwd`` (K1a), ``linear_relu_fwd`` (K1c),
``linear_residual_ln_fwd`` (K1b, both sites), ``linear_wgrad`` (K2c, all four
sites, both passes) and ``linear_dgrad`` (K2b, all four sites) of
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
  (``-DLR_STAGES``; as built 3);
- ``k1a_slabs3``, ``k1a_tn8``, ``k1a_tn9_bn288``: K1a's cut of
  qkv's 576 columns: as built a block owns one slab of 192 (4 warps of 32 rows
  x 48 columns, 8 x 6 sums a thread; grid M / 32 x 3); ``k1a_slabs3`` one
  block walks all three slabs (``-DLL_SLABS=3``: the x copy, the row stats
  and the normalisation once a row tile, a third of the blocks); ``k1a_tn8``
  3 warps of 8 x 8 sums (``-DLL_TN=8``, K1c's tile), ``k1a_tn9_bn288`` slabs
  of 288 columns, 4 warps of 8 x 9 (``-DLL_BN=288``);
  ``k1a_stages2``, ``k1a_stages4``: its ring of 2 or 4 slots (``-DLL_STAGES``;
  as built 3); ``k1a_no_stats``: no row stats (mean 0, rstd 1: the time the
  stats take).

A site near ``no_copy`` is held by its loop, one near ``no_fma`` by its
loads.

``d768`` times ChAdaViT-B/16's float32 K1a (``ln_linear_fwd_d768``: the LN1
row pass, then ``gemm128_kernel``), K1c (``linear_relu_fwd`` at K 768),
K1b at both sites
(``linear_residual_ln_fwd`` at N 768: ``gemm128_kernel``, then the LayerNorm
row pass), without saves, and K2c at its four sites (``linear_wgrad_d768``:
at QKV the LN1 row pass, then both passes of the stream-K walk over
``fused_block.WGRAD_F32_BLOCKS`` blocks; in a tree without that entry point
``linear_wgrad`` over its split plan, the D 192 tiles over a grid of output
tiles x splits) and K2b at its four sites (``linear_dgrad_d768``: the
tile list, the stream-K walk over the blocks the card holds, the sums of the
split tiles; in a tree without that entry point ``linear_dgrad``, a block a
32-row tile, column slice and K half), as built, in
``no_copy`` and in ``no_fma``, at two
sets of shapes: chip_smoke.py's narrow f32 shapes (phase 2c: 8 images of 1-3
channels, S_pad 640, 3 340 valid rows) and the rows of the f32 B/16 step on
chip_smoke.py's 3-channel bucket (phase 4e (b): 2 images of 3 and 2
channels x 2 crops, S_pad 640, 1 964 valid rows, where K1b's GEMM takes
its 64-column tile); the blocks each K2c and K2b site's grid holds and the
waves they make; one PyTorch call for the same function (``layer_norm``
and ``addmm``, on all rows; K1c ``relu`` of ``addmm``; K2c ``mm`` of dY^T
and X' and ``sum`` of dY, X' = ``layer_norm(x)`` at QKV; K2b ``mm`` with the
mask by ``where`` or the residual by ``addmm``) and the bound
(operations on the valid rows at 67 TFLOP/s). With ``--parent DIR`` (an
unpacked checkout of another commit, e.g. ``git archive`` of the parent into
a directory that ``.gitignore`` lists) it also builds that tree's
``fused_block.cu`` and ``fused_block_bwd.cu`` as built, ``no_copy`` and
``no_fma``, times its K1a, K1c, K1b, K2c and K2b in turns with this tree's
in one process (parent, change, change, parent), and says whether the two
trees' K1a (qkv, mean, rstd), K1c (hid) and K1b (out, mean, rstd, r)
outputs are the same bits
on seeded inputs, and how far apart their K2c and K2b outputs are (each K2c
and K2b twice for the same bits). Each build also prints
the registers and spills of the two kernels (``nvcc -Xptxas -v``). The
diagnostic builds compute nothing meaningful; only their times are
read. It also times each wgrad site at other split counts than the plan
(``ops/fused_block.py::wgrad_splits``), one PyTorch call for the same function
per site (``torch.mm``; ``addmm``, with ``layer_norm`` for K1a and K1b and
``relu`` for K1c), and prints the
wgrad partial scratch at 8, 16 and 64 sequences. Run from the root of the
repository:

    python3 scripts/bench_linear_f32.py [train|hub]
    python3 scripts/bench_linear_f32.py d768 [--parent DIR]

``train`` (the default): the float32 train batch, 8 images x 2 crops (the
first 8 channel counts of chip_smoke.py's bf16 train batch) padded to 2048
rows; ``hub``: chip_smoke.py's hub shapes (8 images, 2048 rows). Times are
CUDA events over 20 calls after 3 of warm-up, each call one launch of the C
entry point (wgrad: both passes), without the Python wrapper. Prints one
line per build, the bound of K1a, K1c and of each K2b site (its operations at
the f32 peak, and K1a's output bytes at 3.35 TB/s) and the card's name and
power limit.
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
          **{f"k1c_stages{n}": [f"-DLR_STAGES={n}"] for n in (2, 4)},
          "k1a_slabs3": ["-DLL_SLABS=3"], "k1a_tn8": ["-DLL_TN=8"],
          "k1a_tn9_bn288": ["-DLL_TN=9", "-DLL_BN=288"],
          **{f"k1a_stages{n}": [f"-DLL_STAGES={n}"] for n in (2, 4)},
          "k1a_no_stats": ["-DLL_NO_STATS"]}
PEAK_F32_FLOPS = 67e12  # f32 FMA outside the tensor cores, NVIDIA H100 SXM data sheet
PEAK_BYTES = 3.35e12    # HBM3, the same data sheet
KERNELS = ("ln_linear", "linear_relu", "linear_residual_ln", "linear_wgrad", "linear_dgrad",
           "gemm128", "ln_rows_f32", "res_ln_rows")
# d768: (S_pad, channel counts) of chip_smoke.py's NARROW_F32 and of the
# sequences of its B16_BUCKET_F32 step (2 images of 3 and 2 channels, 2
# crops each), and the builds of the D 768 instances
D768_SHAPES = {"narrow": (640, [3, 1, 2, 3, 1, 2, 3, 2]), "bucket": (640, [3, 2, 3, 2])}
D768_BUILDS = {"as built": [], "no_copy": ["-DSGEMM_NO_COPY"], "no_fma": ["-DSGEMM_NO_FMA"]}
FORWARD = ("ln_linear_fwd", "ln_linear_fwd_d768", "linear_relu_fwd", "linear_residual_ln_fwd")
BACKWARD = ("linear_wgrad", "linear_wgrad_d768", "linear_dgrad", "linear_dgrad_d768",
            "linear_dgrad_d768_blocks")
# K2c's four weight shapes (N, K) at D 768
WGRAD_D768 = {"qkv": (2304, 768), "out": (768, 768), "ffn1": (2048, 768), "ffn2": (768, 2048)}
# K2b's four sites at D 768: (K, N, epilogue: 1 the ReLU mask of hid, 2 the
# residual dr2, 0 none), dX (M, N) = dY (M, K) @ W (K, N)
DGRAD_D768 = {"mask": (768, 2048, 1), "ffn1": (2048, 768, 2), "out": (768, 768, 0),
              "qkv": (2304, 768, 0)}


def split_plan(bsz: int, s_pad: int, n: int, k: int) -> int:
    """The split count of a float32 D 768 K2c before its stream-K walk: D
    192's tiles (192 of the D-wide side, 64 of the other), splits that fill
    264 blocks once, at most 64 and at most the batch's 32-row tiles."""
    tn, tk = (768 // 4, 64) if k == 2048 else (64, 768 // 4)
    return max(1, min(264 // ((n // tn) * (k // tk)), 64, bsz * s_pad // 32))


def forward_only(name: str) -> bool:
    """The K1a and K1c builds change fused_block.cu alone."""
    return name.startswith(("k1a", "k1c"))


def build(out_dir: Path, names=None, builds=None, csrc=None, forward=False) -> dict:
    """One library of the two sources per build (the K1a and K1c builds, and
    every build with ``forward``: of fused_block.cu alone), all compiled at
    once; ``names`` picks builds of ``builds`` (BUILDS, all by default), from
    the sources in ``csrc`` (this tree's by default)."""
    from chadavit_tpu_torch.ops import _build

    builds = BUILDS if builds is None else builds
    csrc = _build.CSRC if csrc is None else Path(csrc)
    procs = {}
    for name, flags in builds.items():
        if names is not None and name not in names:
            continue
        d = out_dir / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
            (d / src).write_text((csrc / src).read_text())
        files = ("fused_block.cu",) if forward or forward_only(name) else (
            "fused_block.cu", "fused_block_bwd.cu")
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
        for fn in FORWARD + (() if forward or forward_only(name) else BACKWARD):
            if not hasattr(lib, fn):  # the D 768 entry points: not in an older tree
                continue
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_ms(fn, iters=20):
    """CUDA events over ``iters`` calls after 3 of warm-up."""
    import torch

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


def main_d768(parent) -> int:
    """The ``d768`` mode: ChAdaViT-B/16's float32 K1a, K1b and K2c (module doc)."""
    import torch
    import torch.nn.functional as F

    from chadavit_tpu_torch.ops import fused_block
    from chadavit_tpu_torch.ops._build import BUILD_DIR
    from chadavit_tpu_torch.ops.layernorm import layernorm_stats

    dev = torch.device("cuda")
    walk = hasattr(fused_block, "dgrad_stream_plan")  # this tree has K2b's stream-K walk
    libs = build(BUILD_DIR / "bench_linear_f32_d768", builds=D768_BUILDS)
    if parent is not None:
        libs.update({f"parent {n}": lib for n, lib in build(
            BUILD_DIR / "bench_linear_f32_d768_parent", builds=D768_BUILDS,
            csrc=Path(parent) / "chadavit_tpu_torch" / "csrc").items()})
    for shapes, (s_pad, channels) in D768_SHAPES.items():
        valid = [1 + 196 * c for c in channels]
        bsz, m, d, f = len(valid), len(valid) * s_pad, 768, 2048
        vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)

        def rn(*shape, scale=1.0):
            return torch.randn(*shape, device=dev, generator=gen) * scale

        x = rn(m, d) * 2 + 0.5
        g, beta = 1 + rn(d, scale=0.1), rn(d, scale=0.05)
        wqkv, bqkv = rn(3 * d, d, scale=d ** -0.5), rn(3 * d, scale=0.02)
        sites = [(k, rn(m, k), rn(d, k, scale=k ** -0.5), rn(d, scale=0.02), rn(m, d))
                 for k in (d, f)]  # K1b: (K, a, W, bias, residual)
        stream = torch.cuda.current_stream().cuda_stream
        h = torch.empty(m, d, device=dev)

        def k1a(lib, save=False):
            out = torch.empty(m, 3 * d, device=dev)
            st = torch.empty(2, m, device=dev) if save else None
            args = [x.data_ptr(), g.data_ptr(), beta.data_ptr(), 1e-5, wqkv.data_ptr(),
                    bqkv.data_ptr(), out.data_ptr(), None if st is None else st[0].data_ptr(),
                    None if st is None else st[1].data_ptr()]
            if hasattr(lib, "ln_linear_fwd_d768"):
                fn = lib.ln_linear_fwd_d768
                args.append(h.data_ptr())
            else:
                fn = lib.ln_linear_fwd
            args += [vl.data_ptr(), m, d, 3 * d, s_pad, stream]
            return (lambda: fn(*args)), (out,) + (() if st is None else (st[0], st[1]))

        x2, w1, b1f = rn(m, d), rn(f, d, scale=d ** -0.5), rn(f, scale=0.02)  # K1c

        def k1c(lib):
            out = torch.empty(m, f, device=dev)
            args = (x2.data_ptr(), w1.data_ptr(), b1f.data_ptr(), out.data_ptr(), vl.data_ptr(),
                    m, d, f, s_pad, stream)
            return (lambda: lib.linear_relu_fwd(*args)), (out,)

        def k1b(lib, site, save=False):
            k, a, w, bias, res = site
            out = torch.empty(m, d, device=dev)
            st = torch.empty(2, m, device=dev) if save else None
            r = torch.empty(m, d, device=dev) if save else None
            args = (a.data_ptr(), w.data_ptr(), bias.data_ptr(), res.data_ptr(), g.data_ptr(),
                    beta.data_ptr(), 1e-5, out.data_ptr(),
                    None if st is None else st[0].data_ptr(),
                    None if st is None else st[1].data_ptr(), None if r is None else r.data_ptr(),
                    vl.data_ptr(), m, k, d, s_pad, stream)
            return (lambda: lib.linear_residual_ln_fwd(*args)), (out,) + (
                () if st is None else (st[0], st[1], r))

        rows = sum(-(-n // 32) * 32 for n in valid)
        print(f"d768 {shapes}: {bsz} sequences of {s_pad} rows, {sum(valid)} valid, {rows} in "
              "computed 32-row tiles", flush=True)
        # K2c: dY (M, N) and X (M, K) of each weight shape; X' = LN1(x) at QKV
        mean, rstd = (t[..., 0].contiguous() for t in layernorm_stats(x, 1e-5))
        wg_in = {site: (rn(m, n), x if site == "qkv" else rn(m, k))
                 for site, (n, k) in WGRAD_D768.items()}
        n32 = rows // 32

        def k2c(lib, site):
            n, k = WGRAD_D768[site]
            dy, xs = wg_in[site]
            ln = ((mean.data_ptr(), rstd.data_ptr(), g.data_ptr(), beta.data_ptr())
                  if site == "qkv" else (None,) * 4)
            if hasattr(lib, "linear_wgrad_d768"):  # the stream-K walk, LN1 in a pre-pass
                fn, grid = lib.linear_wgrad_d768, fused_block.WGRAD_F32_BLOCKS
                tn, tk = fused_block.WGRAD_F32_STREAM_TILES[(n, k)]
                partial = torch.empty(fused_block.wgrad_stream_slots(n, k, torch.float32),
                                      tn * tk + tn, device=dev)
                ln += (h.data_ptr() if site == "qkv" else None,)
            else:  # the split plan
                fn, grid = lib.linear_wgrad, split_plan(bsz, s_pad, n, k)
                partial = torch.empty(grid, n * k + n, device=dev)
            dwb = torch.empty(n * k + n, device=dev)
            args = (dy.data_ptr(), xs.data_ptr(), *ln, partial.data_ptr(), dwb.data_ptr(),
                    vl.data_ptr(), m, n, k, s_pad, grid, stream)
            return (lambda: fn(*args)), (dwb, partial)

        # K2b: dY (M, K), W (K, N), the epilogue's hid or dr2 (M, N)
        dg_in = {site: (rn(m, k), rn(k, n, scale=k ** -0.5), rn(m, n) if epi else None)
                 for site, (k, n, epi) in DGRAD_D768.items()}
        tile_list = torch.empty(bsz + 1 + m // 32, dtype=torch.int32, device=dev)

        def k2b(lib, site):
            k, n, epi = DGRAD_D768[site]
            dy, w, aux = dg_in[site]
            out = torch.empty(m, n, device=dev)
            head = (dy.data_ptr(), w.data_ptr(), None if aux is None else aux.data_ptr(),
                    out.data_ptr(), epi)
            tail = (vl.data_ptr(), m, k, n, s_pad, stream)
            if hasattr(lib, "linear_dgrad_d768"):  # the stream-K walk
                slots = fused_block.dgrad_stream_slots(
                    m, n, lib.linear_dgrad_d768_blocks(k, n, epi))
                partial = torch.empty(slots, 32 * fused_block.DGRAD_F32_COLUMNS[n], device=dev)
                args = head + (partial.data_ptr(), slots, tile_list.data_ptr()) + tail
                return (lambda: lib.linear_dgrad_d768(*args)), (out, partial)
            args = head + tail
            return (lambda: lib.linear_dgrad(*args)), (out,)

        steps = {"K1a": lambda lib, save=False: k1a(lib, save),
                 "K1c": lambda lib, save=False: k1c(lib),
                 **{f"K1b K {s[0]}": (lambda lib, save=False, s=s: k1b(lib, s, save))
                    for s in sites},
                 **{f"K2c {site}": (lambda lib, save=False, site=site: k2c(lib, site))
                    for site in WGRAD_D768},
                 **{f"K2b {site}": (lambda lib, save=False, site=site: k2b(lib, site))
                    for site in DGRAD_D768}}
        cells = []
        for site, (n, k) in WGRAD_D768.items():
            tn, tk = (192, 64) if k == 2048 else (64, 192)
            blocks = (n // tn) * (k // tk) * split_plan(bsz, s_pad, n, k)
            cells.append(f"{site} split plan {blocks} blocks ({blocks / 264:.2f} of the 264 two "
                         "an SM)")
            if hasattr(fused_block, "WGRAD_F32_STREAM_TILES"):
                tn, tk = fused_block.WGRAD_F32_STREAM_TILES[(n, k)]
                units = (n // tn) * (k // tk) * n32
                cells[-1] += (f", stream-K {units} units of 32 rows over "
                              f"{fused_block.WGRAD_F32_BLOCKS} blocks "
                              f"({units / fused_block.WGRAD_F32_BLOCKS:.1f} a block)")
        print("K2c grids: " + "; ".join(cells), flush=True)
        cells = []
        lib = libs["as built"]
        for site, (k, n, epi) in DGRAD_D768.items():
            bn = 256 if n == 2048 else 192
            split = 2 if site in ("ffn1", "qkv") else 1
            old = m // 32 * split * (n // bn)  # a block a (32-row tile, K half, column slice)
            cells.append(f"{site} one block a tile {old} blocks ({old / 396:.2f} waves of the "
                         "396 three an SM)")
            if walk:
                blocks = lib.linear_dgrad_d768_blocks(k, n, epi)
                units = n32 * (n // bn) * (k // fused_block.DGRAD_F32_SLAB)
                cells[-1] += (f", stream-K {units} units over {blocks} blocks "
                              f"({units / blocks:.1f} a block)")
        print("K2b grids: " + "; ".join(cells), flush=True)

        def row(name, lib):
            cells, k2c_ms, k2b_ms = [], 0.0, 0.0
            for step, make in steps.items():
                fn, keep = make(lib)  # keep: the outputs the launches write
                assert fn() == 0, (name, step)
                t = time_ms(fn)
                k2c_ms += t if step.startswith("K2c") else 0.0
                k2b_ms += t if step.startswith("K2b") else 0.0
                cells.append(f"{step} {t:.4f}")
            print(f"{name}: " + ", ".join(cells) + f", K2c four sites {k2c_ms:.4f}, K2b four "
                  f"sites {k2b_ms:.4f} (ms)", flush=True)

        if parent is not None:  # as built, in turns
            for name in ("parent as built", "as built", "as built", "parent as built"):
                row(name, libs[name])
            for step, make in steps.items():  # the two trees' bits on the same inputs
                outs = []
                for name in ("parent as built", "as built"):
                    fn, o = make(libs[name], save=True)
                    assert fn() == 0
                    torch.cuda.synchronize()
                    if step.startswith(("K2c", "K2b")):  # a second call: the same bits
                        first = o[0].clone()
                        assert fn() == 0
                        torch.cuda.synchronize()
                        print(f"bits {step} {name}: the same on a second call "
                              f"{torch.equal(first, o[0])}", flush=True)
                    outs.append(o)
                if step.startswith("K2b"):  # another order of the sums where a tile is split
                    p, c = outs[0][0], outs[1][0]
                    computed = torch.cat([torch.arange(i * s_pad, i * s_pad + -(-n // 32) * 32,
                                                       device=dev)
                                          for i, n in enumerate(valid)])
                    pad = torch.ones(m, dtype=torch.bool, device=dev)
                    pad[computed] = False
                    print(f"{step}: this tree against the parent's max abs "
                          f"{(c - p).abs().max().item():.3e}, max |parent| "
                          f"{p.abs().max().item():.3e}; zeros past the computed tiles "
                          f"{not c[pad].any().item()}", flush=True)
                    continue
                if step.startswith("K2c"):  # another order of the rows: other bits
                    p, c = outs[0][0], outs[1][0]
                    print(f"{step}: this tree against the parent's max abs "
                          f"{(c - p).abs().max().item():.3e}, max |parent| "
                          f"{p.abs().max().item():.3e}", flush=True)
                    continue
                differ = [int((p != c).sum()) for p, c in zip(*outs)]
                print(f"bits {step} (with saves), parent against this tree: "
                      + ("the same" if not any(differ) else
                         f"DIFFER in {differ} of {[p.numel() for p in outs[0]]} entries"),
                      flush=True)
        for name, lib in libs.items():
            if name not in ("as built", "parent as built"):
                row(name, lib)
        if parent is None:
            row("as built", libs["as built"])
        lib = time_ms(lambda: torch.addmm(bqkv, F.layer_norm(x, (d,), g, beta), wqkv.t()))
        cells = [f"K1a {lib:.4f}"]
        lib = time_ms(lambda: torch.relu(torch.addmm(b1f, x2, w1.t())))
        cells.append(f"K1c {lib:.4f}")
        for _, a, w, bias, res in sites:
            lib = time_ms(lambda: F.layer_norm(torch.addmm(bias, a, w.t()) + res, (d,), g, beta))
            cells.append(f"K1b K {a.shape[1]} {lib:.4f}")
        total = 0.0
        for site, (dy, xs) in wg_in.items():
            xl = F.layer_norm(xs, (d,), g, beta) if site == "qkv" else xs
            lib = time_ms(lambda: (torch.mm(dy.t(), F.layer_norm(xs, (d,), g, beta)), dy.sum(0))
                          if site == "qkv" else (torch.mm(dy.t(), xl), dy.sum(0)))
            total += lib
            cells.append(f"K2c {site} {lib:.4f}")
        cells.append(f"K2c four sites {total:.4f}")
        total = 0.0
        for site, (dy, w, aux) in dg_in.items():
            epi = DGRAD_D768[site][2]
            fn = ((lambda: torch.where(aux > 0, torch.mm(dy, w), 0.0)) if epi == 1 else
                  (lambda: torch.addmm(aux, dy, w)) if epi == 2 else (lambda: torch.mm(dy, w)))
            lib = time_ms(fn)
            total += lib
            cells.append(f"K2b {site} {lib:.4f}")
        cells.append(f"K2b four sites {total:.4f}")
        print("library: " + ", ".join(cells) + " (ms; all rows)", flush=True)
        ops = {"K1a": 2 * sum(valid) * d * 3 * d, "K1c": 2 * sum(valid) * d * f,
               "K1b K 768": 2 * sum(valid) * d * d,
               "K1b K 2048": 2 * sum(valid) * d * f,
               **{f"K2c {site}": 2 * sum(valid) * n * k + sum(valid) * n
                  for site, (n, k) in WGRAD_D768.items()}}
        ops["K2c four sites"] = sum(v for k_, v in ops.items() if k_.startswith("K2c"))
        ops.update({f"K2b {site}": 2 * sum(valid) * k * n
                    for site, (k, n, _) in DGRAD_D768.items()})
        ops["K2b four sites"] = sum(v for k_, v in ops.items()
                                    if k_.startswith("K2b") and k_ != "K2b four sites")
        print("bound (operations on the valid rows at 67 TFLOP/s): " + ", ".join(
            f"{k} {v / PEAK_F32_FLOPS * 1e3:.4f}" for k, v in ops.items()) + " (ms)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


def main() -> int:
    import torch
    import torch.nn.functional as F

    from chadavit_tpu_torch.ops import fused_block
    from chadavit_tpu_torch.ops._build import BUILD_DIR

    if not torch.cuda.is_available():
        print("bench_linear_f32: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = args[i + 1]
        del args[i:i + 2]
    which = args[0] if args else "train"
    if which == "d768":
        return main_d768(parent)
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
    wqkv, bqkv = rn(3 * d, d, scale=d ** -0.5), rn(3 * d, scale=0.02)
    qkv = torch.empty(m, 3 * d, device=dev)
    stats_out = torch.empty(2, m, device=dev)  # K1a's saved mean and rstd (the train path)
    k1a_args = (act[d].data_ptr(), g.data_ptr(), beta.data_ptr(), 1e-5, wqkv.data_ptr(),
                bqkv.data_ptr(), qkv.data_ptr(), stats_out[0].data_ptr(),
                stats_out[1].data_ptr(), vl.data_ptr(), m, d, 3 * d, S_PAD, stream)
    for name, lib in libs.items():
        assert lib.ln_linear_fwd(*k1a_args) == 0
        assert lib.linear_relu_fwd(*k1c_args) == 0
        cells = [f"K1a {time_ms(lambda: lib.ln_linear_fwd(*k1a_args)):.4f}",
                 f"K1c {time_ms(lambda: lib.linear_relu_fwd(*k1c_args)):.4f}"]
        if forward_only(name):  # the K1a and K1c builds change K1a or K1c only
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
    # K1a's bound: its operations on the rows < valid_len, and its bytes (x on
    # those rows, Wqkv, qkv written whole, the saved stats), the larger
    k1a_ops = 2 * sum(valid) * d * 3 * d / PEAK_F32_FLOPS * 1e3
    k1a_bytes = 4 * (sum(valid) * d + 3 * d * d + 3 * d + m * 3 * d + 2 * m) / PEAK_BYTES * 1e3
    print(f"K1a bound: operations {k1a_ops:.4f} ms, bytes {k1a_bytes:.4f} ms (the rows < "
          "valid_len)", flush=True)
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
    cells = [f"K1a {time_ms(lambda: torch.addmm(bqkv, F.layer_norm(act[d], (d,), g, beta, 1e-5), wqkv.t())):.4f}",
             f"K1c {time_ms(lambda: torch.relu(torch.addmm(b1, act[d], w1.t()))):.4f}"]
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
