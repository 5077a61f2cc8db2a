#!/usr/bin/env python3
"""Times ``layernorm_bwd`` (K2a, ``chadavit_tpu_torch/csrc/fused_block_bwd.cu``)
and the standalone ``ln_bwd`` (K6, ``chadavit_tpu_torch/csrc/layernorm.cu``)
pass by pass on one NVIDIA GPU, in float32 and bfloat16. Run from the root of
the repository:

    python3 scripts/bench_layernorm_bwd.py [train|hub|k6]
    python3 scripts/bench_layernorm_bwd.py d768 [--parent DIR]

K2a, for several counts of row splits (``ops/fused_block.py::LN_BWD_SPLITS``,
the most splits its plan takes): the first pass (dx and one dgamma/dbeta
partial per split) and the second (the splits' partials added in split
order). ``train`` (the default): 64 sequences (32 images x 2 crops of the
channel counts of chip_smoke.py's bf16 train batch) padded to 2048 rows, 4096
32-row tiles; ``hub``: chip_smoke.py's hub shapes (8 images, 2048 rows). Each
call is the wrapper at the LN2 site (no residual, dgb overwritten). The bound
is the larger of the operations over the card's f32 rate and the bytes over
3.35 TB/s (dy, x on the rows < valid_len read once, dx written whole, the
stats and the parameters), as chip_smoke.py counts them.

K6 (after K2a, or alone with ``k6``), LN(x) at D 192, at the hub's 16 384 rows
and at the 65 536 of chip_smoke.py's float32 ``block_impl=xla`` entry check
(16 images x 2 global crops, padded to 2048 rows: every batch of that run
holds a 10-channel image): its two kernels warm, called back to back as
chip_smoke.py's phase 5 calls it (after ``ln_fwd`` on the same rows, all
inside the 50 MB L2), and cold (a 128 MB buffer written between calls), at
the plan as built and, where the tree has one (``ops/layernorm.py::
LN_BWD_SPLIT_ROWS``), at other rows a split. Its bound counts every row: the
function takes no valid_len, so it reads x and dy and writes dx whole.

``d768``: K2a at D 768 (ChAdaViT-B/16's fused route), bfloat16 and float32,
at chip_smoke.py's phase 2c narrow bf16 rows (8 images, S_pad 1408, channels
1, 3, 5, 7, 2, 7, 4, 6) and at the 7-channel bucket of
``scripts/bench_b16_step.py`` (32 sequences of 1 373 valid rows padded to
1 408), at the LN2 site (no residual) and at the site-1 LN1 (with the
residual), through the C entry point of a library of
``csrc/fused_block_bwd.cu`` built for the run, at the split count
``layernorm_bwd_splits`` gives. With ``--parent DIR`` (an unpacked checkout
of another commit, e.g. ``git archive`` of the parent into a directory that
``.gitignore`` lists) it also builds that tree's library, times the two in
turns (parent, change, change, parent) and prints whether their dx and
dgamma/dbeta are the same bits, and how far each lies from the plain
version (``fused_block.layernorm_bwd_reference``). Times: CUDA events over
20 calls and the profiler's device time of both passes.

Times are the profiler's device time per call over 20 calls after 3 of
warm-up, kernel by kernel; a trace that holds none of the timed kernels is
taken again, twice at most, and the case then prints "not read". Prints one
line per case, and the card's name and power limit.
"""

import argparse
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
SPLITS = (256, 512, 1024, 2048, 4096)
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_layernorm_bwd: needs a CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="train", choices=("train", "hub", "k6", "d768"))
    ap.add_argument("--parent", type=Path)
    args = ap.parse_args()
    if args.which == "d768":
        bench_d768(args.parent)
    else:
        if args.which != "k6":
            bench_layernorm_bwd(args.which)
        bench_ln_bwd()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


def device_ms(fn, keys, iters=20, between=None, attempts=3):
    """Device time per call of the kernels whose names hold one of ``keys``,
    by the profiler, over ``iters`` calls after 3 of warm-up; ``between`` runs
    before each call, and its kernels are not counted. A trace without any of
    those kernels is taken again; None where each of ``attempts`` was."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        got = {k: sum(e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and k in e.key)
               for k in keys}
        if sum(got.values()) > 0:
            return got
    return None


def passes(ms, bound) -> str:
    """The two passes' device time (``device_ms``'s dict over the first pass's
    key, then the second's) and the share of the bound, or "not read"."""
    if ms is None:
        return "not read (the profiler's traces held no launch)"
    first, second = ms.values()
    return (f"{first + second:.4f} ms (first pass {first:.4f}, second {second:.4f}), bound "
            f"{bound:.4f} ms ({100 * bound / (first + second):.1f} %)")


def bench_ln_bwd() -> None:
    import torch

    from chadavit_tpu_torch.ops import layernorm as ln

    dev, d = torch.device("cuda"), 192
    flush = torch.empty(32 * 2 ** 20, device=dev)  # 128 MB, beyond the 50 MB L2
    split_rows = getattr(ln, "LN_BWD_SPLIT_ROWS", None)
    keys = ("ln_bwd_kernel", "ln_reduce_kernel")
    for m, what in ((16384, "hub"), (65536, "block_impl=xla entry check")):
        gen = torch.Generator(device=dev).manual_seed(1)
        x32 = torch.randn(m // 2048, 2048, d, device=dev, generator=gen) * 2 + 0.5
        dy32 = torch.randn(m // 2048, 2048, d, device=dev, generator=gen)
        g = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
        b = 0.05 * torch.randn(d, device=dev, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dt), dy32.to(dt)
            es = x.element_size()
            _, mean, rstd = ln.ln_fwd(x, None, g, b, 1e-6)
            bound = max(12 * m * d / PEAK_F32_FLOPS,
                        (es * (3 * m * d + d) + 4 * (2 * m + 2 * d)) / PEAK_BYTES) * 1e3

            def call():
                return ln.ln_bwd(x, None, g, mean, rstd, dy)

            def as_chip_smoke():  # phase 5's profiler loop: ln_fwd, then ln_bwd
                ln.ln_fwd(x, None, g, b, 1e-6)
                return call()

            name = f"K6 {str(dt).split('.')[-1]} {what} ({m} rows)"
            warm = device_ms(as_chip_smoke, keys)
            most = getattr(ln, "LN_BWD_MAX_SPLITS", None)
            plans = ([(split_rows, most)] + [(16, 1024), (32, 512), (128, 128), (256, 64),
                                             (64, 1024)]) if split_rows else [(None, None)]
            for rows, cap in plans:
                if rows is not None:
                    ln.LN_BWD_SPLIT_ROWS, ln.LN_BWD_MAX_SPLITS = rows, cap
                cold = device_ms(call, keys, between=flush.zero_)
                splits = ln.ln_bwd_splits(m) if rows is not None else None
                tag = "" if rows is None else (
                    f", {splits} splits of {-(-m // splits)} rows (at most {rows} rows and "
                    f"{cap} splits" + (", as built)" if (rows, cap) == (split_rows, most)
                                       else ")"))
                print(f"{name}{tag}: cold L2 {passes(cold, bound)}", flush=True)
            if split_rows:
                ln.LN_BWD_SPLIT_ROWS, ln.LN_BWD_MAX_SPLITS = split_rows, most
            print(f"{name}: warm L2 as chip_smoke.py times it {passes(warm, bound)} (all "
                  f"rows, bytes)", flush=True)


def bench_layernorm_bwd(which: str) -> None:
    import torch

    from chadavit_tpu_torch.ops import fused_block
    from chadavit_tpu_torch.ops.layernorm import layernorm_stats

    channels = TRAIN_CHANNELS * 2 if which == "train" else HUB_CHANNELS
    valid = [1 + 196 * c for c in channels]
    dev = torch.device("cuda")
    bsz, d = len(valid), fused_block.D_MODEL
    rows, m = sum(valid), len(valid) * S_PAD
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x32 = torch.randn(bsz, S_PAD, d, device=dev, generator=gen) * 2 + 0.5
    dy32 = torch.randn(bsz, S_PAD, d, device=dev, generator=gen)
    g = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
    print(f"{which}: {bsz} sequences of {S_PAD} rows, {rows} valid, "
          f"{m // fused_block.ROW_BLOCK} tiles of 32 rows", flush=True)
    for dt in (torch.float32, torch.bfloat16):
        x, dy = x32.to(dt), dy32.to(dt)
        mean, rstd = (t[..., 0] for t in layernorm_stats(x, 1e-5))
        es = x.element_size()
        bound = max(10 * rows * d / PEAK_F32_FLOPS,
                    (es * (2 * rows * d + m * d) + 4 * (2 * rows + 3 * d)) / PEAK_BYTES) * 1e3
        for splits in SPLITS:
            fused_block.LN_BWD_SPLITS = splits

            def call():
                return fused_block.layernorm_bwd(dy, x, mean, rstd, g, vl)

            ms = device_ms(call, ("layernorm_bwd", "reduce_ln_splits"))
            print(f"{str(dt).split('.')[-1]} splits {fused_block.layernorm_bwd_splits(bsz, S_PAD)}"
                  f": {passes(ms, bound)}", flush=True)


# d768: (S_pad, channel counts) of phase 2c's narrow bf16 rows and of the
# 7-channel bucket
D768_SHAPES = {"narrow": (1408, [1, 3, 5, 7, 2, 7, 4, 6]), "bucket7": (1408, [7] * 32)}


def build_bwd(out_dir: Path, csrc: Path) -> ctypes.CDLL:
    """A library of ``csrc/fused_block_bwd.cu`` (with its headers) from the
    sources in ``csrc``."""
    from chadavit_tpu_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "lib.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                           str(csrc / "fused_block_bwd.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {csrc}\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("layernorm_bwd", "layernorm_bwd_bf16"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def bench_d768(parent) -> None:
    import torch

    from chadavit_tpu_torch.ops import fused_block
    from chadavit_tpu_torch.ops._build import BUILD_DIR, CSRC
    from chadavit_tpu_torch.ops.layernorm import layernorm_stats

    libs = {"change": build_bwd(BUILD_DIR / "bench_layernorm_bwd_d768", CSRC)}
    if parent is not None:
        libs["parent"] = build_bwd(BUILD_DIR / "bench_layernorm_bwd_d768_parent",
                                   Path(parent) / "chadavit_tpu_torch" / "csrc")
    order = ["parent", "change", "change", "parent"] if parent is not None else ["change"]
    dev, d = torch.device("cuda"), fused_block.D_WIDE
    keys = ("layernorm_bwd", "reduce_ln_splits")
    for label, (s_pad, channels) in D768_SHAPES.items():
        valid = [1 + 196 * c for c in channels]
        bsz, rows = len(valid), sum(valid)
        m = bsz * s_pad
        vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        x32 = torch.randn(bsz, s_pad, d, device=dev, generator=gen) * 2 + 0.5
        dy32 = torch.randn(bsz, s_pad, d, device=dev, generator=gen)
        res32 = torch.randn(bsz, s_pad, d, device=dev, generator=gen)
        g = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
        splits = fused_block.layernorm_bwd_splits(bsz, s_pad, d)
        partial = torch.empty(splits, 2 * d, device=dev)
        print(f"d768 {label}: {bsz} sequences of {s_pad} rows, {rows} valid, {splits} splits",
              flush=True)
        for dt in (torch.bfloat16, torch.float32):
            x, dy, res = (t.to(dt) for t in (x32, dy32, res32))
            mean, rstd = (t[..., 0].contiguous() for t in layernorm_stats(x, 1e-5))
            es = x.element_size()
            fn_name = "layernorm_bwd_bf16" if dt == torch.bfloat16 else "layernorm_bwd"
            stream = torch.cuda.current_stream().cuda_stream
            for site, r in (("LN2 site", None), ("site-1 LN1, residual", res)):
                bound = max(10 * rows * d / PEAK_F32_FLOPS,
                            (es * ((2 + (r is not None)) * rows * d + m * d)
                             + 4 * (2 * rows + 3 * d)) / PEAK_BYTES) * 1e3
                outs = {}
                for name, lib in libs.items():
                    dx = torch.empty_like(dy)
                    dgb = torch.empty(2 * d, device=dev)
                    call_args = (dy.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                 g.data_ptr(), None if r is None else r.data_ptr(), dx.data_ptr(),
                                 partial.data_ptr(), dgb.data_ptr(), 0, vl.data_ptr(), m, d,
                                 s_pad, splits, stream)

                    def call(lib=lib, call_args=call_args):
                        assert getattr(lib, fn_name)(*call_args) == 0

                    outs[name] = (call, dx, dgb)
                for name in order:
                    call, dx, dgb = outs[name]
                    ev = time_events(call)
                    print(f"  {str(dt).split('.')[-1]} {site} {name}: events {ev:.4f} ms, device "
                          f"{passes(device_ms(call, keys), bound)} (bytes)", flush=True)
                ref_dx, ref_dgb = fused_block.layernorm_bwd_reference(dy, x, mean, rstd, g, vl, r)
                cells = []
                for name, (call, dx, dgb) in outs.items():
                    call()
                    torch.cuda.synchronize()
                    err = (dx.float() - ref_dx.float()).abs().max().item()
                    gerr = (dgb - ref_dgb).abs().max().item()
                    cells.append(f"{name} dx {err:.3e}, dgb {gerr:.3e}")
                print(f"  {str(dt).split('.')[-1]} {site} against the plain version: "
                      + ", ".join(cells), flush=True)
                if parent is not None:
                    (_, dxa, dga), (_, dxb, dgb_) = outs["change"], outs["parent"]
                    print(f"  {str(dt).split('.')[-1]} {site}: dgamma/dbeta the same bits in "
                          f"both trees {torch.equal(dga, dgb_)}, dx {torch.equal(dxa, dxb)} "
                          f"(dx max apart {(dxa.float() - dxb.float()).abs().max().item():.3e})",
                          flush=True)
        del x32, dy32, res32
        torch.cuda.empty_cache()


def time_events(fn, iters=20):
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


if __name__ == "__main__":
    sys.exit(main())
