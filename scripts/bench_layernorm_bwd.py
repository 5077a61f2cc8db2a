#!/usr/bin/env python3
"""Times ``layernorm_bwd`` (K2a, ``chadavit_tpu_torch/csrc/fused_block_bwd.cu``)
and the standalone ``ln_bwd`` (K6, ``chadavit_tpu_torch/csrc/layernorm.cu``)
pass by pass on one NVIDIA GPU, in float32 and bfloat16. Run from the root of
the repository:

    python3 scripts/bench_layernorm_bwd.py [train|hub|k6]

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

Times are the profiler's device time per call over 20 calls after 3 of
warm-up, kernel by kernel. Prints one line per case, and the card's name and
power limit.
"""

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
    which = sys.argv[1] if len(sys.argv) > 1 else "train"
    if which != "k6":
        bench_layernorm_bwd(which)
    bench_ln_bwd()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


def device_ms(fn, keys, iters=20, between=None):
    """Device time per call of the kernels whose names hold one of ``keys``,
    by the profiler, over ``iters`` calls after 3 of warm-up; ``between`` runs
    before each call, and its kernels are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    return {k: sum(e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and k in e.key)
            for k in keys}


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
                print(f"{name}{tag}: cold L2 {sum(cold.values()):.4f} ms (first pass "
                      f"{cold[keys[0]]:.4f}, second {cold[keys[1]]:.4f}), bound {bound:.4f} ms "
                      f"({100 * bound / sum(cold.values()):.1f} %)", flush=True)
            if split_rows:
                ln.LN_BWD_SPLIT_ROWS, ln.LN_BWD_MAX_SPLITS = split_rows, most
            print(f"{name}: warm L2 as chip_smoke.py times it {sum(warm.values()):.4f} ms "
                  f"(first pass {warm[keys[0]]:.4f}, second {warm[keys[1]]:.4f}), bound "
                  f"{bound:.4f} ms (all rows, bytes)", flush=True)


def bench_layernorm_bwd(which: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

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

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            iters = 20
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    call()
                torch.cuda.synchronize()
            passes = {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and any(k in e.key for k in ("layernorm_bwd", "reduce_ln_splits"))}
            first = sum(v for k, v in passes.items() if "layernorm_bwd" in k)
            second = sum(v for k, v in passes.items() if "reduce_ln_splits" in k)
            print(f"{str(dt).split('.')[-1]} splits {fused_block.layernorm_bwd_splits(bsz, S_PAD)}"
                  f": first pass {first:.4f} ms, second pass {second:.4f} ms, both "
                  f"{first + second:.4f} ms, bound {bound:.4f} ms "
                  f"({100 * bound / (first + second):.1f} %)", flush=True)


if __name__ == "__main__":
    sys.exit(main())
