#!/usr/bin/env python3
"""Times ChAdaViT-B/16's DINO step where its layers take the layer chain's
D 768 instances, as chip_smoke.py's phase 5 profiles it, on one NVIDIA GPU:
the bfloat16 step on 16 raw uint8 images of 7 channels (the root bench's B/16
spec, the multicrop inside the step) and the float32 step on 4e (b)'s
3-channel bucket (2 images of 3 and 2 channels x 2 crops). Each: a step that
warms the allocator, then 3 steps under the profiler (device busy: the sum of
the kernels' device times a step, the multicrop's range left out) and the
host clock around them (wall a step, after a synchronize), and the device
time a step of the chain's K1b, K2c and K2b kernels, of K1c, of K2a (both
passes) and of the attention (K3 and K4, K3's forward alone and K4's three
launches alone). Run from the root of the repository:

    python3 scripts/bench_b16_step.py [--parent DIR]

With ``--parent DIR`` (an unpacked checkout of another commit, e.g. ``git
archive`` of the parent into a directory that ``.gitignore`` lists) it runs
the two trees in turns, parent, change, change, parent, each in a process of
its own that builds its tree's kernels. Prints one JSON line per process and
a table of the turns; the card's name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEPS = 3
# the pieces of the kernel names of K1b (both dtypes, both sites; the bf16
# wgmma GEMM's epilogue 5) and of K2c (both passes, the f32 QKV site's LN1)
K1B_KEYS = ("linear_residual_ln", "res_ln_rows", "gemm128_kernel<768", ", 5>(")
K2C_KEYS = ("linear_wgrad", "reduce_wgrad", "reduce_stream", "ln_rows_saved")
# and of K2b (the f32 walk with its second pass and tile list; the bf16
# wgmma GEMM at its four sites)
K2B_KEYS = ("linear_dgrad", "reduce_dgrad", "dgrad_list", "linear_wgmma_kernel<2048, 768, 256, 1>",
            "linear_wgmma_kernel<768, 2048, 192, 2>", "linear_wgmma_kernel<768, 768, 192, 0>",
            "linear_wgmma_kernel<768, 2304, 192, 0>")
# K1c (the f32 GEMM's ReLU epilogue or the old kernel; the bf16 wgmma GEMM's
# epilogue 4), the attention's kernels (both dtypes) and K4's alone
K1C_KEYS = ("linear_relu", "gemm128_kernel<2048", "linear_wgmma_kernel<2048, 768, 256, 4>")
ATTN_KEYS = ("attention_fwd", "prefix_attention_kernel", "attention_bwd", "attention_dkdv",
             "attention_dq")
K4_KEYS = ("attention_bwd", "attention_dkdv", "attention_dq")
# K3 alone (the bf16 mma.sync forward, the head-64 wgmma forward, the f32
# forward) and K2a (its row pass and the splits' second pass)
K3_KEYS = ("attention_fwd", "prefix_attention_kernel")
K2A_KEYS = ("layernorm_bwd", "reduce_ln_splits")
KEYS = ("device_busy_ms", "wall_ms", "k1b_ms", "k1c_ms", "k2c_ms", "k2b_ms", "k2a_ms", "attn_ms",
        "k3_ms", "k4_ms")


def worker(root: Path) -> dict:
    """This process's tree: device busy, wall and the kernels' device time
    a step of the two B/16 steps."""
    sys.path.insert(0, str(root))
    import dataclasses
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chadavit_tpu_torch import bench
    from chadavit_tpu_torch.data import device_augment as da
    from chadavit_tpu_torch.train.pretrain import build_dino, synthetic_dino_batch

    assert Path(bench.__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def measure(step):
        step(0)  # a step that warms the allocator
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for i in range(STEPS):
                step(1 + i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) / STEPS
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.key != bench.AUG_RANGE]

        def ms(keys=None):
            return sum(e.self_device_time_total for e in events
                       if keys is None or any(k in e.key for k in keys)) / 1e3 / STEPS

        return {"device_busy_ms": ms(), "wall_ms": wall * 1e3, "k1b_ms": ms(K1B_KEYS),
                "k1c_ms": ms(K1C_KEYS), "k2c_ms": ms(K2C_KEYS), "k2b_ms": ms(K2B_KEYS),
                "k2a_ms": ms(K2A_KEYS), "attn_ms": ms(ATTN_KEYS), "k3_ms": ms(K3_KEYS),
                "k4_ms": ms(K4_KEYS)}

    out = {"tree": str(root)}
    state, fused, _, _ = build_dino(bench.b16_spec(), device_augmentations=bench.ASYMMETRIC_AUGS)
    rng = np.random.default_rng(9)
    raw7 = torch.from_numpy(rng.integers(0, 255, (16, 7, 224, 224), dtype=np.uint8)).to(dev)
    cc7 = torch.full((16,), 7, dtype=torch.int32, device=dev)
    box = [state]

    def bf16_step(i):
        box[0], m = fused(box[0], {"images": raw7, "channel_counts": cc7,
                                   "generator": da.aug_generator(2, i, dev)})
        float(m["dino_loss"])

    out["bf16_7ch"] = measure(bf16_step)
    del state, fused, box
    torch.cuda.empty_cache()
    spec3 = dataclasses.replace(bench.b16_spec(torch.float32), max_channels=3)
    st3, step3, _, _ = build_dino(spec3)
    batch3 = synthetic_dino_batch(spec3, 2, seed=6, channel_counts=[3, 2])
    box = [st3]

    def f32_step(i):
        box[0], m = step3(box[0], dict(batch3))
        float(m["dino_loss"])

    out["f32_3ch"] = measure(f32_step)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--worker", type=Path)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    trees = [ROOT] if args.parent is None else [args.parent, ROOT, ROOT, args.parent]
    labels = ["c1"] if args.parent is None else ["p1", "c1", "c2", "p2"]
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(tree)],
                              capture_output=True, text=True, env=dict(os.environ))
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for step in ("bf16_7ch", "f32_3ch"):
        for key in KEYS:
            print(f"{step} {key}: " + ", ".join(f"{lab} {r[step][key]:.2f}"
                                                for lab, r in zip(labels, runs)), flush=True)
        print(f"{step} attention share of device time: " + ", ".join(
            f"{lab} {100 * r[step]['attn_ms'] / r[step]['device_busy_ms']:.1f} %"
            for lab, r in zip(labels, runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
