#!/usr/bin/env python3
"""Whether torch.profiler's device times hold on one NVIDIA GPU: the bf16 K1a
and K2c QKV site of ChAdaViT-B/16 (D 768) at chip_smoke.py's narrow hub shapes
(8 images of 1-7 channels, S_pad 1408), each traced in several ways and held
against CUDA events queued behind a 0.1 s spin of the card (the device's
time). Run from the root of the repository:

    python3 scripts/profiler_counts.py

Each trace runs 20 rounds of the call; for every kernel it prints the launches
per round the trace holds (a whole number when no record is lost) and the
device time per round. The ways: ``cuda`` (activities CUDA only, as
chip_smoke.py's device_ms had it), ``cuda+cpu`` (CPU and CUDA), ``warm-up``
(CUDA, a schedule whose first step, one round, is dropped), each three times,
after 40 traces taken first (phase 5 of chip_smoke.py takes many in one
process). Prints the card's name and power limit first.

``long``: many traces in one process (``--traces``, 300 by default) of two
calls whose whole traces read about half their time in one smoke run: the
bf16 head-64 K3 at the hub shapes (8 images of 2048 rows, 12 heads of 64,
q, k, v slices of one packed qkv) and the f32 D 192 ``linear_dgrad`` at its
(192, 192) site. For each trace it reads, against CUDA events after a head
start: the launches per round, the records that repeat another's start on
the card, the span of the launches over CUDA events recorded around the same
rounds inside the trace, and the profiler's time; it counts the traces that
are whole, that lost launches, that hold repeated records and that read
under two thirds of the head start, and prints those last ones::

    python3 scripts/profiler_counts.py long [--traces N]
"""

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REPS = 20


def head_start(fn, reps=REPS):
    """CUDA events around ``reps`` calls queued behind a 0.1 s spin of the
    card, per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def long_run(traces: int) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chadavit_tpu_torch.ops import fused_block
    from chadavit_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    valid = [1 + 196 * c for c in (1, 3, 5, 10, 2, 7, 9, 10)]
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    qkv = randn(len(valid), 2048, 3 * 768).bfloat16()
    q, k, v = (qkv[..., i * 768:(i + 1) * 768] for i in range(3))
    dy, w = randn(len(valid), 2048, 192), randn(192, 192, scale=192 ** -0.5)
    calls = {"K3 bf16 hd64": lambda: fa.prefix_flash_attention(q, k, v, vl, 12),
             "K2b f32 (192, 192)": lambda: fused_block.linear_dgrad(dy, w, vl)}
    with torch.no_grad():
        hs = {n: statistics.median(head_start(fn) for _ in range(3)) for n, fn in calls.items()}
        for n, t in hs.items():
            print(f"{n}: CUDA events after a head start {t:.4f} ms a call", flush=True)
        tally = {n: {"traces": 0, "whole": 0, "lost": 0, "repeated": 0, "under 2/3": 0}
                 for n in calls}
        shown = 0
        for i in range(traces):
            name = list(calls)[i % len(calls)]
            fn = calls[name]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                start.record()
                for _ in range(REPS):
                    fn()
                end.record()
                torch.cuda.synchronize()
            recs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            avg = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            t = tally[name]
            t["traces"] += 1
            if not recs:
                continue
            whole = all(e.count % REPS == 0 for e in avg)
            starts = [(e.name, e.time_range.start) for e in recs]
            repeated = len(starts) - len(set(starts))
            prof_ms = sum(e.self_device_time_total for e in avg) / 1e3 / REPS
            under = prof_ms < 2 / 3 * hs[name]
            t["whole" if whole else "lost"] += 1
            t["repeated"] += repeated > 0
            t["under 2/3"] += under
            if under and shown < 12:
                shown += 1
                span = (max(e.time_range.end for e in recs)
                        - min(e.time_range.start for e in recs)) / 1e3
                durs = sorted(e.time_range.elapsed_us() / 1e3 for e in recs)
                print(f"  trace {i} ({name}): {prof_ms:.4f} ms a round against {hs[name]:.4f}; "
                      f"{len(recs)} records, {repeated} repeating another's start, launches a "
                      f"round {[round(e.count / REPS, 3) for e in avg]}; span "
                      f"{span:.3f} ms over the trace's events "
                      f"{start.elapsed_time(end):.3f} ms; each record min {durs[0]:.4f}, median "
                      f"{durs[len(durs) // 2]:.4f}, max {durs[-1]:.4f} ms", flush=True)
    for n, t in tally.items():
        print(f"{n}: " + ", ".join(f"{k} {v}" for k, v in t.items()), flush=True)
    return 0


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from chadavit_tpu_torch.ops import fused_block

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="ways", choices=("ways", "long"))
    ap.add_argument("--traces", type=int, default=300)
    args = ap.parse_args()
    if args.which == "long":
        return long_run(args.traces)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    d, s_pad = 768, 1408
    valid = [1 + 196 * c for c in (1, 3, 5, 7, 2, 7, 4, 6)]
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    x = randn(len(valid), s_pad, d).bfloat16()
    g, b = 1 + randn(d, scale=0.1), randn(d, scale=0.05)
    w, bias = randn(3 * d, d, scale=d ** -0.5).bfloat16(), randn(3 * d, scale=0.02).bfloat16()
    dy = randn(len(valid), s_pad, 3 * d).bfloat16()
    mean, rstd = (t[..., 0] for t in fused_block.layernorm_stats(x, 1e-5))
    calls = {"K1a d768": lambda: fused_block.ln_linear(x, g, b, 1e-5, w, bias, vl),
             "K2c QKV d768": lambda: fused_block.linear_wgrad(dy, x, vl, ln=(mean, rstd, g, b))}

    def trace(fn, way):
        kw = {"activities": [ProfilerActivity.CUDA]}
        if way == "cuda+cpu":
            kw["activities"] = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        if way == "warm-up":
            kw["schedule"] = schedule(wait=0, warmup=1, active=1, repeat=1)
        fn()
        torch.cuda.synchronize()
        with profile(**kw) as prof:
            if way == "warm-up":
                fn()
                torch.cuda.synchronize()
                prof.step()
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            if way == "warm-up":
                prof.step()
        return {e.key: (e.count / REPS, e.self_device_time_total / 1e3 / REPS)
                for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}

    with torch.no_grad():
        for _ in range(40):  # earlier traces in the same process, as in phase 5
            trace(calls["K1a d768"], "cuda")
        for name, fn in calls.items():
            print(f"{name}: CUDA events after a head start {head_start(fn):.4f} ms a call",
                  flush=True)
            for way in ("cuda", "cuda+cpu", "warm-up"):
                for attempt in range(3):
                    got = trace(fn, way)
                    total = sum(t for _, t in got.values())
                    print(f"  {way:9s} #{attempt}: {total:.4f} ms a round; " + ", ".join(
                        f"{k[:40]} x{c:g} {t:.4f}" for k, (c, t) in sorted(got.items())),
                        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
