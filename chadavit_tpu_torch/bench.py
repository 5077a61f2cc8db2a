"""Benchmark of the port's DINO pretrain step: images a second on one NVIDIA
GPU for ChAdaViT-moyen on mixed 1-10-channel batches, through the pretrain
path as it trains:

    host loader -> raw uint8 upload -> on-device multicrop (2 independent
    asymmetric global views) + the DINO train step (LARS, bf16)

The port's counterpart of the root ``bench.py`` (its spec :139-153,
``ASYMMETRIC_AUGS`` :50-64, the timed pass :153-205 and the disk-decode
phase :445-527, the ChAdaViT-B/16 phase :529-598). The augmentation runs
inside the timed loop; exact-width channel buckets (``bucket_round=1``), as
in training. Run on the card:

    python -m chadavit_tpu_torch.bench

It prints ``bench.py``'s canonical JSON line (``metric``, ``value``,
``unit``, ``vs_baseline``, ``mfu``, ...) right after the timed passes, then
again with the device fields (``device_img_s_per_chip``,
``device_busy_share``, ``aug_device_ms``, the card) and, when the disk phase
runs, once more with its fields, and when the B/16 phase runs, once more
with its fields: take the last line that parses.

- There is no compile to warm: one step per bucket width warms the
  allocator and the libraries' handles, then the best of ``REPEATS`` timed
  passes over the same batches counts. As in ``bench.py``, those batches are
  collated before the timed passes (the upload, the views and the step are
  timed); the disk phase runs the loader inside its passes.
- The device time comes from ``torch.profiler`` over one more timed pass:
  the sum of the CUDA kernels' time. ``device_busy_share`` is that sum over
  the pass's wall time (the profiler's own cost is in that wall time),
  ``device_busy_share_unprofiled`` over the best unprofiled pass's.
  ``aug_device_ms`` is the multicrop's kernels alone (the step's
  ``device_augment`` range), per step.
- ``mfu``: ``model_flops_per_image`` (a copy of ``bench.py:67-79``, useful
  FLOPs on valid tokens) over the wall time, against the H100's dense bf16
  peak, 989 TFLOP/s. ``vs_baseline`` keeps ``bench.py``'s definition: the
  analytic A100 estimate of ``BASELINE.md`` (40 img/s).
- The disk phase (``CHADAVIT_BENCH_DISK``, default on) writes a manifest
  dataset with the port's generator (``data/disk_dataset.py``) under
  ``CHADAVIT_BENCH_DISK_ROOT`` (default: a folder of the temporary
  directory, kept for the next run), then times the host loader alone
  (planes/s), the same step fed from disk, the same batches collated
  beforehand (what the loader's threads cost the step beside them), and an
  epoch with the decoded planes cached. The decoder is the native one where
  it builds, else PIL.
- The B/16 phase (``CHADAVIT_BENCH_B16``, default on) times ChAdaViT-B/16's
  step (:func:`b16_spec`: D 768, 12 heads, 65 536 prototypes, bf16) on
  ``CHADAVIT_BENCH_B16_BATCH`` (16) raw uint8 images of 10 channels with the
  same on-device multicrop: every batch pads to 2048 rows, where the JAX
  layer, and the port's, take the unfused route (library products around
  the attention kernels at head width 64). Two steps settle, then
  ``CHADAVIT_BENCH_B16_STEPS`` (6) steps on the wall and as many under the
  profiler: ``b16_wall_img_s_per_chip``, ``b16_device_img_s_per_chip`` and
  ``b16_device_mfu`` (``model_flops_per_image(10, d=768, f=2048)``, 3.213
  TFLOP an image, against 989 TFLOP/s).

Knobs, as ``bench.py``'s: ``CHADAVIT_BENCH_BATCH`` (32),
``CHADAVIT_BENCH_STEPS`` (40), ``CHADAVIT_BENCH_REPEATS`` (5),
``CHADAVIT_BENCH_DISK``, ``CHADAVIT_BENCH_DISK_ROOT``, ``CHADAVIT_BENCH_B16``,
``CHADAVIT_BENCH_B16_BATCH``, ``CHADAVIT_BENCH_B16_STEPS`` and
``CHADAVIT_BENCH_BUDGET_S`` (540: the disk and B/16 phases are each skipped,
with the reason printed, when less than their need is left).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

A100_EST_IMG_S = 40.0  # analytic A100 estimate for the torch reference; see BASELINE.md
H100_PEAK_BF16_FLOPS = 989e12  # dense bf16, NVIDIA H100 SXM data sheet
AUG_RANGE = "device_augment"  # the profiler range of the step's multicrop
DISK_NEED_S = 120  # the budget left that the disk phase needs
B16_NEED_S = 120   # and the B/16 phase

# the canonical 2-view asymmetric recipe
# (reference scripts/knn/bbbc048/augmentations/asymmetric.yaml)
ASYMMETRIC_AUGS = [
    {"crop_size": 224, "num_crops": 1,
     "rrc": {"enabled": True, "crop_min_scale": 0.08, "crop_max_scale": 1.0},
     "color_jitter": {"prob": 0.8}, "grayscale": {"prob": 0.2},
     "gaussian_blur": {"prob": 1.0}, "solarization": {"prob": 0.0},
     "horizontal_flip": {"prob": 0.5}},
    {"crop_size": 224, "num_crops": 1,
     "rrc": {"enabled": True, "crop_min_scale": 0.08, "crop_max_scale": 1.0},
     "color_jitter": {"prob": 0.8}, "grayscale": {"prob": 0.2},
     "gaussian_blur": {"prob": 0.1}, "solarization": {"prob": 0.2},
     "horizontal_flip": {"prob": 0.5}},
]


def model_flops_per_image(c: int, depth=12, d=192, f=2048, n=196, p=16) -> float:
    """Useful (unpadded) FLOPs for one image with ``c`` channels through one
    DINO step: student fwd+bwd (3x fwd) on 2 global crops + teacher fwd on 2.
    Multiply-add = 2 FLOPs (``bench.py:67-79``, derivation in BASELINE.md)."""
    s = 1 + n * c
    per_layer = (
        2 * s * d * 3 * d        # QKV projection
        + 2 * 2 * s * s * d      # scores + attn@V (all heads together sum to D)
        + 2 * s * d * d          # out projection
        + 4 * s * d * f          # FFN in + out
    )
    fwd = depth * per_layer + c * n * 2 * (p * p) * d  # + patch embed conv
    return 8.0 * fwd  # (1 fwd + 2 bwd) * 2 crops student + 1 fwd * 2 crops teacher


def bench_spec(dtype=torch.bfloat16):
    """The root bench's spec (``bench.py:139-153``)."""
    from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec

    return DinoPretrainSpec(
        backbone_kwargs=dict(embed_dim=192, patch_size=16, return_all_tokens=False,
                             max_number_channels=10, attn_impl="auto"),
        img_size=224, max_channels=10, num_prototypes=4096,
        warmup_teacher_temperature_epochs=50, clip_grad=3.0, steps_per_epoch=100,
        max_epochs=400, warmup_epochs=10, dtype=dtype)


def b16_spec(dtype=torch.bfloat16):
    """The root bench's ChAdaViT-B/16 spec (``bench.py:552-561``)."""
    from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec

    return DinoPretrainSpec(
        backbone_kwargs=dict(embed_dim=768, num_heads=12, patch_size=16,
                             return_all_tokens=False, max_number_channels=10, attn_impl="auto"),
        img_size=224, max_channels=10, num_prototypes=65536,
        warmup_teacher_temperature_epochs=50, clip_grad=3.0, steps_per_epoch=100,
        max_epochs=400, warmup_epochs=10, dtype=dtype)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def device_seconds(prof) -> tuple:
    """(seconds of CUDA kernels, seconds of those under the multicrop range)
    in a ``torch.profiler`` trace. Each kernel is counted once, by the op
    that launched it; the range's own device-side record is not a kernel."""
    kernels = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.key != AUG_RANGE)
    aug = sum(e.device_time_total for e in prof.events()
              if e.name == AUG_RANGE and e.device_type == torch.autograd.DeviceType.CPU)
    return kernels / 1e6, aug / 1e6


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_b16(batch: int = 16, steps: int = 6) -> Dict:
    """The B/16 phase (module docstring; root ``bench.py:529-598``): its
    fields of the JSON line. Needs a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    from chadavit_tpu_torch.data.device_augment import aug_generator
    from chadavit_tpu_torch.train.pretrain import build_dino

    dev = torch.device("cuda")
    state, step, _, _ = build_dino(b16_spec(), device_augmentations=ASYMMETRIC_AUGS)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 255, (batch, 10, 224, 224), dtype=np.uint8)).to(dev)
    counts = torch.full((batch,), 10, dtype=torch.int32, device=dev)
    counter = [0]  # the generator index of the next step

    def run_steps(n):
        nonlocal state
        m = None
        for _ in range(n):
            state, m = step(state, {"images": images, "channel_counts": counts,
                                    "generator": aug_generator(0, counter[0], dev)})
            counter[0] += 1
        loss = float(m["dino_loss"])  # waits for the last step
        torch.cuda.synchronize()
        if not np.isfinite(loss):
            raise RuntimeError(f"B/16 dino_loss {loss}")

    run_steps(2)  # settle
    t0 = time.perf_counter()
    run_steps(steps)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_steps(steps)
    dev_s, _ = device_seconds(prof)
    if dev_s <= 0:
        raise RuntimeError("the profiler recorded no device time in the B/16 phase")
    flops = model_flops_per_image(10, d=768, f=2048) * steps * batch
    return {"b16_wall_img_s_per_chip": round(steps * batch / wall, 2), "b16_batch": batch,
            "b16_steps": steps,
            "b16_device_img_s_per_chip": round(steps * batch / dev_s, 2),
            "b16_device_mfu": round(flops / dev_s / H100_PEAK_BF16_FLOPS, 4),
            "b16_step_device_ms": round(1e3 * dev_s / steps, 4)}


def run(batch: int = 32, steps: int = 40, repeats: int = 5, disk: bool = True,
        disk_root: Optional[str] = None, budget_s: float = 540.0, b16: bool = True,
        b16_batch: int = 16, b16_steps: int = 6,
        emit: Callable[[str], None] = print) -> Dict:
    """Time the step as the module docstring says; ``emit`` each JSON line
    and return the last record. Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bench times the card: no CUDA device here")
    from chadavit_tpu_torch.data.datasets import SyntheticChannels
    from chadavit_tpu_torch.data.device_augment import aug_generator
    from chadavit_tpu_torch.data.pipeline import HostLoader, device_prefetch, to_device
    from chadavit_tpu_torch.train.pretrain import build_dino

    t_start = time.time()
    dev = torch.device("cuda")
    card = card_line()
    spec = bench_spec()
    state, step, _, _ = build_dino(spec, device_augmentations=ASYMMETRIC_AUGS)
    counter = [0]  # the generator index of the next step, across passes

    def upload(b):
        out = to_device({"images": b["images"], "channel_counts": b["channel_counts"]}, dev)
        out["generator"] = aug_generator(0, counter[0], dev)
        counter[0] += 1
        return len(b["channel_counts"]), out

    def timed_pass(batches):
        nonlocal state
        n_i, m = 0, None
        for n, dev_batch in device_prefetch(iter(batches), upload, depth=2):
            state, m = step(state, dev_batch)
            n_i += n
        loss = float(m["dino_loss"])  # waits for the last step
        torch.cuda.synchronize()
        if not np.isfinite(loss):
            raise RuntimeError(f"dino_loss {loss} after a timed pass")
        return n_i

    # synthetic mixed 1-10-channel uint8 images through the real host loader
    ds = SyntheticChannels(n=(steps + 10) * batch, img_size=224, min_channels=1,
                           max_channels=10, seed=0, dtype=np.uint8)
    loader = HostLoader(ds, batch_size=batch, max_channels=10, num_workers=8, seed=0,
                        channels_last=True, bucket_by_channels=True, bucket_round=1,
                        dtype=np.uint8)
    batches = list(loader)
    widths = {}
    for b in batches:
        widths.setdefault(b["images"].shape[1], b)
    timed_pass([widths[w] for w in sorted(widths)])  # one step a width warms
    timed = batches[:steps]
    n_img = sum(len(b["channel_counts"]) for b in timed)
    flops = sum(model_flops_per_image(int(c)) for b in timed for c in b["channel_counts"])
    dts = []
    for r in range(repeats):
        t0 = time.perf_counter()
        timed_pass(timed)
        dts.append(time.perf_counter() - t0)
        _log(f"repeat {r}: {dts[-1]:.3f} s ({n_img / dts[-1]:.1f} img/s)")
    dt = min(dts)
    out = {
        "metric": "dino_pretrain_images_per_sec_per_chip",
        "value": round(n_img / dt, 2),
        "unit": "img/s/chip",
        "vs_baseline": round(n_img / dt / A100_EST_IMG_S, 3),
        "mfu": round(flops / dt / H100_PEAK_BF16_FLOPS, 4),
        "gflop_per_image": round(flops / n_img / 1e9, 2),
        "batch": batch,
        "timed_steps": len(timed),
        "widths_timed": sorted({b["images"].shape[1] for b in timed}),
        "bucket_round": 1,
        "repeats_s": [round(x, 4) for x in dts],
        "pipeline": "uint8 host->device + on-device 2-view asymmetric augment + train step",
    }
    emit(json.dumps(out))

    # the device's share: one more timed pass under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timed_pass(timed)
        wall = time.perf_counter() - t0
    dev_s, aug_s = device_seconds(prof)
    if dev_s <= 0:
        raise RuntimeError("the profiler recorded no device time")
    out.update({
        "device_img_s_per_chip": round(n_img / dev_s, 2),
        "device_mfu": round(flops / dev_s / H100_PEAK_BF16_FLOPS, 4),
        "device_busy_share": round(dev_s / wall, 4),
        # the same device time over the best unprofiled pass: the profiler's
        # own cost on the host is out of this one
        "device_busy_share_unprofiled": round(dev_s / dt, 4),
        "aug_device_ms": round(1e3 * aug_s / len(timed), 4),
        "step_device_ms": round(1e3 * dev_s / len(timed), 4),
        "wall_overhead_factor": round((n_img / dev_s) / (n_img / dt), 3),
        "card": card,
        "device": torch.cuda.get_device_name(0),
    })
    emit(json.dumps(out))

    def budget_left(phase: str, need: float) -> bool:
        left = budget_s - (time.time() - t_start)
        if left < need:
            _log(f"{phase} phase skipped: {left:.0f} s of the budget left, it needs {need:.0f}")
        return left >= need

    if disk and budget_left("disk", DISK_NEED_S):
        out.update(_disk_phase(batch, steps, repeats, disk_root, timed_pass))
        emit(json.dumps(out))
    # ---- the B/16 phase: ChAdaViT-B/16's step at width 10
    if b16 and budget_left("B/16", B16_NEED_S):
        del state, step
        torch.cuda.empty_cache()
        out.update(run_b16(b16_batch, b16_steps))
        emit(json.dumps(out))
    return out


def _disk_phase(batch, steps, repeats, disk_root, timed_pass) -> Dict:
    """The disk phase (module docstring): its fields of the JSON line."""
    from chadavit_tpu_torch.data import native
    from chadavit_tpu_torch.data.datasets import IDRCell100K
    from chadavit_tpu_torch.data.disk_dataset import generate
    from chadavit_tpu_torch.data.pipeline import HostLoader
    from chadavit_tpu_torch.data.transforms import RawResize

    out = {}
    root = disk_root or os.path.join(tempfile.gettempdir(), "chadavit_torch_disk_bench_v1")
    n_disk = (steps + 10) * batch
    have = 0
    if os.path.exists(os.path.join(root, ".complete")):
        with open(os.path.join(root, "train.csv")) as f:
            have = sum(1 for _ in f)
    if have < n_disk:
        _log(f"generating the disk dataset ({n_disk} images) in {root}")
        generate(root, n_disk, workers=4, seed=3)
        open(os.path.join(root, ".complete"), "w").close()
    use_native = native.is_available()
    decoder = native.describe()
    disk_ds = IDRCell100K(root, train=True, raw=True, transform=RawResize(224))
    kw = dict(batch_size=batch, max_channels=10, num_workers=2, seed=0,
              bucket_by_channels=True, bucket_round=1, channels_last=True, dtype=np.uint8)
    if use_native:
        kw["native_batch_fn"] = native.make_dense_batch_fn(disk_ds, 224, num_threads=2)
    disk_loader = HostLoader(disk_ds, **kw)
    t0 = time.perf_counter()  # the host alone (and the page cache warmed)
    disk_batches = list(disk_loader)
    n_planes = sum(int(b["channel_counts"].sum()) for b in disk_batches)
    planes_s = n_planes / (time.perf_counter() - t0)
    # the disk set's channel mix is its own: its useful work an image
    disk_flops = sum(model_flops_per_image(int(c)) for b in disk_batches
                     for c in b["channel_counts"])
    _log(f"host-only disk decode: {planes_s:.0f} planes/s ({decoder})")
    best, n_i = None, 0
    for r in range(max(2, repeats - 2)):
        disk_loader.set_epoch(0)  # the same batches each repeat
        t0 = time.perf_counter()
        n_i = timed_pass(disk_loader)
        d = time.perf_counter() - t0
        best = d if best is None else min(best, d)
        _log(f"disk repeat {r}: {d:.3f} s ({n_i / d:.1f} img/s)")
    # the same batches collated beforehand, as the synthetic passes are:
    # what the loader's threads cost the step when they run beside it
    t0 = time.perf_counter()
    n_c = timed_pass(disk_batches)
    precollated = n_c / (time.perf_counter() - t0)
    del disk_batches
    out.update({"decoder": decoder,
                "disk_wall_img_s_per_chip": round(n_i / best, 2),
                "disk_mfu": round(disk_flops / best / H100_PEAK_BF16_FLOPS, 4),
                "disk_gflop_per_image": round(disk_flops / n_i / 1e9, 2),
                "disk_precollated_img_s_per_chip": round(precollated, 2),
                "disk_decode_planes_per_s": round(planes_s, 1),
                "disk_pipeline": "PNG decode -> uint8 upload -> on-device augment + step"})
    if use_native:  # an epoch with every plane decoded already
        cache = native.DecodedPlaneCache()
        disk_loader.native_batch_fn = native.make_dense_batch_fn(disk_ds, 224, num_threads=2,
                                                                 cache=cache)
        disk_loader.set_epoch(0)
        for _ in disk_loader:  # fill the cache
            pass
        disk_loader.set_epoch(0)
        t0 = time.perf_counter()
        n_i = timed_pass(disk_loader)
        out["disk_cached_img_s_per_chip"] = round(n_i / (time.perf_counter() - t0), 2)
        _log(f"disk cached epoch: {out['disk_cached_img_s_per_chip']} img/s "
             f"(cache {cache.bytes / 2**20:.0f} MiB)")
    return out


def main() -> int:
    env = os.environ.get
    if not torch.cuda.is_available():
        print("chadavit_tpu_torch.bench: no CUDA device; the bench times the card",
              file=sys.stderr)
        return 1
    run(batch=int(env("CHADAVIT_BENCH_BATCH", 32)), steps=int(env("CHADAVIT_BENCH_STEPS", 40)),
        repeats=int(env("CHADAVIT_BENCH_REPEATS", 5)),
        disk=env("CHADAVIT_BENCH_DISK", "1") != "0", disk_root=env("CHADAVIT_BENCH_DISK_ROOT"),
        budget_s=float(env("CHADAVIT_BENCH_BUDGET_S", 540)),
        b16=env("CHADAVIT_BENCH_B16", "1") != "0",
        b16_batch=int(env("CHADAVIT_BENCH_B16_BATCH", 16)),
        b16_steps=int(env("CHADAVIT_BENCH_B16_STEPS", 6)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
