#!/usr/bin/env python3
"""Times the float32 prefix-attention forward (K3) of
``chadavit_tpu_torch/csrc/prefix_attention.cu`` and backward (K4) of
``chadavit_tpu_torch/csrc/prefix_attention_bwd.cu`` on one NVIDIA GPU: the
forward's one launch, and the backward's two (the prep pass, then dk/dv and
dq in one kernel), by CUDA events and by the profiler's device time, as built
and in diagnostic builds of the same sources:

- ``no_copy``: the ``cp.async`` copies do nothing (``-DSGEMM_NO_COPY``), so
  the kernels multiply whatever shared memory holds: the time left is the FMA
  loops, the shared-memory reads, the barriers, the exponentials and the
  writes;
- ``no_fma``: each operand the FMA loops read is added once instead of
  multiplied into every sum (``-DSGEMM_NO_FMA``): the time left is the
  copies, the shared-memory reads, the barriers, the exponentials and the
  writes;
- ``in_order``: the blocks of both take the images in index order rather
  than longest first (``-DATTN_FWD_IN_ORDER``, ``-DATTN_BWD_IN_ORDER``): what
  the order is worth;
- ``fwd_split1``, ``fwd_split2``: the forward's key walk whole in one block,
  or split across a cluster of two blocks whose shares are added in rank
  order through distributed shared memory (``-DATTN_FWD_SPLIT``; as built
  1): what the ragged tail of the long walks costs.

A kernel near ``no_copy`` is held by its loops, one near ``no_fma`` by its
loads. The diagnostic builds ``no_copy`` and ``no_fma`` compute nothing
meaningful; only their times are read. The others print the largest
difference of their forward's o and lse from the build as built. Each build
also prints the registers, shared memory and spills of the three kernels
(``nvcc -Xptxas -v``). Run from the root of the repository:

    python3 scripts/bench_attention_f32.py [train|hub]
    python3 scripts/bench_attention_f32.py b16 [--parent DIR]
    python3 scripts/bench_attention_f32.py tile

``train`` (the default): the float32 train batch, 16 sequences (8 images x 2
crops of the first 8 channel counts of chip_smoke.py's bf16 train batch) of
2048 rows; ``hub``: chip_smoke.py's hub shapes (8 images, 2048 rows). q, k and
v are the column slices of one packed qkv (rows of 576), as the layer passes
them; the backward's o and lse come from the forward kernel as built.

``b16``: ChAdaViT-B/16's head-64 instances at the same hub shapes, 12 heads
of 64, q, k and v the column slices of one packed qkv of rows of 2304, as
built, ``no_copy``, ``no_fma`` (at head 64 the backward's products run on
the tensor cores in 3xTF32, csrc/mma_tf32.cuh; there ``no_fma`` adds each
operand into its accumulator instead of the ``mma``) and ``tf32_one``
(one TF32 product a product, big by big, ``-DTF32_ONE_PRODUCT``: what the
other two cost); each build's backward's max abs error against the plain
float32 version (``flash_attention.prefix_flash_attention_backward_reference``,
TF32 off) and against a float64 one (``backward_f64``) on the rows of the
computed 64-row tiles, the plain float32 version's own error against the
float64 one, and the bound at the tensor cores' TF32 rate too (3 products a
product at 494.7 TFLOP/s dense). With ``--parent DIR`` (an unpacked checkout of
another commit) it also builds that tree's attention sources, times its
backward in turns with this tree's (parent, change, change, parent), prints
its errors the same way and whether each tree's backward repeats its bits
on a second call.

``tile``: one 64 x 64 x 64 score tile of the backward at head 64
(``scripts/attention_tile_probe.cu``), on the CUDA cores
(``attention_f32.cuh::scores<64>``) and on the tensor cores in 3xTF32
(``scores_tf32<64>``, each step's three products into a fragment of zeros
added into S; and the probe's ``scores_tf32_chained``, chained into S): the
time of one product, each of 1056 blocks of 4 warps forming it 512 times,
and each one's max abs error against a float64 product of the same float32
inputs. Each call is one launch of the C entry point, without the Python wrapper; the
forward (with its lse) and the whole backward are timed with CUDA events over
20 calls after 3 of warm-up, and each kernel by the profiler's device time
over the same 20 calls. Prints one line per build, the bounds (the
functions' operations at the f32 peak), one PyTorch call for each function
(``scaled_dot_product_attention`` and its autograd, which the port never
calls) and the card's name and power limit.
"""

import ctypes
import math
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
PEAK_F32_FLOPS = 67e12  # f32 FMA outside the tensor cores, NVIDIA H100 SXM data sheet
KERNELS = ("prefix_attention_kernel", "attention_bwd_prep_kernel", "attention_bwd_kernel")
SOURCES = ("prefix_attention_bwd.cu", "prefix_attention.cu", "attention_f32.cuh",
           "sgemm_f32.cuh", "storage.cuh", "mma_tf32.cuh")
B16_BUILDS = ("as built", "no_copy", "no_fma", "tf32_one")
PEAK_TF32_FLOPS = 494.7e12  # dense TF32 on the tensor cores, the same data sheet
BUILDS = {"as built": [], "no_copy": ["-DSGEMM_NO_COPY"], "no_fma": ["-DSGEMM_NO_FMA"],
          "in_order": ["-DATTN_FWD_IN_ORDER", "-DATTN_BWD_IN_ORDER"],
          **{f"fwd_split{n}": [f"-DATTN_FWD_SPLIT={n}"] for n in (1, 2)},
          "tf32_one": ["-DTF32_ONE_PRODUCT"]}


def build(out_dir: Path, names=None, csrc=None) -> dict:
    """One library of the forward and the backward per build (``names`` of
    BUILDS, all by default), all compiled at once, from the sources in
    ``csrc`` (this tree's by default)."""
    from chadavit_tpu_torch.ops import _build

    csrc = _build.CSRC if csrc is None else Path(csrc)
    procs = {}
    for name, flags in BUILDS.items():
        if names is not None and name not in names:
            continue
        d = out_dir / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
            if (csrc / src).exists():  # a header an older tree lacks
                (d / src).write_text((csrc / src).read_text())
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-shared", "-o",
             str(d / "lib.so"), str(d / "prefix_attention_bwd.cu"), str(d / "prefix_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for _, proc in procs.values():  # every nvcc ends before any failure is raised
        proc.wait()
    libs = {}
    for name, (path, proc) in procs.items():
        proc.obj = path.with_suffix(".none")  # ptxas_lines removes it; nvcc wrote none
        report = _build.ptxas_lines(proc)  # raises if nvcc failed
        print(f"{name}: ptxas " + ", ".join(
            f"{next(kn for kn in KERNELS if kn in k['name'])} {k.get('registers')} regs "
            f"{k.get('smem')} B static smem {k.get('spill_stores')}/{k.get('spill_loads')} B "
            "spilled" for k in report if any(kn in k["name"] for kn in KERNELS)), flush=True)
        lib = ctypes.CDLL(str(path))
        for fn in ("prefix_attention_fwd", "prefix_attention_bwd"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


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


def main_tile() -> int:
    """The ``tile`` mode (module doc)."""
    import torch

    from chadavit_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "bench_attention_tile"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "probe.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                           str(_build.CSRC), "-shared", "-o", str(lib_path),
                           str(ROOT / "scripts" / "attention_tile_probe.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas " + line.strip(), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_scores.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.probe_scores.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(64, 64, device=dev, generator=gen)
    b = torch.randn(64, 64, device=dev, generator=gen)
    exact = a.double() @ b.double().t()
    blocks, reps = 132 * 8, 512
    out = torch.empty(blocks, 64, 64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for which, name in ((0, "CUDA cores (scores<64>)"),
                        (1, "tensor cores, 3xTF32 (scores_tf32<64>)"),
                        (2, "tensor cores, 3xTF32 chained (scores_tf32_chained)")):
        assert lib.probe_scores(a.data_ptr(), b.data_ptr(), out.data_ptr(), 1, 1, which,
                                stream) == 0
        torch.cuda.synchronize()
        err = (out[0].double() - exact).abs().max().item()
        ms = time_events(lambda: lib.probe_scores(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                                  reps, blocks, which, stream), iters=10)
        per = ms / (blocks * reps) * 1e6
        print(f"tile {name}: {per:.4f} ns a 64 x 64 x 64 product ({ms:.4f} ms for {blocks} "
              f"blocks x {reps}; {2 * 64 ** 3 / (per * 1e-9) / 1e12:.2f} TFLOP/s of float32 "
              f"products); max abs error against float64 {err:.3e} (max |S| "
              f"{exact.abs().max().item():.3e})", flush=True)
    print(smi(), flush=True)
    return 0


def backward_f64(q, k, v, o, lse, dout, vl, heads):
    """The backward in float64 from the same float32 inputs (and the
    forward's lse): dq, dk, dv ``(B, S, 3 D)`` over the query rows of the
    computed 64-row tiles."""
    import torch

    from chadavit_tpu_torch.ops import flash_attention as fa

    b, s, d = q.shape
    hd = d // heads

    def split(t):
        return t.double().reshape(b, s, heads, hd).transpose(1, 2)

    qh, kh, vh, oh = map(split, (q, k, v, o))
    rows = fa.computed_rows(s, vl, q.device)[:, None, :, None]
    doh = torch.where(rows, split(dout), 0.0)
    key_ok = (torch.arange(s, device=q.device)[None, :] < vl[:, None])[:, None, None, :]
    p = torch.where(rows & key_ok, torch.exp2(qh @ kh.transpose(-1, -2) * (
        math.log2(math.e) / math.sqrt(hd)) - lse.double()[..., None]), 0.0)
    ds = p * (doh @ vh.transpose(-1, -2) - (doh * oh).sum(-1, keepdim=True))
    grads = (ds @ kh / math.sqrt(hd), ds.transpose(-1, -2) @ qh / math.sqrt(hd),
             p.transpose(-1, -2) @ doh)
    return torch.cat([t.transpose(1, 2).reshape(b, s, d) for t in grads], dim=-1)


def main_b16(parent) -> int:
    """The ``b16`` mode (module doc)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chadavit_tpu_torch.ops import flash_attention as fa
    from chadavit_tpu_torch.ops._build import BUILD_DIR

    d, heads = 768, 12
    hd = d // heads
    libs = build(BUILD_DIR / "bench_attention_f32_b16", names=B16_BUILDS)
    if parent is not None:
        libs.update({f"parent {n}": lib for n, lib in build(
            BUILD_DIR / "bench_attention_f32_b16_parent", names=("as built",),
            csrc=Path(parent) / "chadavit_tpu_torch" / "csrc").items()})
    valid = [1 + 196 * c for c in HUB_CHANNELS]
    bsz, dev = len(valid), torch.device("cuda")
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(bsz, S_PAD, 3 * d, device=dev, generator=gen)
    dout = torch.randn(bsz, S_PAD, d, device=dev, generator=gen)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    out = torch.empty(bsz, S_PAD, d, device=dev)
    lse = torch.empty(bsz, heads, S_PAD, device=dev)
    dqkv = torch.empty(bsz, S_PAD, 3 * d, device=dev)
    delta, _ = fa._bwd_scratch(bsz, heads, S_PAD, d, torch.float32, dev)
    qscale = fa._qscale(hd, torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    third = d * 4
    fwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), 3 * d, vl.data_ptr(), out.data_ptr(),
                d, lse.data_ptr(), bsz, heads, hd, S_PAD, qscale, stream)
    bwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), 3 * d, out.data_ptr(),
                dout.data_ptr(), d, lse.data_ptr(), delta.data_ptr(), vl.data_ptr(),
                dqkv.data_ptr(), dqkv.data_ptr() + third, dqkv.data_ptr() + 2 * third, 3 * d,
                bsz, heads, hd, S_PAD, qscale, 1.0 / math.sqrt(hd), stream)
    sq = sum(n * n for n in valid) * heads * hd
    print(f"b16: {bsz} sequences of {S_PAD} rows, {heads} heads of {hd}, {sum(valid)} valid; "
          f"backward bound (f32 operations at {PEAK_F32_FLOPS / 1e12:g} TFLOP/s) "
          f"{10 * sq / PEAK_F32_FLOPS * 1e3:.4f} ms, (3 TF32 products a product at "
          f"{PEAK_TF32_FLOPS / 1e12:g} TFLOP/s) {30 * sq / PEAK_TF32_FLOPS * 1e3:.4f} ms",
          flush=True)
    assert libs["as built"].prefix_attention_fwd(*fwd_args) == 0
    torch.cuda.synchronize()
    rows = [min(-(-n // 64) * 64, S_PAD) for n in valid]
    ref = fa.prefix_flash_attention_backward_reference(q, k, v, out, lse, dout, vl, heads)
    ref64 = backward_f64(q, k, v, out, lse, dout, vl, heads)
    plain64 = max((ref[i, :n].double() - ref64[i, :n]).abs().max().item()
                  for i, n in enumerate(rows))
    print(f"plain f32 version: max abs error {plain64:.3e} against the float64", flush=True)

    def errors():
        cells = []
        for what, r in (("plain f32", ref), ("float64", ref64)):
            e = max((dqkv[i, :n].double() - r[i, :n].double()).abs().max().item()
                    for i, n in enumerate(rows))
            cells.append(f"{e:.3e} against the {what}")
        return ", ".join(cells)

    def device_ms(lib):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                lib.prefix_attention_bwd(*bwd_args)
            torch.cuda.synchronize()
        return {kn: sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA and kn in e.key)
                / 1e3 / 20 for kn in KERNELS[1:]}

    def row(name):
        lib = libs[name]
        assert lib.prefix_attention_bwd(*bwd_args) == 0
        torch.cuda.synchronize()
        first = dqkv.clone()
        err = "" if "no_" in name else f"; max abs error {errors()}"
        assert lib.prefix_attention_bwd(*bwd_args) == 0
        torch.cuda.synchronize()
        same = "" if "no_" in name else (
            f"; a second call {'repeats' if torch.equal(first, dqkv) else 'CHANGES'} its bits")
        ms = time_events(lambda: lib.prefix_attention_bwd(*bwd_args))
        dev_ms = device_ms(lib)
        print(f"{name}: backward {ms:.4f} ms (prep {dev_ms[KERNELS[1]]:.4f}, dk/dv and dq "
              f"{dev_ms[KERNELS[2]]:.4f} ms device time){err}{same}", flush=True)

    order = (["parent as built", "as built", "as built", "parent as built"]
             if parent is not None else ["as built"])
    for name in order + [n for n in B16_BUILDS if n != "as built"]:
        row(name)
    qh, kh, vh = (t.reshape(bsz, S_PAD, heads, hd).transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    key_ok = (torch.arange(S_PAD, device=dev)[None, :] < vl[:, None])[:, None, None, :]
    lib_out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok)
    dh = dout.reshape(bsz, S_PAD, heads, hd).transpose(1, 2)
    lib_ms = time_events(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), dh,
                                                     retain_graph=True))
    print(f"library: scaled_dot_product_attention's autograd {lib_ms:.4f} ms", flush=True)
    print(smi(), flush=True)
    return 0


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from chadavit_tpu_torch.ops import flash_attention as fa
    from chadavit_tpu_torch.ops._build import BUILD_DIR

    if not torch.cuda.is_available():
        print("bench_attention_f32: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = args[i + 1]
        del args[i:i + 2]
    which = args[0] if args else "train"
    if which == "tile":
        return main_tile()
    if which == "b16":
        return main_b16(parent)
    channels = TRAIN_CHANNELS[:8] * 2 if which == "train" else HUB_CHANNELS
    valid = [1 + 196 * c for c in channels]
    dev = torch.device("cuda")
    libs = build(BUILD_DIR / "bench_attention_f32")
    bsz, hd = len(valid), D // HEADS
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(bsz, S_PAD, 3 * D, device=dev, generator=gen)
    dout = torch.randn(bsz, S_PAD, D, device=dev, generator=gen)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    out = torch.empty(bsz, S_PAD, D, device=dev)
    lse = torch.empty(bsz, HEADS, S_PAD, device=dev)
    dqkv = torch.empty(bsz, S_PAD, 3 * D, device=dev)
    delta, _ = fa._bwd_scratch(bsz, HEADS, S_PAD, D, torch.float32, dev)
    qscale = fa._qscale(hd, torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    third = D * 4
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
    print(f"{which}: {bsz} sequences of {S_PAD} rows, {sum(valid)} valid; bound (f32 "
          f"operations at {PEAK_F32_FLOPS / 1e12:g} TFLOP/s): forward "
          f"{4 * sq / PEAK_F32_FLOPS * 1e3:.4f} ms, backward "
          f"{10 * sq / PEAK_F32_FLOPS * 1e3:.4f} ms", flush=True)

    def device_ms(fn):
        """Each kernel's profiler device time a call, over iters calls of fn."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return {kn: sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA and kn in e.key)
                / 1e3 / iters for kn in KERNELS}

    assert libs["as built"].prefix_attention_fwd(*fwd_args) == 0
    torch.cuda.synchronize()
    ref_out, ref_lse = out.clone(), lse.clone()
    for name, lib in libs.items():
        assert lib.prefix_attention_fwd(*fwd_args) == 0
        torch.cuda.synchronize()
        diff = ("" if name.startswith("no_") else
                f", o and lse differ from as built by at most "
                f"{(out - ref_out).abs().max().item():.3e} and "
                f"{(lse - ref_lse).abs().max().item():.3e}")
        fwd_ms = time_ms(lambda: lib.prefix_attention_fwd(*fwd_args))
        fwd_dev = device_ms(lambda: lib.prefix_attention_fwd(*fwd_args))[KERNELS[0]]
        # the backward reads the forward's o and lse as built
        assert libs["as built"].prefix_attention_fwd(*fwd_args) == 0
        assert lib.prefix_attention_bwd(*bwd_args) == 0
        bwd_ms = time_ms(lambda: lib.prefix_attention_bwd(*bwd_args))
        dev_ms = device_ms(lambda: lib.prefix_attention_bwd(*bwd_args))
        print(f"{name}: forward {fwd_ms:.4f} ms ({fwd_dev:.4f} ms device time{diff}); backward "
              f"{bwd_ms:.4f} ms (prep {dev_ms[KERNELS[1]]:.4f}, dk/dv and dq "
              f"{dev_ms[KERNELS[2]]:.4f} ms device time)", flush=True)

    def heads(t):
        return t.reshape(bsz, S_PAD, HEADS, hd).transpose(1, 2)

    key_ok = (torch.arange(S_PAD, device=dev)[None, :] < vl[:, None])[:, None, None, :]
    qh, kh, vh = (heads(t).detach().requires_grad_(True) for t in (q, k, v))
    with torch.no_grad():
        fwd_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                    attn_mask=key_ok))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok)
    lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), heads(dout),
                                                 retain_graph=True))
    print(f"library: scaled_dot_product_attention {fwd_lib_ms:.4f} ms, its autograd "
          f"{lib_ms:.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
