#!/usr/bin/env python3
"""Times the bf16 tensor-core prefix attention of
``chadavit_tpu_torch/csrc/prefix_attention_bf16.cu`` on one NVIDIA GPU: the
forward (K3, with the lse, as the train path calls it) and the three launches
of the backward (K4: the prep pass, dk/dv, dq), as built and in two
diagnostic builds of the same source:

- ``no_copy``: the ``cp.async`` copies do nothing, so the kernels multiply
  whatever shared memory holds: the time left is the tensor-core loop, the
  softmax, the barriers, the epilogue and the writes;
- ``no_mma``: each ``mma.sync`` is an integer add on its registers, so the
  time left is the copies, the ``ldmatrix`` loads, the softmax, the barriers
  and the writes.

The two bracket what bounds each kernel: one near ``no_copy`` is held by its
loop, one near ``no_mma`` by its loads. The diagnostic builds compute nothing
meaningful; only their times are read. One more computes the same
function: ``no_turns`` drops the named-barrier turns of the head-64
``wgmma`` kernels' warpgroups (a tree without them builds as it is). Each
build prints what ptxas says of the head-64 forward's registers and spills.
Run from the root of the repository:

    python3 scripts/bench_attention_bf16.py [train|hub]

``train`` (the default): 64 sequences (32 images x 2 crops of the channel
counts of chip_smoke.py's bf16 train batch) of 2048 rows; ``hub``:
chip_smoke.py's hub shapes (8 images, 2048 rows). q, k and v are the column
slices of one packed qkv (rows of 576), as the layer passes them. Each call
is one launch of the C entry point, without the Python wrapper; the forward
and the whole backward are timed with CUDA events over 20 calls after 3 of
warm-up, and each backward kernel by the profiler's device time over the
same 20 calls. Prints one line per build, the bound of each function (its
operations at the bf16 tensor-core peak) and the card's name and power limit.

``b16``: ChAdaViT-B/16's head-64 instances (12 heads of 64, q, k and v the
column slices of one packed qkv with rows of 2304) at two shapes: the hub
(8 images of 2048 rows, the channels of ``hub``) and the 7-channel bucket
of ``scripts/bench_b16_step.py`` (16 images x 2 global crops of 7 channels:
32 sequences of 1 373 valid rows padded to 1 408). There it also times one
PyTorch call for the same backward (``scaled_dot_product_attention``'s
backward with the key mask, by autograd; the port never calls it) and one
for the same forward (``scaled_dot_product_attention`` with the key mask), by
CUDA events and by the profiler's device time, and the forward by the
profiler's device time too. The head-64 forward and the backward's dk/dv and
dq are ``wgmma`` kernels fed by TMA, whose diagnostic builds are
``-DWGMMA_NO_LOAD`` (in ``no_copy``) and ``-DWGMMA_NO_MMA`` (in ``no_mma``);
an older tree's ``mma.sync`` kernels take the header patches above. With
``--parent DIR`` (an unpacked checkout of another commit, e.g. ``git
archive`` of the parent into a directory that ``.gitignore`` lists) it also
builds that tree's kernels, times the two trees' forward and backward in
turns (parent, change, change, parent) in one process, prints whether the
two trees' forward out and lse are the same bits, and how far each tree's
out, dq, dk and dv lie from the plain bf16 version and from each other::

    python3 scripts/bench_attention_bf16.py b16 [--parent DIR]
"""

import argparse
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
S_PAD, D, HEADS = 2048, 192, 2
# b16: (S_pad, channel counts of the sequences) of the hub and of the 7-channel
# bucket (16 images x 2 global crops), at D 768 in 12 heads
B16_SHAPES = {"hub": (2048, HUB_CHANNELS), "bucket7": (1408, [7] * 32)}
B16_D, B16_HEADS = 768, 12
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor cores, NVIDIA H100 SXM data sheet
# pieces of the backward's kernel names: the prep pass, dk/dv, dq
KERNELS = ("attention_bwd_prep", "attention_dkdv", "attention_dq")


def _no_copy(header: str) -> str:
    return re.sub(r'asm volatile\("cp\.async\.cg.*?\);', "", header, flags=re.S)


def _no_mma(header: str) -> str:
    return re.sub(r'asm volatile\(\s*"mma\.sync.*?\);',
                  "c[0] += __uint_as_float(a[0] ^ b0); c[1] += __uint_as_float(a[1] ^ b1);",
                  header, flags=re.S)


def _no_turns(source: str) -> str:
    return re.sub(r".*wg::bar_(sync|arrive)\(TURN.*\n", "", source)


# build -> (the patch of mma_bf16.cuh, the flags of the wgmma kernels, the
# patch of prefix_attention_bf16.cu)
BUILDS = {"as built": (None, [], None), "no_copy": (_no_copy, ["-DWGMMA_NO_LOAD"], None),
          "no_mma": (_no_mma, ["-DWGMMA_NO_MMA"], None), "no_turns": (None, [], _no_turns)}


def build(out_dir: Path, csrc=None) -> dict:
    """One library of prefix_attention_bf16.cu per build, compiled in
    parallel, from the sources in ``csrc`` (this tree's by default)."""
    from chadavit_tpu_torch.ops import _build

    csrc = _build.CSRC if csrc is None else Path(csrc)
    procs = {}
    for name, (patch, flags, cu_patch) in BUILDS.items():
        d = out_dir / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for src in [csrc / "prefix_attention_bf16.cu", *csrc.glob("*.cuh")]:
            text = src.read_text()
            if patch and src.name == "mma_bf16.cuh":
                text = patch(text)
            if cu_patch and src.name == "prefix_attention_bf16.cu":
                text = cu_patch(text)
            (d / src.name).write_text(text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-shared", "-o",
             str(d / "lib.so"), str(d / "prefix_attention_bf16.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        lines = out.splitlines()  # ptxas on the head-64 forward: registers, spills
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "attention_fwd_wgmma" in line:
                said = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                        if "registers" in x or "spill" in x or "serialized" in x]
                print(f"{csrc.parent.parent.name} {name}: ptxas on the head-64 forward: "
                      + "; ".join(said), flush=True)
        lib = ctypes.CDLL(str(path))
        for fn in ("prefix_attention_fwd_bf16", "prefix_attention_bwd_bf16"):
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


def device_ms(fn, keys, iters=20):
    """The profiler's device time per call of the kernels whose names hold
    each of ``keys`` (None: every kernel the call launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if keys is None:
        return sum(e.self_device_time_total for e in events) / 1e3 / iters
    return {kn: sum(e.self_device_time_total for e in events if kn in e.key) / 1e3 / iters
            for kn in keys}


class Shapes:
    """Seeded bf16 operands of one shape: q, k, v the column slices of one
    packed qkv, the forward's out and lse (filled by a forward launch of the
    library as built), dout, the outputs and the scratch."""

    def __init__(self, s_pad, channels, d, heads, lib):
        import torch

        from chadavit_tpu_torch.ops import flash_attention as fa

        dev = torch.device("cuda")
        self.valid = [1 + 196 * c for c in channels]
        self.bsz, self.s_pad, self.d, self.heads = len(self.valid), s_pad, d, heads
        self.hd = d // heads
        bsz = self.bsz
        self.vl = torch.tensor(self.valid, dtype=torch.int32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)

        def bf(*shape):
            return torch.randn(*shape, device=dev, generator=gen).bfloat16()

        self.qkv, self.dout = bf(bsz, s_pad, 3 * d), bf(bsz, s_pad, d)
        self.q, self.k, self.v = (self.qkv[..., i * d:(i + 1) * d] for i in range(3))
        self.out = torch.empty(bsz, s_pad, d, dtype=torch.bfloat16, device=dev)
        self.lse = torch.empty(bsz, heads, s_pad, device=dev)
        self.dqkv = torch.empty(bsz, s_pad, 3 * d, dtype=torch.bfloat16, device=dev)
        self.delta, _ = fa._bwd_scratch(bsz, heads, s_pad, d, torch.bfloat16, dev)
        self.qscale = fa._qscale(self.hd, torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream
        third = d * 2
        self.fwd_args = (self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(), 3 * d,
                         self.vl.data_ptr(), self.out.data_ptr(), d, self.lse.data_ptr(), bsz,
                         heads, self.hd, s_pad, self.qscale, stream)
        self.bwd_args = (self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(), 3 * d,
                         self.out.data_ptr(), self.dout.data_ptr(), d, self.lse.data_ptr(),
                         self.delta.data_ptr(), self.vl.data_ptr(), self.dqkv.data_ptr(),
                         self.dqkv.data_ptr() + third, self.dqkv.data_ptr() + 2 * third, 3 * d,
                         bsz, heads, self.hd, s_pad, self.qscale, 1.0 / math.sqrt(self.hd),
                         stream)
        assert lib.prefix_attention_fwd_bf16(*self.fwd_args) == 0
        torch.cuda.synchronize()
        self.ref_out, self.ref_lse = self.out.clone(), self.lse.clone()
        # sum of vl^2 hd over images and heads: the products' operations / 4 or 10
        self.sq = sum(n * n for n in self.valid) * heads * self.hd

    def header(self, label):
        return (f"{label}: {self.bsz} sequences of {self.s_pad} rows, {sum(self.valid)} valid, "
                f"{self.heads} heads of {self.hd}; bound (bf16 operations at "
                f"{PEAK_BF16_FLOPS / 1e12:g} TFLOP/s): forward "
                f"{4 * self.sq / PEAK_BF16_FLOPS * 1e3:.4f} ms, backward "
                f"{10 * self.sq / PEAK_BF16_FLOPS * 1e3:.4f} ms")

    def restore(self):
        """The forward's out and lse as built (a diagnostic build's forward
        leaves garbage in them)."""
        self.out.copy_(self.ref_out)
        self.lse.copy_(self.ref_lse)

    def forward(self, lib):
        """The forward's out and lse of ``lib`` (clones); the buffers then
        hold the forward as built again."""
        import torch

        assert lib.prefix_attention_fwd_bf16(*self.fwd_args) == 0
        torch.cuda.synchronize()
        got = self.out.clone(), self.lse.clone()
        self.restore()
        return got

    def backward(self, lib):
        """The backward's dqkv of ``lib`` (a clone)."""
        import torch

        self.restore()
        assert lib.prefix_attention_bwd_bf16(*self.bwd_args) == 0
        torch.cuda.synchronize()
        return self.dqkv.clone()

    def library(self):
        """SDPA's backward with the key mask, by autograd (events, device),
        then its forward (events, device)."""
        import torch
        import torch.nn.functional as F

        def heads(t):
            return t.reshape(self.bsz, self.s_pad, self.heads, self.hd).transpose(1, 2)

        qh, kh, vh = (heads(t).detach().requires_grad_(True) for t in (self.q, self.k, self.v))
        key_ok = (torch.arange(self.s_pad, device=self.vl.device)[None, :]
                  < self.vl[:, None])[:, None, None, :]
        o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok)
        do = heads(self.dout)

        def fn():
            return torch.autograd.grad(o, (qh, kh, vh), do, retain_graph=True)

        def fwd():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok)

        return time_ms(fn), device_ms(fn, None), time_ms(fwd), device_ms(fwd, None)


def row(name, lib, sh):
    """Times one build on one shape: the forward by events and by the
    profiler, the whole backward by events, each backward kernel by the
    profiler."""
    fwd_ms = time_ms(lambda: lib.prefix_attention_fwd_bf16(*sh.fwd_args))
    fwd_dev = device_ms(lambda: lib.prefix_attention_fwd_bf16(*sh.fwd_args), None)
    sh.restore()
    assert lib.prefix_attention_bwd_bf16(*sh.bwd_args) == 0
    bwd_ms = time_ms(lambda: lib.prefix_attention_bwd_bf16(*sh.bwd_args))
    dev_ms = device_ms(lambda: lib.prefix_attention_bwd_bf16(*sh.bwd_args), KERNELS)
    total = sum(dev_ms.values())
    print(f"{name}: forward {fwd_ms:.4f} ms (device {fwd_dev:.4f} ms; "
          f"{100 * 4 * sh.sq / PEAK_BF16_FLOPS * 1e3 / fwd_dev:.1f} % of the bound), "
          f"backward {bwd_ms:.4f} ms (prep "
          f"{dev_ms[KERNELS[0]]:.4f}, dkdv {dev_ms[KERNELS[1]]:.4f}, dq "
          f"{dev_ms[KERNELS[2]]:.4f}, sum {total:.4f} ms device time; "
          f"{100 * 10 * sh.sq / PEAK_BF16_FLOPS * 1e3 / total:.1f} % of the bound)", flush=True)


def forward_errors(sh, outs: dict):
    """Each tree's forward out against the plain bf16 version (max abs on the
    computed query tiles), and whether the trees' out and lse are the same
    bits."""
    import torch

    from chadavit_tpu_torch.ops import flash_attention as fa

    ref = fa.prefix_flash_attention_reference(sh.q, sh.k, sh.v, sh.vl, sh.heads)
    keep = torch.zeros(sh.bsz, sh.s_pad, 1, dtype=torch.bool, device=ref.device)
    for i, n in enumerate(sh.valid):
        keep[i, :-(-n // 64) * 64] = True
    cells = []
    for name, (out, _) in outs.items():
        err = torch.where(keep, out.float() - ref.float(), 0.0).abs().max().item()
        cells.append(f"{name} out {err:.3e} ({err / ref.float().abs().max().item():.2e} of max)")
    print("forward against the plain bf16 version: " + ", ".join(cells), flush=True)
    if len(outs) == 2:
        (oa, la), (ob, lb) = outs.values()
        print(f"forward: out the same bits in both trees {torch.equal(oa, ob)}, lse "
              f"{torch.equal(la, lb)} (max apart {(oa.float() - ob.float()).abs().max().item():.3e}"
              f", {(la - lb).abs().max().item():.3e})", flush=True)


def errors(sh, outs: dict):
    """Each tree's dq, dk, dv against the plain bf16 version (max abs on the
    computed query tiles, and that over the plain's largest entry), and the
    two trees against each other."""
    import torch

    from chadavit_tpu_torch.ops import flash_attention as fa

    sh.restore()
    ref = fa.prefix_flash_attention_backward_reference(sh.q, sh.k, sh.v, sh.out, sh.lse,
                                                       sh.dout, sh.vl, sh.heads)
    keep = torch.zeros(sh.bsz, sh.s_pad, 1, dtype=torch.bool, device=ref.device)
    for i, n in enumerate(sh.valid):
        keep[i, :-(-n // 64) * 64] = True
    cells = []
    for name, got in outs.items():
        for j, part in enumerate(("dq", "dk", "dv")):
            g, r = (t[..., j * sh.d:(j + 1) * sh.d].float() for t in (got, ref))
            err = torch.where(keep, g - r, 0.0).abs().max().item()
            cells.append(f"{name} {part} {err:.3e} ({err / r.abs().max().item():.2e} of max)")
    if len(outs) == 2:
        a, b = outs.values()
        cells.append(f"trees apart {(a.float() - b.float()).abs().max().item():.3e}")
    print("against the plain bf16 version: " + ", ".join(cells), flush=True)


def main_b16(parent) -> int:
    import torch

    from chadavit_tpu_torch.ops._build import BUILD_DIR

    libs = build(BUILD_DIR / "bench_attention_bf16_b16")
    if parent is not None:
        libs.update({f"parent {n}": lib for n, lib in build(
            BUILD_DIR / "bench_attention_bf16_b16_parent",
            Path(parent) / "chadavit_tpu_torch" / "csrc").items()})
    for label, (s_pad, channels) in B16_SHAPES.items():
        sh = Shapes(s_pad, channels, B16_D, B16_HEADS, libs["as built"])
        print(sh.header(f"b16 {label}"), flush=True)
        order = (["parent as built", "as built", "as built", "parent as built"]
                 if parent is not None else ["as built"])
        for name in order:
            row(name, libs[name], sh)
        for name in libs:
            if not name.endswith("as built"):
                row(name, libs[name], sh)
        fwd_outs = {name: sh.forward(libs[name]) for name in libs if name.endswith("as built")}
        fwd_again = sh.forward(libs["as built"])
        print(f"as built: the forward's same bits on a second call "
              f"{all(torch.equal(a, b) for a, b in zip(fwd_again, fwd_outs['as built']))}",
              flush=True)
        forward_errors(sh, fwd_outs)
        outs = {name: sh.backward(libs[name]) for name in libs if name.endswith("as built")}
        again = sh.backward(libs["as built"])
        print(f"as built: the same bits on a second call {torch.equal(again, outs['as built'])}",
              flush=True)
        errors(sh, outs)
        lib_ms, lib_dev, lib_fwd_ms, lib_fwd_dev = sh.library()
        print(f"library (SDPA backward, autograd): {lib_ms:.4f} ms, device {lib_dev:.4f} ms; "
              f"SDPA forward {lib_fwd_ms:.4f} ms, device {lib_fwd_dev:.4f} ms", flush=True)
        del sh
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


def main() -> int:
    import torch

    from chadavit_tpu_torch.ops._build import BUILD_DIR

    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="train", choices=("train", "hub", "b16"))
    ap.add_argument("--parent", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_attention_bf16: needs a CUDA device", file=sys.stderr)
        return 1
    if args.which == "b16":
        return main_b16(args.parent)
    channels = TRAIN_CHANNELS * 2 if args.which == "train" else HUB_CHANNELS
    libs = build(BUILD_DIR / "bench_attention_bf16")
    sh = Shapes(S_PAD, channels, D, HEADS, libs["as built"])
    print(sh.header(args.which), flush=True)
    for name, lib in libs.items():
        row(name, lib, sh)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
