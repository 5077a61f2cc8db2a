#!/usr/bin/env python3
"""Times ChAdaViT-B/16's bf16 wgmma kernels at D 768 (K1a ``ln_linear``, K1c
``linear_relu``, K1b ``linear_residual_ln`` at its two sites, with and
without its save outputs, the four K2b sites of ``linear_dgrad`` and the four
K2c sites of ``linear_wgrad``) on one NVIDIA GPU, at chip_smoke.py's narrow hub shapes
(phase 2c: 8 images of 1-7 channels, S_pad 1408, 6 868 valid rows), through
the port's wrappers, and says whether the D 192 bf16 instances of the same
steps give the same bits as another tree's. Run from the root of the
repository:

    python3 scripts/bench_wgmma_bf16.py [--parent DIR | --builds]

Alone it times this tree. With ``--parent DIR`` (an unpacked checkout of
another commit, e.g. ``git archive`` of the parent into a directory that
``.gitignore`` lists) it times the two trees in turns, parent, change,
change, parent, each in a process of its own that builds its tree's kernels,
and compares, between the trees, (a) the SASS of every kernel both libraries
hold (``cuobjdump -sass``: the D 192 instances must compile to the code they
had) and (b) hashes of the D 192 bf16 K1a and K2c outputs and of the D 192
bf16 K1c and K2b outputs on seeded inputs (``d192_digests``, which
``tests/test_torch_kernels_gpu.py`` also reads), and of the D 768 bf16 K1a's
qkv and row stats at the timed shapes. Each tree also says whether its D 768
bf16 K1b's out and row stats are the bits of the LayerNorm order it keeps
(``tests/torch_bf16_order.py``) applied to its own pre-LN sum r.

With ``--builds`` it times this tree's kernels as built and in three
diagnostic builds of ``csrc/linear_wgmma_bf16.cu`` (compiled in parallel):
``no_load`` (the TMA loads do nothing), ``no_mma`` (the wgmma products do
nothing) and ``no_store`` (the GEMMs store no result), each kernel by the
profiler's device time (a trace whose first round is dropped), through the C
entry points; a build near ``no_load`` is held by its products and stores,
one near ``no_mma`` by its loads.

Each time is read three ways: CUDA events over 20 calls after 3 of warm-up
(the host's launch rate where it is slower than the card), CUDA events over
the same calls queued behind a 0.1 s spin of the card (torch.cuda._sleep: the
device's time), and the profiler's device time of the kernels the call
launches. Beside them: one PyTorch call for the same function (K1a:
``F.layer_norm`` then ``addmm``; K1c: ``relu`` of ``addmm``; K1b:
``F.layer_norm`` of ``addmm`` plus the residual; K2b: ``mm`` of dY
and W, ``addmm`` onto the residual at FFN1, the product alone at the mask
site; K2c: ``mm`` of dY^T and X' and ``dy.sum(0)``, at the QKV site X' =
``F.layer_norm(x)``), never made by the port, and the bound (operations over
989 TFLOP/s or bytes over 3.35 TB/s, the larger, on the valid rows). Prints
one JSON line per process and, with ``--parent``, a table of the turns; the
card's name and power limit first.
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CHANNELS, S_PAD = [1, 3, 5, 7, 2, 7, 4, 6], 1408  # chip_smoke.NARROW_BF16
D, F, EPS = 768, 2048, 1e-5
SITES = {"qkv": (3 * D, D), "out": (D, D), "ffn1": (F, D), "ffn2": (D, F)}
# K2b's sites: dY's width K, dX's N and the epilogue's operand
DGRAD_SITES = {"ffn2": (D, F, "relu_of"), "ffn1": (F, D, "residual"), "out": (D, D, None),
               "qkv": (3 * D, D, None)}
# K1b's sites: the product's K (the out-projection's a, FFN2's hid)
RES_LN_SITES = {"out": D, "ffn2": F}
ROWS = ("k1a", "k1c", *(f"k1b_{s}{v}" for v in ("", "_save") for s in RES_LN_SITES), "k1b",
        "k1b_save", *(f"k2b_{s}" for s in DGRAD_SITES), "k2b", *(f"k2c_{s}" for s in SITES),
        "k2c")


def bf16_order():
    """This tree's tests/torch_bf16_order.py (a parent tree may lack it)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_bf16_order",
                                                  ROOT / "tests" / "torch_bf16_order.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def d192_digests(fused_block, dev) -> dict:
    """SHA-256 of the D 192 bf16 K1a and K2c outputs (``k1a_k2c``) and of the
    D 192 bf16 K1c and K2b outputs (``k1c_k2b``) on inputs drawn from seed
    201 at phase 2's hub shapes, through ``fused_block``'s wrappers."""
    import numpy as np
    import torch

    rng = np.random.default_rng(201)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    def digest(outs):
        h = hashlib.sha256()
        for t in outs:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    d, bsz, s = 192, 8, 2048
    vl = torch.tensor([1 + 196 * c for c in (1, 3, 5, 10, 2, 7, 9, 10)], dtype=torch.int32,
                      device=dev)
    x = randn(bsz, s, d).bfloat16()
    g, b = 1 + randn(d, scale=0.1), randn(d, scale=0.05)
    outs = []
    with torch.no_grad():
        outs += fused_block.ln_linear(x, g, b, EPS, randn(3 * d, d).bfloat16(),
                                      randn(3 * d).bfloat16(), vl, save=True)
        mu, rs = (t[..., 0] for t in fused_block.layernorm_stats(x, EPS))
    for n, k in ((3 * d, d), (d, d), (F, d), (d, F)):
        dy = randn(bsz, s, n).bfloat16()
        xs = x if n == 3 * d else randn(bsz, s, k).bfloat16()
        outs += fused_block.linear_wgrad(dy, xs, vl, ln=(mu, rs, g, b) if n == 3 * d else None)
    out = {"k1a_k2c": digest(outs)}
    outs = []
    with torch.no_grad():
        outs.append(fused_block.linear_relu(x, randn(F, d, scale=d ** -0.5).bfloat16(),
                                            randn(F, scale=0.1).bfloat16(), vl))
    for k, n, aux in ((d, F, "relu_of"), (F, d, "residual"), (d, d, None), (3 * d, d, None)):
        dy = randn(bsz, s, k).bfloat16()
        kw = {} if aux is None else {aux: randn(bsz, s, n).bfloat16()}
        outs.append(fused_block.linear_dgrad(dy, randn(k, n, scale=k ** -0.5).bfloat16(), vl,
                                             **kw))
    out["k1c_k2b"] = digest(outs)
    return out
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def worker(root: Path) -> dict:
    """This process's tree: the times of K1a, K1c and the K2b and K2c sites,
    and the hashes of the D 192 outputs."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import torch.nn.functional as Fn
    from torch.profiler import ProfilerActivity, profile

    from chadavit_tpu_torch.ops import _build, fused_block

    assert Path(fused_block.__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(200)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    def events(fn, iters=20, head_start=False):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if head_start:
            torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def device(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps

    def reading(fn, lib_fn, ops, nbytes):
        return {"events_ms": events(fn), "head_start_ms": events(fn, head_start=True),
                "device_ms": device(fn), "library_ms": events(lib_fn),
                "bound_ms": max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3}

    valid = [1 + 196 * c for c in CHANNELS]
    bsz, rows = len(valid), sum(valid)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    tiles = [-(-n // 32) * 32 for n in valid]
    x = randn(bsz, S_PAD, D).bfloat16()
    g, b = 1 + randn(D, scale=0.1), randn(D, scale=0.05)
    w = randn(3 * D, D, scale=D ** -0.5).bfloat16()
    bias = randn(3 * D, scale=0.02).bfloat16()
    xf = x.reshape(-1, D)
    gl, bl = g.bfloat16(), b.bfloat16()
    out = {"tree": str(root)}
    with torch.no_grad():
        out["k1a"] = reading(
            lambda: fused_block.ln_linear(x, g, b, EPS, w, bias, vl),
            lambda: torch.addmm(bias, Fn.layer_norm(xf, (D,), gl, bl, EPS), w.t()),
            2 * rows * D * 3 * D, 2 * (rows * D + 3 * D * D + 3 * D + bsz * S_PAD * 3 * D))
        mean, rstd = (t[..., 0] for t in fused_block.layernorm_stats(x, EPS))
        h = hashlib.sha256()  # K1a's qkv and stats, whose bits a redesign keeps
        for t in fused_block.ln_linear(x, g, b, EPS, w, bias, vl, save=True):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        out["k1a_sha256"] = h.hexdigest()
        x2 = randn(bsz, S_PAD, D).bfloat16()
        w1, b1 = randn(F, D, scale=D ** -0.5).bfloat16(), randn(F, scale=0.02).bfloat16()
        x2f = x2.reshape(-1, D)
        out["k1c"] = reading(
            lambda: fused_block.linear_relu(x2, w1, b1, vl),
            lambda: torch.relu(torch.addmm(b1, x2f, w1.t())),
            2 * rows * D * F, 2 * (rows * D + F * D + F + bsz * S_PAD * F))
        order = bf16_order()
        for site, k in RES_LN_SITES.items():
            a = randn(bsz, S_PAD, k).bfloat16()
            wk, bk = randn(D, k, scale=k ** -0.5).bfloat16(), randn(D, scale=0.02).bfloat16()
            res = randn(bsz, S_PAD, D).bfloat16()
            af, resf = a.reshape(-1, k), res.reshape(-1, D)
            for save in (False, True):
                out[f"k1b_{site}{'_save' * save}"] = reading(
                    (lambda a=a, wk=wk, bk=bk, res=res, sv=save: fused_block.linear_residual_ln(
                        a, wk, bk, res, g, b, EPS, vl, save=sv)),
                    (lambda af=af, wk=wk, bk=bk, resf=resf: Fn.layer_norm(
                        torch.addmm(bk, af, wk.t()) + resf, (D,), gl, bl, EPS)),
                    2 * rows * k * D,
                    2 * (rows * (k + D) + D * k + D + (1 + save) * bsz * S_PAD * D)
                    + 4 * (2 * D + 2 * save * bsz * S_PAD))
            # the LayerNorm of the kernel's own r in the order it keeps
            got = fused_block.linear_residual_ln(a, wk, bk, res, g, b, EPS, vl, save=True)
            ref = order.residual_ln_rows_order(got[3], g, b, EPS, valid)
            out[f"k1b_{site}_order"] = [bool(torch.equal(o_, r_)) for o_, r_ in zip(got, ref)]
    for site, (k, n, aux) in DGRAD_SITES.items():
        dy = randn(bsz, S_PAD, k).bfloat16()
        for i, t in enumerate(tiles):
            dy[i, t:] = 0
        wk = randn(k, n, scale=k ** -0.5).bfloat16()
        kw = {} if aux is None else {aux: randn(bsz, S_PAD, n).bfloat16()}
        dyf = dy.reshape(-1, k)
        lib = ((lambda: torch.addmm(kw["residual"].reshape(-1, n), dyf, wk))
               if aux == "residual" else (lambda: torch.mm(dyf, wk)))
        out[f"k2b_{site}"] = reading(
            lambda: fused_block.linear_dgrad(dy, wk, vl, **kw), lib,
            2 * rows * k * n, 2 * (rows * k + k * n + (aux is not None) * rows * n
                                   + bsz * S_PAD * n))
    for site, (n, k) in SITES.items():
        dy = randn(bsz, S_PAD, n).bfloat16()
        for i, t in enumerate(tiles):
            dy[i, t:] = 0
        xs = x if site == "qkv" else randn(bsz, S_PAD, k).bfloat16()
        ln = (mean, rstd, g, b) if site == "qkv" else None
        dyf, xsf = dy.reshape(-1, n), xs.reshape(-1, k)
        lib = ((lambda: (torch.mm(dyf.t(), Fn.layer_norm(xsf, (k,), gl, bl, EPS)), dyf.sum(0)))
               if ln is not None else (lambda: (torch.mm(dyf.t(), xsf), dyf.sum(0))))
        out[f"k2c_{site}"] = reading(
            lambda: fused_block.linear_wgrad(dy, xs, vl, ln=ln), lib,
            2 * rows * n * k + rows * n, 2 * rows * (n + k) + 4 * (n * k + n))
        out[f"k2c_{site}"]["library_mm_only_ms"] = events(lambda: torch.mm(dyf.t(), xsf))
    for row, sites in (("k1b", RES_LN_SITES), ("k1b_save", [f"{s}_save" for s in RES_LN_SITES]),
                       ("k2b", DGRAD_SITES), ("k2c", SITES)):
        out[row] = {key: sum(out[f"{row[:3]}_{s}"][key] for s in sites)
                    for key in ("events_ms", "head_start_ms", "device_ms", "library_ms",
                                "bound_ms")}
    out["d192_sha256"] = d192_digests(fused_block, dev)
    out["library"] = str(_build.build())
    return out


BUILDS = {"as built": [], "no_load": ["-DWGMMA_NO_LOAD"], "no_mma": ["-DWGMMA_NO_MMA"],
          "no_store": ["-DWGMMA_NO_STORE"]}


def builds() -> None:
    """This tree's wgmma kernels as built and in the diagnostic builds, each
    kernel's device time at phase 2c's shapes."""
    import ctypes

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    sys.path.insert(0, str(ROOT))
    from chadavit_tpu_torch.ops import _build, fused_block

    out_dir = _build.BUILD_DIR / "wgmma_builds"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "linear_wgmma_bf16.cu"
    procs = {name: subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o",
         str(out_dir / f"{name.replace(' ', '_')}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in BUILDS.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name.replace(' ', '_')}.so"))
        for fn in ("ln_linear_fwd_wgmma_bf16", "linear_relu_fwd_wgmma_bf16",
                   "linear_dgrad_wgmma_bf16", "linear_wgrad_wgmma_bf16"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    rng = np.random.default_rng(200)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    valid = [1 + 196 * c for c in CHANNELS]
    bsz, m = len(valid), len(valid) * S_PAD
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    x = randn(bsz, S_PAD, D).bfloat16()
    g, b = 1 + randn(D, scale=0.1), randn(D, scale=0.05)
    w, bias = randn(3 * D, D, scale=D ** -0.5).bfloat16(), randn(3 * D, scale=0.02).bfloat16()
    out, h = torch.empty(bsz, S_PAD, 3 * D, dtype=torch.bfloat16, device=dev), torch.empty_like(x)
    mean, rstd = (t[..., 0].contiguous() for t in fused_block.layernorm_stats(x, EPS))
    calls = {"k1a": lambda lib: lib.ln_linear_fwd_wgmma_bf16(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), EPS, w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None, None, h.data_ptr(), vl.data_ptr(), m, D, 3 * D, S_PAD, stream)}
    w1, b1 = randn(F, D, scale=D ** -0.5).bfloat16(), randn(F, scale=0.02).bfloat16()
    hid = torch.empty(bsz, S_PAD, F, dtype=torch.bfloat16, device=dev)
    calls["k1c"] = lambda lib: lib.linear_relu_fwd_wgmma_bf16(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), hid.data_ptr(), vl.data_ptr(), m, D, F, S_PAD,
        stream)
    keep = []
    for site, (k, n, aux) in DGRAD_SITES.items():
        dy, wk = randn(bsz, S_PAD, k).bfloat16(), randn(k, n, scale=k ** -0.5).bfloat16()
        a = None if aux is None else randn(bsz, S_PAD, n).bfloat16()
        dx = torch.empty(bsz, S_PAD, n, dtype=torch.bfloat16, device=dev)
        epilogue = {None: 0, "relu_of": 1, "residual": 2}[aux]
        keep += [dy, wk, a, dx]
        calls[f"k2b_{site}"] = (lambda lib, dy=dy, wk=wk, a=a, dx=dx, e=epilogue, k=k, n=n:
                                lib.linear_dgrad_wgmma_bf16(
            dy.data_ptr(), wk.data_ptr(), None if a is None else a.data_ptr(), dx.data_ptr(), e,
            vl.data_ptr(), m, k, n, S_PAD, stream))
    for site, (n, k) in SITES.items():
        dy = randn(bsz, S_PAD, n).bfloat16()
        xs = x if site == "qkv" else randn(bsz, S_PAD, k).bfloat16()
        tn, tk = fused_block.WGRAD_WGMMA_TILES[(n, k)]
        partial = torch.empty(fused_block.wgrad_stream_slots(n, k), tn * tk + tn, device=dev)
        dwb = torch.empty(n * k + n, device=dev)
        ln = [t.data_ptr() for t in (mean, rstd, g, b)] if site == "qkv" else [None] * 4
        keep += [dy, xs, partial, dwb]
        calls[f"k2c_{site}"] = (lambda lib, dy=dy, xs=xs, ln=ln, partial=partial, dwb=dwb, n=n,
                                k=k: lib.linear_wgrad_wgmma_bf16(
            dy.data_ptr(), xs.data_ptr(), *ln, h.data_ptr(), partial.data_ptr(),
            dwb.data_ptr(), vl.data_ptr(), m, n, k, S_PAD, fused_block.WGRAD_WGMMA_BLOCKS,
            stream))
    for name, lib in libs.items():
        cells = []
        for item, call in calls.items():
            assert call(lib) == 0, (name, item)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                call(lib)
                torch.cuda.synchronize()
                prof.step()
                for _ in range(20):
                    call(lib)
                torch.cuda.synchronize()
                prof.step()
            kernels = {re.search(r"(\w+)(?:<[^(]*>)?\(", e.key).group(1):
                       e.self_device_time_total / 1e3 / 20 for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA}
            cells.append(f"{item} " + " + ".join(f"{k_} {v:.4f}" for k_, v in kernels.items()))
        print(f"{name}: " + "; ".join(cells), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--worker", type=Path)
    ap.add_argument("--builds", action="store_true")
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    if args.builds:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        builds()
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    trees = [ROOT] if args.parent is None else [args.parent, ROOT, ROOT, args.parent]
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(tree)],
                              capture_output=True, text=True, env=dict(os.environ))
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    if args.parent is None:
        return 0
    labels = ["p1", "c1", "c2", "p2"]
    for item in ROWS:
        cells = ", ".join(f"{lab} {r[item]['events_ms']:.4f} / {r[item]['head_start_ms']:.4f} / "
                          f"{r[item]['device_ms']:.4f}" for lab, r in zip(labels, runs))
        print(f"{item} (events / after a head start / profiler, ms): {cells}; library "
              f"{runs[1][item]['library_ms']:.4f}, bound {runs[1][item]['bound_ms']:.4f}")
    from compare_sass import compare  # beside this script

    differ = compare(runs[0]["library"], runs[1]["library"])
    same = True
    for site in RES_LN_SITES:
        print(f"D 768 bf16 K1b at {site}: out, mean, rstd equal the LayerNorm order it keeps on "
              f"its own r (tests/torch_bf16_order.py): "
              + ", ".join(f"{lab} {r[f'k1b_{site}_order']}" for lab, r in zip(labels, runs)))
        same &= all(all(r[f"k1b_{site}_order"]) for r in runs)
    for key, what in (("k1a_k2c", "D 192 bf16 K1a and K2c"), ("k1c_k2b", "D 192 bf16 K1c and K2b"),
                      (None, "D 768 bf16 K1a")):
        digests = {r["k1a_sha256"] if key is None else r["d192_sha256"][key] for r in runs}
        same &= len(digests) == 1
        print(f"{what} outputs: "
              f"{'the same bits' if len(digests) == 1 else 'OTHER BITS'} in every turn "
              f"(sha256 {', '.join(sorted(digests))})")
    return 0 if same and not differ else 1


if __name__ == "__main__":
    sys.exit(main())
