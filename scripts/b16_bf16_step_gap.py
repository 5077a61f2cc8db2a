"""The bfloat16 DINO step's distance from its plain and float32 twins, on the
card: why chip_smoke.py holds the bf16 ChAdaViT-B/16 step 1 at 2 images
against the float32 step and not at 4b's bounds. For B/16 (the root bench's
spec) at 2, 4 and 8 images x 2 crops, step 1 from the seeded init through
the attention kernels, through the attention's plain versions
(chip_smoke.plain_attention) and in float32 through the plain versions: the
loss and the per-tensor update cosines of each pair. Then ChAdaViT-moyen's
bf16 step, kernels against the plain chains, at 2 and 32 images. Run on the
card from the repository root:

    python3 scripts/b16_bf16_step_gap.py

With ``fused``, the same three steps on B/16's fused route instead (narrow
channel buckets, where the layers take the layer chain's D 768 instances):
through the kernels, through the plain chains (chip_smoke.plain_chain_backbone)
in bfloat16 and through them in float32, at 4, 8 and 32 images on buckets of
5 and 7 channels:

    python3 scripts/b16_bf16_step_gap.py fused

With ``layers``, where the fused route's bf16 step-1 loss gap comes from: for
B/16 on 7-channel buckets (seeds 6-8 at 8 images, 6 and 9 at 32), the forward
of every layer through the kernels, through the plain chains, through the
plain chains with each product's even and odd K summed apart (another f32
summation order with the same rounding points: what a correct kernel
differs from the plain chain by) and in float32, each bf16 side's distance
to the float32 layer outputs; every forward site of layers 0, 5 and 11 on
one set of inputs, each bf16 side's distance and mean signed error against
the site in float32 on the same (bf16) inputs; and the step-1 loss of the
four arms:

    python3 scripts/b16_bf16_step_gap.py layers
"""
import contextlib
import dataclasses
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from chadavit_tpu_torch import bench  # noqa: E402
from chadavit_tpu_torch.train.pretrain import (  # noqa: E402
    DinoPretrainSpec,
    build_dino,
    synthetic_dino_batch,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def run(spec, batch, plain):
    """Step 1 from the seeded init: (loss, update directions, names)."""
    if plain:
        with cs.plain_attention():
            st, step, _, _ = build_dino(spec)
            st, m = step(st, batch)
    else:
        st, step, _, _ = build_dino(spec)
        st, m = step(st, batch)
    loss = float(m["dino_loss"])
    dirs = [b.clone() for b in st.opt_state.momentum]
    names = [n for n, _ in st.trainable()]
    del st, step
    torch.cuda.empty_cache()
    return loss, dirs, names


def cos_stats(a, b, names):
    """The worst and the median per-tensor cosine of two runs' updates."""
    cs_ = []
    for n, x, y in zip(names, a, b):
        x, y = x.double().flatten(), y.double().flatten()
        if x.any() and y.any():
            cs_.append((torch.nn.functional.cosine_similarity(x, y, 0).item(), n))
    cs_.sort()
    return f"worst 1-{1-cs_[0][0]:.2e} ({cs_[0][1]}), median 1-{1-cs_[len(cs_)//2][0]:.2e}"


@contextlib.contextmanager
def split_order():
    """Within it the plain chains' bf16 products sum K's even and odd
    columns apart, each in float32, then add: another summation order, the
    same rounding points."""
    from chadavit_tpu_torch.ops import fused_block as fb

    def mm(a, w):
        if a.dtype == torch.float32:
            return torch.matmul(a, w.t())
        af, wf = a.float(), w.float()
        return (torch.matmul(af[..., 0::2], wf[:, 0::2].t())
                + torch.matmul(af[..., 1::2], wf[:, 1::2].t())).to(a.dtype)

    real, fb._mm = fb._mm, mm
    try:
        yield
    finally:
        fb._mm = real


def rel(a, f, ok):
    """Relative L2 distance of a from f over the rows ``ok`` (a bool mask of
    a's leading dims), and the mean signed error over them in units of f's
    RMS."""
    a, f = a.double()[ok], f.double()[ok]
    rms = f.square().mean().sqrt()
    return ((a - f).norm() / f.norm()).item(), ((a - f).mean() / rms).item()


def sites(fb, fa, blk_b, x_b, vl, ok):
    """Each forward site of one layer on the same bf16 inputs (the plain
    chain's), through the kernels, the plain versions and the split-order
    plain versions, each against the site in float32 on those inputs
    upcast, the weights rounded to bf16 and upcast."""
    eps, nh = blk_b.layer_norm_eps, blk_b.num_heads
    wb = fb.pack_weights(blk_b.weights(), torch.bfloat16)
    wf = tuple(t.float() for t in wb)
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = wb
    d = x_b.shape[2]
    with torch.no_grad():
        qkv = fb.ln_linear_reference(x_b, g1, b1, eps, wqkv, bqkv, vl)
        a = fa.prefix_flash_attention_reference(qkv[..., :d], qkv[..., d:2 * d],
                                                qkv[..., 2 * d:], vl, nh)
        x2 = fb.linear_residual_ln_reference(a, wout, bout, x_b, g1, b1, eps, vl)
        hid = fb.linear_relu_reference(x2, w1, b1f, vl)
    calls = {
        "ln_linear (LN1 + QKV)": lambda st, w, cast: st.ln_linear(
            cast(x_b), w[4], w[5], eps, w[0], w[1], vl),
        "attention": lambda st, w, cast: st.attention(
            cast(qkv[..., :d]), cast(qkv[..., d:2 * d]), cast(qkv[..., 2 * d:]), vl, nh,
            False)[0],
        "linear_residual_ln (out projection)": lambda st, w, cast: st.linear_residual_ln(
            cast(a), w[2], w[3], cast(x_b), w[4], w[5], eps, vl),
        "linear_relu (FFN1)": lambda st, w, cast: st.linear_relu(cast(x2), w[8], w[9], vl),
        "linear_residual_ln (FFN2)": lambda st, w, cast: st.linear_residual_ln(
            cast(hid), w[10], w[11], cast(x2), w[6], w[7], eps, vl),
    }
    out = []
    for name, call in calls.items():
        with torch.no_grad():
            f = call(fb.PLAIN_STEPS, wf, lambda t: t.float())
            k = call(fb.KERNEL_STEPS, wb, lambda t: t)
            p = call(fb.PLAIN_STEPS, wb, lambda t: t)
            with split_order():
                o = call(fb.PLAIN_STEPS, wb, lambda t: t)
        (dk, mk), (dp, mp), (do, mo) = (rel(t, f, ok) for t in (k, p, o))
        out.append(f"      {name}: to f32 kernels {dk:.4e} (mean {mk:+.2e}), plain {dp:.4e} "
                   f"(mean {mp:+.2e}), split order {do:.4e} (mean {mo:+.2e}); "
                   f"kernels/plain {dk / dp:.4f}; entries differing from plain: kernels "
                   f"{int((k != p)[ok].sum())}, split order "
                   f"{int((o != p)[ok].sum())} of {int(ok.sum()) * f.shape[-1]}")
    return out


def layers_mode():
    import torch.nn.functional as F

    from chadavit_tpu_torch.ops import flash_attention as fa
    from chadavit_tpu_torch.ops import fused_block as fb

    def run_step(spec, batch, arm):
        ctx = split_order() if arm == "split" else contextlib.nullcontext()
        with ctx:
            st, step, _, _ = build_dino(spec, backbone_apply=None if arm == "kernel"
                                        else cs.plain_chain_backbone)
            st, m = step(st, batch)
        loss = float(m["dino_loss"])
        del st, step
        torch.cuda.empty_cache()
        return loss

    for nb, seed in ((8, 6), (8, 7), (8, 8), (32, 6), (32, 9)):
        counts = [7, 7, 6, 7, 5, 7, 7, 3] if (nb, seed) == (8, 6) else \
            [7 - i % 4 for i in range(nb)]
        specb = dataclasses.replace(bench.b16_spec(torch.bfloat16), max_channels=7)
        specf = dataclasses.replace(bench.b16_spec(torch.float32), max_channels=7)
        bb = synthetic_dino_batch(specb, nb, seed=seed, channel_counts=counts)
        bf = synthetic_dino_batch(specf, nb, seed=seed, channel_counts=counts)
        # the forward, layer by layer, of the student's backbone on crop 0
        _, _, mb, _ = build_dino(specb)
        _, _, mf, _ = build_dino(specf)
        cc = bb["channel_counts"]
        with torch.no_grad():
            eb, _ = mb.tokenize(bb["crops"][0], cc)
            ef, _ = mf.tokenize(bf["crops"][0], cc)
        s = eb.shape[1]
        s_pad = -(-s // fb.SEQ_PAD) * fb.SEQ_PAD
        eb, ef = (F.pad(t, (0, 0, 0, s_pad - s)) for t in (eb, ef))
        vl = (1 + cc.to(torch.int32) * mb.num_patches).to(torch.int32)
        ok = torch.arange(s_pad, device=eb.device)[None, :] < vl[:, None]
        xs = {"kernels": eb, "plain": eb, "split order": eb, "f32": ef}
        print(f"B {nb}, 7-channel bucket {counts}, seed {seed}: the student backbone's "
              f"layers on crop 0 (S_pad {s_pad}), distance to the float32 chain "
              f"(relative L2 over valid rows, mean signed error in RMS units)", flush=True)
        for i, (bk, bf32) in enumerate(zip(mb.blocks, mf.blocks)):
            eps, nh = bk.layer_norm_eps, bk.num_heads
            if i in (0, 5, 11):
                print(f"   layer {i}, its sites on the plain chain's input:", flush=True)
                for line in sites(fb, fa, bk, xs["plain"], vl, ok):
                    print(line, flush=True)
            with torch.no_grad():
                for arm, steps in (("kernels", fb.KERNEL_STEPS), ("plain", fb.PLAIN_STEPS),
                                   ("split order", fb.PLAIN_STEPS)):
                    ctx = split_order() if arm == "split order" else contextlib.nullcontext()
                    with ctx:
                        xs[arm] = fb.layer_forward(steps, xs[arm], vl, bk.weights(), nh, eps,
                                                   eps, save=False)
                xs["f32"] = fb.layer_forward(fb.PLAIN_STEPS, xs["f32"], vl, bf32.weights(),
                                             nh, eps, eps, save=False)
            (dk, mk), (dp, mp), (do, mo) = (rel(xs[a], xs["f32"], ok)
                                            for a in ("kernels", "plain", "split order"))
            print(f"   after layer {i:2d}: kernels {dk:.4e} (mean {mk:+.2e}), plain {dp:.4e} "
                  f"(mean {mp:+.2e}), split order {do:.4e} (mean {mo:+.2e}); kernels/plain "
                  f"{dk / dp:.4f}, split/plain {do / dp:.4f}; kernels to plain "
                  f"{rel(xs['kernels'], xs['plain'], ok)[0]:.4e}, split order to plain "
                  f"{rel(xs['split order'], xs['plain'], ok)[0]:.4e}", flush=True)
        with torch.no_grad():
            cls = {a: mb.final_norm(xs[a])[:, 0] for a in ("kernels", "plain", "split order")}
            cf = mf.final_norm(xs["f32"])[:, 0]
        c_ok = torch.ones(nb, dtype=torch.bool, device=cf.device)
        print("   CLS: " + ", ".join(f"{a} {rel(c, cf, c_ok)[0]:.4e}" for a, c in cls.items()),
              flush=True)
        del mb, mf, xs, cls
        torch.cuda.empty_cache()
        # step 1's loss, four arms
        lk = run_step(specb, bb, "kernel")
        lp = run_step(specb, bb, "plain")
        lo = run_step(specb, bb, "split")
        lf = run_step(specf, bf, "plain")
        print(f"   step 1 loss: kernels {lk:.6f} plain {lp:.6f} split order {lo:.6f} f32 "
              f"{lf:.6f}; to plain: kernels {abs(lk / lp - 1):.2e}, split order "
              f"{abs(lo / lp - 1):.2e}; to f32: kernels {abs(lk / lf - 1):.2e}, plain "
              f"{abs(lp / lf - 1):.2e}, split order {abs(lo / lf - 1):.2e}", flush=True)


if sys.argv[1:] == ["layers"]:
    layers_mode()
    sys.exit(0)

if sys.argv[1:] == ["fused"]:
    # B/16 on narrow buckets (the layer chain): kernels, plain chains (bf16),
    # plain chains (f32), step 1 from the seeded init on the same batch
    def run_chain(spec, batch, plain):
        st, step, _, _ = build_dino(spec, backbone_apply=cs.plain_chain_backbone if plain
                                    else None)
        st, m = step(st, batch)
        out = (float(m["dino_loss"]), [b.clone() for b in st.opt_state.momentum],
               [n for n, _ in st.trainable()])
        del st, step
        torch.cuda.empty_cache()
        return out

    for nb, width, counts, seed in (
            (8, 7, [7, 7, 6, 7, 5, 7, 7, 3], 6), (8, 7, [7] * 8, 7), (8, 7, [7] * 8, 8),
            (4, 7, [7, 6, 7, 7], 6), (8, 5, [5, 5, 4, 5, 5, 3, 5, 5], 6),
            (32, 7, [7 - i % 4 for i in range(32)], 6)):
        specb = dataclasses.replace(bench.b16_spec(torch.bfloat16), max_channels=width)
        specf = dataclasses.replace(bench.b16_spec(torch.float32), max_channels=width)
        bb = synthetic_dino_batch(specb, nb, seed=seed, channel_counts=counts)
        bf = synthetic_dino_batch(specf, nb, seed=seed, channel_counts=counts)
        lk, dk, names = run_chain(specb, bb, False)
        lp, dp, _ = run_chain(specb, bb, True)
        lf, df, _ = run_chain(specf, bf, True)
        print(f"fused route, B {nb}, {width}-channel bucket {counts}, seed {seed}: loss kernel "
              f"{lk:.6f} plain {lp:.6f} f32 {lf:.6f}; kernel-plain rel {abs(lk/lp-1):.2e}, "
              f"kernel-f32 {abs(lk/lf-1):.2e}, plain-f32 {abs(lp/lf-1):.2e}", flush=True)
        print(f"   updates kernel vs plain: {cos_stats(dk, dp, names)}", flush=True)
        print(f"   updates kernel vs f32:   {cos_stats(dk, df, names)}", flush=True)
        print(f"   updates plain vs f32:    {cos_stats(dp, df, names)}", flush=True)
    sys.exit(0)

for nb, counts, seed in ((2, [10, 6], 6), (2, [10, 10], 7), (4, [10, 6, 8, 9], 6),
                         (8, [10, 6, 8, 9, 10, 7, 9, 10], 6)):
    specb = bench.b16_spec(torch.bfloat16)
    specf = bench.b16_spec(torch.float32)
    bb = synthetic_dino_batch(specb, nb, seed=seed, channel_counts=counts)
    bf = synthetic_dino_batch(specf, nb, seed=seed, channel_counts=counts)
    lk, dk, names = run(specb, bb, False)
    lp, dp, _ = run(specb, bb, True)
    lf, df, _ = run(specf, bf, True)
    print(f"B {nb} counts {counts} seed {seed}: loss kernel {lk:.6f} plain {lp:.6f} "
          f"f32 {lf:.6f}; kernel-plain rel {abs(lk/lp-1):.2e}, kernel-f32 "
          f"{abs(lk/lf-1):.2e}, plain-f32 {abs(lp/lf-1):.2e}", flush=True)
    print(f"   updates kernel vs plain: {cos_stats(dk, dp, names)}", flush=True)
    print(f"   updates kernel vs f32:   {cos_stats(dk, df, names)}", flush=True)
    print(f"   updates plain vs f32:    {cos_stats(dp, df, names)}", flush=True)
# moyen bf16 at 2 images: kernels vs plain chains, the same comparison 4b makes at 32
for nb in (2, 32):
    spec = DinoPretrainSpec(dtype=torch.bfloat16)
    b = synthetic_dino_batch(spec, nb, seed=4)
    st, step, _, _ = build_dino(spec)
    st, m = step(st, b)
    lk = float(m["dino_loss"])
    dk = [x.clone() for x in st.opt_state.momentum]
    names = [n for n, _ in st.trainable()]
    ps, pstep, _, _ = build_dino(spec, backbone_apply=cs.plain_chain_backbone)
    ps, pm = pstep(ps, b)
    lp = float(pm["dino_loss"])
    print(f"moyen bf16 B {nb}: kernel-plain chains loss rel {abs(lk/lp-1):.2e}; updates "
          f"{cos_stats(dk, ps.opt_state.momentum, names)}", flush=True)
    del st, step, ps, pstep
    torch.cuda.empty_cache()
