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
"""
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
