"""How far the port's bfloat16 encoder layer sits from the JAX package's, on
the inputs of ``tests/test_torch_bf16.py::test_layer_forward_matches_jax``
(full width, B 3, S 256, valid lengths 256, 130, 60).

It prints, over the valid rows: the entries of the layer output more than
3e-2 from JAX's (JAX ``fused_encoder_block`` in interpret mode against the
port's plain bfloat16 chain), the largest gap and where it is, and how many
entries of the post-attention LayerNorm output x2 differ (JAX's saved
residual against the port's). Run from the root of the repository:

    JAX_PLATFORMS=cpu python -m tests.torch_port_bf16_gap

By default XLA on the CPU may skip some of the JAX kernel's casts to
bfloat16 inside a fusion (excess precision); with
``XLA_FLAGS=--xla_allow_excess_precision=false`` it keeps them all.
"""

import jax.numpy as jnp
import numpy as np
import torch

from chadavit_tpu.ops import fused_block as jax_fused_block
from chadavit_tpu_torch.ops import fused_block
from tests import test_torch_bf16 as t


def main() -> None:
    ws = t._weights(0)  # the inputs of test_layer_forward_matches_jax
    x = t._bf16(np.random.default_rng(5).standard_normal((t.B, t.S, t.D)).astype(np.float32))
    vl = np.asarray(t.VALID, np.int32)
    (y, _, x2, _, _, _), _ = jax_fused_block._run_fwd(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(vl), tuple(t._jax_weights(ws)), t.H, t.EPS1,
        t.EPS2, 128, True, True)
    py, (_, px2, _, _, _) = fused_block.layer_forward(
        fused_block.PLAIN_STEPS, torch.from_numpy(x).bfloat16(), torch.from_numpy(vl),
        tuple(map(torch.from_numpy, ws)), t.H, t.EPS1, t.EPS2, save=True)
    y, x2 = (np.asarray(a.astype(jnp.float32)) for a in (y, x2))
    py, px2 = py.float().numpy(), px2.float().numpy()
    over, worst, x2_diff, total = 0, (0.0, None), 0, 0
    for i, n in enumerate(t.VALID):
        gap = np.abs(py[i, :n] - y[i, :n])
        over += int((gap > t.ABS_BELOW).sum())
        r, c = np.unravel_index(gap.argmax(), gap.shape)
        if gap[r, c] > worst[0]:
            worst = (float(gap[r, c]), (i, int(r), int(c), float(py[i, r, c]), float(y[i, r, c])))
        x2_diff += int((px2[i, :n] != x2[i, :n]).sum())
        total += gap.size
    print(f"layer output: {over} of {total} valid entries more than {t.ABS_BELOW} from JAX; "
          f"largest gap {worst[0]} at (sequence, row, column) {worst[1][:3]}: "
          f"port {worst[1][3]}, JAX {worst[1][4]}")
    print(f"x2: {x2_diff} of {total} valid entries differ")


if __name__ == "__main__":
    main()
