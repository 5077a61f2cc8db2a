"""The port's ChAdaViT with ``ln_impl="pallas"`` held against the JAX model
with the same ``ln_impl`` on the CPU, forward and gradients, in float32 and
bfloat16, on a small model: img 32, patch 16, D 32, depth 2, heads 2, FFN
64, up to 4 channels. One state dict drives both, through the JAX package's
own ``chada_vit_params_from_torch``; the JAX gradients come back under the
port's names through ``state_dict_from_jax_params``.

The JAX model calls its LayerNorm without ``interpret`` (``chada_vit.py:233,
365``), so the Pallas kernels would not run off a TPU: each test patches
``chadavit_tpu.models.chada_vit.layernorm`` with the interpreted one, inside
the test only.

Two paths:
- ``block_impl="auto"``: the port's fused layer (its chain of kernel plain
  versions on the CPU) with the LayerNorm kernel path in the final norm only,
  against the JAX fused Pallas layer (``block_impl="fused"``, interpreted),
  whose final norm is ``fused_layernorm``;
- ``block_impl="xla"``: the unfused layer, its three LayerNorms and the final
  norm all through the LayerNorm kernel path, against the JAX unfused layer
  with the Pallas LayerNorm.

The loss is ``sum((cls - t)^2)`` (not LN-invariant).

In bfloat16 the JAX side runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``: by default XLA on the CPU
skips the JAX kernels' casts to bfloat16 inside its fusions (the rounding of
x + r, of dx, of the LN output), and on this tiny model the ReLU masks that
such roundings flip move whole gradient rows (read: blocks.1.linear1 at a
cosine of 0.991 and 33 % of its largest entry with the default flags, against
1 - 1.1e-4 and 2.4 % with the casts kept; the forward of the fused path is then
bit for bit the JAX one).

Tolerances, a few times the worst reading on this data: float32 outputs 5e-6
absolute (read 1.4e-6), gradients 2e-6 of each tensor's largest entry (read
5.7e-7); bfloat16 outputs within 3e-2 or two bfloat16 steps at each entry's
magnitude (read 2.3e-2), gradients (float32) within 8e-2 of each tensor's
largest entry (read 2.4e-2) and a per-tensor cosine of at least 1 - 4e-4
(read 1 - 1.1e-4).
"""

import functools
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chadavit_tpu.models.chada_vit import ChAdaViT as JaxChAdaViT
from chadavit_tpu.models.import_torch import chada_vit_params_from_torch
from chadavit_tpu.ops.layernorm import layernorm as jax_layernorm
from chadavit_tpu_torch.models.chada_vit import ChAdaViT, chada_vit, random_state_dict
from chadavit_tpu_torch.models.import_torch import state_dict_from_jax_params

CFG = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
           ffn_dim=64, max_channels=4)
COUNTS = np.asarray([4, 1, 2, 3], np.int32)
F32_ABS, F32_GRAD_REL = 5e-6, 2e-6
BF16_ABS, BF16_STEPS, BF16_GRAD_REL, BF16_GRAD_COS = 3e-2, 2, 8e-2, 1 - 4e-4
FWD_SEED, GRAD_SEED = 20, 30
ROOT = Path(__file__).resolve().parent.parent
JAX_BLOCK = {"auto": "fused", "xla": "xla"}
# the module, not the factory of the same name that chadavit_tpu.models exports
jax_chada = importlib.import_module("chadavit_tpu.models.chada_vit")


@pytest.fixture
def interpreted_ln(monkeypatch):
    monkeypatch.setattr(jax_chada, "layernorm", functools.partial(jax_layernorm,
                                                                  interpret=True))


def write_bf16_refs(path):
    """The JAX side of every bfloat16 case into ``path`` (npz); run in a
    process with ``--xla_allow_excess_precision=false``."""
    jax_chada.layernorm = functools.partial(jax_layernorm, interpret=True)
    out = {}
    for block_impl in JAX_BLOCK:
        _, jm, params, x, _ = _case(block_impl, "bfloat16", FWD_SEED)
        out[f"{block_impl}/cls"] = np.asarray(
            jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(COUNTS))
            .astype(jnp.float32))
        _, jm, params, x, t = _case(block_impl, "bfloat16", GRAD_SEED)
        for name, g in _jax_run(jm, params, x, t)[1].items():
            out[f"{block_impl}/grad/{name}"] = g
    np.savez(path, **out)


@pytest.fixture(scope="module")
def bf16_refs(tmp_path_factory):
    path = tmp_path_factory.mktemp("ln_model") / "refs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    code = f"import tests.test_torch_ln_model as t; t.write_bf16_refs({str(path)!r})"
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _bf16_step(a):
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _case(block_impl, dtype, seed):
    m = ChAdaViT(return_all_tokens=False, block_impl=block_impl, ln_impl="pallas",
                 dtype=getattr(torch, dtype), **CFG)
    m.load_state_dict(random_state_dict(m, seed))
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray,
                                    chada_vit_params_from_torch(sd, depth=CFG["depth"]))
    jm = JaxChAdaViT(return_all_tokens=False, block_impl=JAX_BLOCK[block_impl],
                     attn_impl="xla", ln_impl="pallas", dtype=getattr(jnp, dtype), **CFG)
    rng = np.random.default_rng(seed + 1)
    x = rng.random((len(COUNTS), 4, 32, 32), dtype=np.float32)
    for i, c in enumerate(COUNTS):
        x[i, c:] = 0
    t = rng.standard_normal((len(COUNTS), CFG["embed_dim"])).astype(np.float32)
    return m, jm, params, x, t


def _jax_run(jm, params, x, t):
    def loss(p):
        cls = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(COUNTS))
        return jnp.sum((cls.astype(jnp.float32) - jnp.asarray(t)) ** 2), cls

    (_, cls), grads = jax.value_and_grad(loss, has_aux=True)(params)
    grads = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    return np.asarray(cls.astype(jnp.float32)), {k: v.numpy() for k, v in grads.items()}


def _port_run(m, x, t):
    cls = m(torch.from_numpy(x), torch.from_numpy(COUNTS))
    loss = ((cls.float() - torch.from_numpy(t)) ** 2).sum()
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in m.named_parameters()])
    assert all(g.dtype == torch.float32 for g in grads)
    return cls.float().detach().numpy(), dict(zip(names, (g.numpy() for g in grads)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_impl", ["auto", "xla"])
def test_forward_matches_jax(interpreted_ln, bf16_refs, block_impl, dtype):
    m, jm, params, x, _ = _case(block_impl, dtype, FWD_SEED)
    if dtype == "float32":
        ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(COUNTS)))
    else:
        ref = bf16_refs[f"{block_impl}/cls"]
    with torch.no_grad():
        out = m(torch.from_numpy(x), torch.from_numpy(COUNTS))
    assert out.dtype == getattr(torch, dtype)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=F32_ABS)
    else:
        tol = np.maximum(BF16_ABS, BF16_STEPS * _bf16_step(ref))
        assert np.all(np.abs(out - ref) <= tol), np.abs(out - ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_impl", ["auto", "xla"])
def test_gradients_match_jax(interpreted_ln, bf16_refs, block_impl, dtype):
    m, jm, params, x, t = _case(block_impl, dtype, GRAD_SEED)
    if dtype == "float32":
        ref = _jax_run(jm, params, x, t)[1]
    else:
        prefix = f"{block_impl}/grad/"
        ref = {k[len(prefix):]: v for k, v in bf16_refs.items() if k.startswith(prefix)}
    _, got = _port_run(m, x, t)
    assert set(got) == set(ref)
    for name in sorted(got):
        g, r = got[name].reshape(-1), ref[name].reshape(-1)
        scale = np.abs(r).max()
        if dtype == "float32":
            assert np.abs(g - r).max() <= F32_GRAD_REL * scale, (name, np.abs(g - r).max())
        else:
            cos = float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r) + 1e-30))
            assert np.abs(g - r).max() <= BF16_GRAD_REL * scale and cos >= BF16_GRAD_COS, \
                (name, np.abs(g - r).max() / scale, cos)


def test_final_norm_and_unfused_layers_take_the_kernel_path():
    # on the fused path only the final norm changes; with block_impl="xla"
    # each layer's three LayerNorms do too (FusedLayerNorm[Residual] in the graph)
    for block_impl, want in (("auto", 1), ("xla", 1 + 3 * CFG["depth"])):
        m = chada_vit(patch_size=16, embed_dim=32, depth=CFG["depth"], num_heads=2,
                      max_number_channels=4, img_size=32, return_all_tokens=False,
                      block_impl=block_impl, ln_impl="pallas")
        seen = []

        def walk(fn):
            if fn is None or fn in seen:
                return
            seen.append(fn)
            for nxt, _ in fn.next_functions:
                walk(nxt)

        x = torch.rand(2, 4, 32, 32)
        walk(m(x, torch.tensor([4, 2], dtype=torch.int32)).sum().grad_fn)
        names = [type(f).__name__ for f in seen]
        assert sum(n.startswith("FusedLayerNorm") for n in names) == want, names
