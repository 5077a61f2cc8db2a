"""Checkpoint loading for the port, and the JAX-params bridges.

Counterpart of ``chadavit_tpu/models/import_torch.py`` (``_np``,
``load_torch_state_dict``, ``remap_backbone_keys`` :26-57,
``import_backbone_checkpoint`` :150). The port's parameters already have the
reference torch layout, so importing is the ``encoder -> backbone -> strip``
key remap alone. :func:`state_dict_from_jax_params` goes the other way from
the JAX importer ``chada_vit_params_from_torch`` (:59): flax params (nested
numpy) to the port's state dict; :func:`head_state_dict_from_jax_params` does
the same for the DINO head (inverse of ``dino_head_params_from_torch`` :123),
:func:`linear_state_dict_from_jax_params` for a flax ``nn.Dense`` (the
probes' classifier). :func:`load_jax_npz` reads the JAX package's compact
backbone export (a ``.npz`` of flat ``a/b/c`` keys, as
``chadavit_tpu/cli.py:145-159`` reads it) into nested numpy params.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A Lightning checkpoint (``{"state_dict": ...}``) or a plain state dict,
    as a flat dict of CPU tensors."""
    # Lightning checkpoints carry non-tensor objects, hence weights_only=False:
    # load only checkpoints from a trusted source
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: torch.as_tensor(_np(v)) for k, v in sd.items()}


def remap_backbone_keys(sd: Mapping[str, Any], prefix: str = "backbone."
                        ) -> Dict[str, torch.Tensor]:
    """Apply the ``encoder -> backbone -> strip`` remap contract."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        k = k.replace("encoder", "backbone") if k.startswith("encoder") else k
        if k.startswith(prefix):
            out[k[len(prefix):]] = torch.as_tensor(_np(v))
    if not out:  # the checkpoint was already a bare backbone state dict
        out = {k: torch.as_tensor(_np(v)) for k, v in sd.items()}
    return out


def import_backbone_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a Lightning or bare checkpoint and remap it to a bare ChAdaViT
    state dict for :class:`chadavit_tpu_torch.models.chada_vit.ChAdaViT`."""
    return remap_backbone_keys(load_torch_state_dict(path))


def load_jax_npz(path: str) -> Dict[str, Any]:
    """A ``.npz`` of flat ``a/b/c``-keyed JAX params -> the nested params
    tree (numpy arrays)."""
    params: Dict[str, Any] = {}
    with np.load(path) as z:
        for flat_key in z.files:
            node = params
            *parents, leaf = flat_key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(z[flat_key])
    return params


def state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params of the JAX ``ChAdaViT`` -> the port's state dict (the
    inverse of the JAX package's ``chada_vit_params_from_torch``)."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(_np(a), dtype=np.float32))

    kernel = _np(params["patch_embed"]["kernel"])  # (p*p, D)
    p = int(round(np.sqrt(kernel.shape[0])))
    d = kernel.shape[1]
    sd = {
        "cls_token": t(params["cls_token"]),
        "channel_token": t(params["channel_token"]),
        "pos_embed": t(params["pos_embed"]),
        "token_learner.proj.weight": t(kernel.T.reshape(d, 1, p, p)),
        "token_learner.proj.bias": t(params["patch_embed"]["bias"]),
        "norm.weight": t(params["norm"]["scale"]),
        "norm.bias": t(params["norm"]["bias"]),
    }
    depth = sum(1 for k in params if k.startswith("blocks_"))
    for i in range(depth):
        blk = params[f"blocks_{i}"]
        pre = f"blocks.{i}."
        sd[pre + "self_attn.in_proj_weight"] = t(_np(blk["in_proj_kernel"]).T)
        sd[pre + "self_attn.in_proj_bias"] = t(blk["in_proj_bias"])
        sd[pre + "self_attn.out_proj.weight"] = t(_np(blk["out_proj_kernel"]).T)
        sd[pre + "self_attn.out_proj.bias"] = t(blk["out_proj_bias"])
        for lin in ("linear1", "linear2"):
            sd[pre + lin + ".weight"] = t(_np(blk[lin]["kernel"]).T)
            sd[pre + lin + ".bias"] = t(blk[lin]["bias"])
        for nrm in ("norm1", "norm2"):
            sd[pre + nrm + ".weight"] = t(blk[nrm]["scale"])
            sd[pre + nrm + ".bias"] = t(blk[nrm]["bias"])
    return sd


def head_state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params of the JAX ``DINOHead`` -> the port's head state dict (the
    inverse of the JAX package's ``dino_head_params_from_torch``, :123): the
    kernels ``mlp_j`` ``(in, out)`` become ``mlp.{2 j}.weight`` ``(out, in)``
    (``mlp.weight`` for a one-layer head), ``last_layer_v`` ``(bottleneck, P)``
    becomes ``last_layer.weight_v`` ``(P, bottleneck)`` and ``last_layer_g``
    ``(P,)`` becomes ``last_layer.weight_g`` ``(P, 1)``."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(_np(a), dtype=np.float32))

    n = sum(1 for k in params if k.startswith("mlp_"))
    sd: Dict[str, torch.Tensor] = {}
    for j in range(n):
        pre = "mlp." if n == 1 else f"mlp.{2 * j}."
        sd[pre + "weight"] = t(_np(params[f"mlp_{j}"]["kernel"]).T)
        sd[pre + "bias"] = t(params[f"mlp_{j}"]["bias"])
    sd["last_layer.weight_v"] = t(_np(params["last_layer_v"]).T)
    sd["last_layer.weight_g"] = t(_np(params["last_layer_g"]).reshape(-1, 1))
    return sd


def linear_state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``nn.Dense`` params (``kernel`` ``(in, out)``, ``bias``) -> the
    state dict of ``torch.nn.Linear`` (``weight`` ``(out, in)``, ``bias``)."""
    return {"weight": torch.from_numpy(np.array(_np(params["kernel"]).T, dtype=np.float32)),
            "bias": torch.from_numpy(np.array(_np(params["bias"]), dtype=np.float32))}
