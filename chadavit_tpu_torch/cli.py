"""Command-line plumbing of the entry points.

Counterpart of ``chadavit_tpu/cli.py`` (``_coerce`` :18, ``apply_overrides``
:38, ``load_cfg`` :69, ``load_backbone_for_eval`` :83): the reference's
hydra-style invocation ``--config-path scripts/pretrain --config-name
dino_chada_vit_moyen.yaml`` plus dotted ``key=value`` overrides, the port's
``--device`` (``cuda`` unless the caller asks for ``cpu``), and the backbone
of the evaluation entry points.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
from typing import Any, List, Optional, Sequence

import torch

from chadavit_tpu_torch.config import Config, load_yaml


def _coerce(v: str) -> Any:
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v == "null" or v == "None":
        return None
    if v.startswith("[") or v.startswith("{"):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
    return v


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    for ov in overrides:
        if "=" not in ov:
            raise SystemExit(f"override {ov!r} must be key=value")
        key, val = ov.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = _coerce(val)
    return cfg


def parse_args(argv: Optional[List[str]] = None, description: str = "") -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--config-path", default=".", help="directory containing the config")
    ap.add_argument("--config-name", required=True, help="config yaml name")
    ap.add_argument("--device", default=None,
                    help="torch device to run on; default cuda (raises without a GPU)")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    # options may come after overrides (``key=value --device cpu``)
    return ap.parse_intermixed_args(argv)


def load_cfg(args: argparse.Namespace) -> Config:
    """The named YAML config with the command line's overrides applied."""
    name = args.config_name
    if not name.endswith((".yaml", ".yml")):
        name += ".yaml"
    cfg = load_yaml(os.path.join(args.config_path, name))
    return apply_overrides(cfg, args.overrides)


def load_backbone_for_eval(cfg: Config, device=None):
    """The backbone of an evaluation entry point, with its weights, in eval
    mode on ``device`` (``None`` means ``cuda``, and raises without a GPU)
    (reference ``main_knn.py:181-196`` / ``main_linear.py:76-129``).

    ``pretrained_feature_extractor`` (or ``weights_init``) may be:

    - a checkpoint directory of the port's pretrain loop: the student's
      backbone from its ``state.pt`` (the reference's ``model.backbone``);
      the run's ``args.json`` beside it rebuilds the architecture, the eval
      YAML's ``backbone.kwargs`` only filling gaps (reference
      ``main_knn.py:181-196``);
    - a ``.npz`` of the JAX package's flat ``a/b/c``-keyed backbone params
      (``tools/export_study_ckpt.py``), through
      :func:`state_dict_from_jax_params`;
    - a torch ``.ckpt`` / ``.pt`` (Lightning or bare state dict), through the
      ``encoder -> backbone -> strip`` remap;
    - ``random-weights``, or no value: the port's seeded weights
      (:func:`random_state_dict`, seed 0).

    Any other path that does not exist raises ``FileNotFoundError`` (the JAX
    package falls back to random weights there; a mistyped path must not
    give a table of random-weight accuracies).

    The model computes in float32, as the JAX eval path builds it (no
    ``dtype``). Only ChAdaViT (``vit_channels`` / ``chada_vit``) is ported."""
    from chadavit_tpu_torch.models.chada_vit import chada_vit, random_state_dict
    from chadavit_tpu_torch.models.import_torch import (
        import_backbone_checkpoint, load_jax_npz, state_dict_from_jax_params)
    from chadavit_tpu_torch.utils.checkpoint import STATE_FILE
    from chadavit_tpu_torch.utils.misc import resolve_device

    dev = resolve_device(device)
    ckpt = cfg.get("pretrained_feature_extractor") or cfg.get("weights_init")
    ckpt = str(ckpt) if ckpt and ckpt != "random-weights" else None
    if ckpt and not os.path.exists(ckpt):
        raise FileNotFoundError(
            f"pretrained_feature_extractor={ckpt!r} does not exist "
            "(random-weights asks for the seeded random weights)")
    if ckpt and os.path.isdir(ckpt):
        sidecar = os.path.join(os.path.dirname(ckpt.rstrip("/")), "args.json")
        if os.path.isfile(sidecar):
            with open(sidecar) as f:
                saved_bk = json.load(f).get("backbone", {})
            if saved_bk.get("name"):
                cfg.backbone.name = saved_bk["name"]
                merged = dict(cfg.backbone.get("kwargs", {}))
                merged.update(saved_bk.get("kwargs", {}))
                cfg.backbone.kwargs = merged

    if cfg.backbone.name not in ("vit_channels", "chada_vit"):
        raise NotImplementedError(
            f"backbone.name={cfg.backbone.name!r}: only ChAdaViT (vit_channels) is ported; "
            "the plain ViT needs models/vit.py")
    model = chada_vit(**dict(cfg.backbone.get("kwargs", {})))

    if ckpt and os.path.isdir(ckpt):
        state_file = os.path.join(ckpt, STATE_FILE)
        if not os.path.isfile(state_file):
            raise FileNotFoundError(
                f"{ckpt}: not a checkpoint of the port (no {STATE_FILE}); the JAX "
                "package's orbax checkpoints do not load here, export them to .npz")
        tree = torch.load(state_file, map_location="cpu", weights_only=True)
        for key in ("student", "backbone"):  # a DINO state, or a probe's
            if key in tree:
                tree = tree[key]
        sd = tree
    elif ckpt:
        sd = (state_dict_from_jax_params(load_jax_npz(ckpt)) if ckpt.endswith(".npz")
              else import_backbone_checkpoint(ckpt))
    else:
        sd = random_state_dict(model, 0)
    model.load_state_dict(sd)
    return model.to(dev).eval()
