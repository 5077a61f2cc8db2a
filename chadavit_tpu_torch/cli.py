"""Command-line plumbing of the entry point.

Counterpart of ``chadavit_tpu/cli.py`` (``_coerce`` :18, ``apply_overrides``
:38, ``load_cfg`` :69): the reference's hydra-style invocation
``--config-path scripts/pretrain --config-name dino_chada_vit_moyen.yaml``
plus dotted ``key=value`` overrides, and the port's ``--device`` (``cuda``
unless the caller asks for ``cpu``).
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import Any, List, Optional, Sequence

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
    return ap.parse_args(argv)


def load_cfg(args: argparse.Namespace) -> Config:
    """The named YAML config with the command line's overrides applied."""
    name = args.config_name
    if not name.endswith((".yaml", ".yml")):
        name += ".yaml"
    cfg = load_yaml(os.path.join(args.config_path, name))
    return apply_overrides(cfg, args.overrides)
