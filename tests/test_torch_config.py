"""The port's config path (``chadavit_tpu_torch/config.py``, ``cli.py`` and
``train/loop.py::spec_from_cfg``) held against the JAX package's on the CPU:
``load_yaml`` and ``parse_pretrain_cfg`` on every YAML under
``scripts/pretrain`` and ``scripts/smoke`` (equal dicts, or the same
exception where the JAX parse raises), ``apply_overrides`` and ``_coerce``
on the override forms, and ``spec_from_cfg`` field by field (the JAX
``jnp.bfloat16`` / ``jnp.float32`` against the port's torch dtypes).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from chadavit_tpu import cli as jax_cli
from chadavit_tpu import config as jax_config
from chadavit_tpu.train.loop import spec_from_cfg as jax_spec_from_cfg
from chadavit_tpu_torch import cli, config
from chadavit_tpu_torch.train.loop import spec_from_cfg

ROOT = Path(__file__).resolve().parent.parent
YAMLS = sorted((ROOT / "scripts" / "pretrain").rglob("*.yaml")) + sorted(
    (ROOT / "scripts" / "smoke").rglob("*.yaml"))
OVERRIDES = ["max_steps=3", "data.size=32", "optimizer.lr=0.5", "backbone.kwargs.depth=1",
             "backbone.kwargs.ln_impl=pallas", "checkpoint.enabled=true", "seed=None",
             "devices=[0]", "precision=f32", "data.dataset=synthetic", "name=x=y",
             "optimizer.kwargs={'eta': 0.01}", "new.nested.key=1e-4"]


def _both(fn_jax, fn_port):
    """(JAX result, port result), or the exception type each raised."""
    out = []
    for fn in (fn_jax, fn_port):
        try:
            out.append(fn())
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            out.append(type(e))
    return out


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: str(p.relative_to(ROOT)))
def test_load_and_parse_match_jax(path):
    ref, got = _both(lambda: jax_config.load_yaml(str(path)),
                     lambda: config.load_yaml(str(path)))
    if isinstance(ref, type):
        assert got is ref
        return
    assert isinstance(got, config.Config) and got.to_dict() == ref.to_dict()
    ref, got = _both(lambda: jax_config.parse_pretrain_cfg(ref),
                     lambda: config.parse_pretrain_cfg(got))
    if isinstance(ref, type):
        assert got is ref
    else:
        assert got.to_dict() == ref.to_dict()
        assert got.to_json() == ref.to_json()


@pytest.mark.parametrize("value", ["3", "1e-4", "0.5", "true", "False", "null", "None",
                                   "[1, 2]", "{'a': 1}", "[oops", "pallas", "x=y"])
def test_coerce_matches_jax(value):
    ref, got = jax_cli._coerce(value), cli._coerce(value)
    assert got == ref and type(got) is type(ref)


def test_apply_overrides_matches_jax():
    path = str(ROOT / "scripts" / "pretrain" / "dino_chada_vit_moyen.yaml")
    ref = jax_cli.apply_overrides(jax_config.load_yaml(path), OVERRIDES)
    got = cli.apply_overrides(config.load_yaml(path), OVERRIDES)
    assert got.to_dict() == ref.to_dict()
    with pytest.raises(SystemExit):
        cli.apply_overrides(config.Config(), ["no_equals_sign"])


def test_cli_reads_config_path_name_device_and_overrides():
    args = cli.parse_args(["--config-path", str(ROOT / "scripts" / "smoke"),
                           "--config-name", "dino_synthetic", "--device", "cpu",
                           "max_steps=2", "backbone.kwargs.ln_impl=pallas"])
    assert args.device == "cpu"
    cfg = cli.load_cfg(args)
    assert cfg.max_steps == 2 and cfg.backbone.kwargs.ln_impl == "pallas"
    assert cli.parse_args(["--config-name", "x"]).device is None


@pytest.mark.parametrize("name, overrides", [
    ("dino_chada_vit_moyen.yaml", ["data.dataset=synthetic"]),
    ("dino_chada_vit_moyen.yaml", ["data.dataset=synthetic", "precision=32",
                                   "scheduler.warmup_epochs=0"]),
    ("dino_idr10k.yaml", []),
    ("../smoke/dino_synthetic.yaml", ["backbone.kwargs.ln_impl=pallas"]),
])
def test_spec_from_cfg_matches_jax_field_by_field(name, overrides):
    path = str(ROOT / "scripts" / "pretrain" / name)
    ref = jax_spec_from_cfg(jax_config.parse_pretrain_cfg(
        jax_cli.apply_overrides(jax_config.load_yaml(path), overrides)), 7)
    got = spec_from_cfg(config.parse_pretrain_cfg(
        cli.apply_overrides(config.load_yaml(path), overrides)), 7)
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for f in dataclasses.fields(ref):
        want = getattr(ref, f.name)
        if f.name == "dtype":
            want = dtypes[want]
        assert getattr(got, f.name) == want, f.name
    assert {f.name for f in dataclasses.fields(got)} == {f.name for f in dataclasses.fields(ref)}


def test_save_args_json_matches_jax(tmp_path):
    path = str(ROOT / "scripts" / "smoke" / "dino_synthetic.yaml")
    jax_config.save_args_json(jax_config.parse_pretrain_cfg(jax_config.load_yaml(path)),
                              str(tmp_path / "jax.json"))
    config.save_args_json(config.parse_pretrain_cfg(config.load_yaml(path)),
                          str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
