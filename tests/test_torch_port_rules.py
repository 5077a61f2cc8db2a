"""Rules the port keeps: it imports nothing of JAX or of the JAX package, it
imports without JAX present, its smoke run refuses a machine without CUDA,
and only sources are tracked under its package directory."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "chadavit_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chadavit_tpu")
SOURCE_SUFFIXES = {".py", ".cu", ".cuh"}


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_and_smoke_import_without_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'optax', 'chadavit_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {modules + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_refuses_a_machine_without_cuda():
    # the CUDA check decides inside the run, so a machine with a card runs
    # the real smoke; this rule is about the machine without one
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_only_sources_are_tracked_in_the_package():
    try:
        listed = subprocess.run(["git", "ls-files", "chadavit_tpu_torch"], cwd=ROOT,
                                capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        listed = None
    if listed is not None and listed.returncode == 0 and listed.stdout.strip():
        files = [ROOT / f for f in listed.stdout.split()]
    else:  # not a git checkout: every file but what .gitignore lists
        files = [p for p in PKG.rglob("*") if p.is_file()
                 and "_build" not in p.parts and "__pycache__" not in p.parts]
    assert files
    others = [str(f.relative_to(ROOT)) for f in files if f.suffix not in SOURCE_SUFFIXES]
    assert not others, others
