"""Checkpointing and auto-resume (reference ``src/utils/checkpointer.py`` and
``src/utils/auto_resumer.py``).

Counterpart of ``chadavit_tpu/utils/checkpoint.py`` (``SHOULD_MATCH`` :38,
``save_pytree`` / ``restore_pytree`` :67-93, ``Checkpointer`` :96,
``AutoResumer`` :143) with the same directory contract:
``{dir}/{method}/{run_id}/{name}-{run_id}-ep={N}`` (or ``-step={N}`` for a
mid-epoch checkpoint) plus an ``args.json`` sidecar holding the full config;
the previous checkpoint is deleted unless ``keep_prev``. Auto-resume scans
every run's ``args.json`` for the 12 ``SHOULD_MATCH`` keys and returns the
newest checkpoint younger than ``max_hours``.

A checkpoint directory holds ``state.pt``, a ``torch.save`` of the whole
train state (the orbax tree of the JAX package), DINO's or a probe's, in one
layout (:func:`state_to_dict`): each field of the state, modules as state
dicts, the optimizer state by its fields' names, and the names of the tensors
it trains, all on the CPU; a loop's own numbers (the probe's ``lr_scale`` and
epoch, JAX ``main_linear.py:130-147``'s payload) go under ``extra``.
Restoring loads it in place into a state built for the same config, so an
exact-step resume continues the run bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import re
import shutil
import string
import time
from pathlib import Path
from typing import Any, Optional, Tuple

import torch
from torch import nn

SHOULD_MATCH = [
    "name",
    "backbone",
    "method",
    "data.dataset",
    "max_epochs",
    "optimizer.name",
    "optimizer.batch_size",
    "optimizer.lr",
    "optimizer.weight_decay",
    "wandb.project",
    "wandb.entity",
    "pretrained_feature_extractor",
]
STATE_FILE = "state.pt"


def _get_dotted(d: dict, path: str):
    node = d
    for p in path.split("."):
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def _random_run_id(n: int = 8) -> str:
    return "offline-" + "".join(random.choices(string.ascii_lowercase + string.digits, k=n))


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _plain(obj):
    """``obj`` in plain containers of CPU tensors and numbers: a module as its
    state dict, a NamedTuple (an optimizer state) as a dict of its fields, a
    tuple as a list, so that the file names every buffer."""
    if isinstance(obj, torch.Tensor):
        return _cpu(obj)
    if isinstance(obj, nn.Module):
        return {n: _cpu(t) for n, t in obj.state_dict().items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: _plain(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _restore(obj, saved, where: str):
    """``obj`` with the tensors and counts of ``saved`` (its :func:`_plain`
    form) copied in, in place where they are tensors. The flags and the
    structure are the config's: a field, a key, a length, a flag or a
    tensor's shape that differs raises ``ValueError`` naming ``where``."""
    def mismatch():
        return ValueError(f"checkpoint: {where} does not match this run's")

    if isinstance(obj, nn.Module):
        try:
            obj.load_state_dict(saved)
        except RuntimeError as e:  # a missing, unexpected or reshaped tensor
            raise mismatch() from e
        return obj
    if isinstance(obj, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != obj.shape:
            raise mismatch()
        return obj.copy_(saved)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        if not isinstance(saved, dict) or list(saved) != list(obj._fields):
            raise mismatch()
        return type(obj)(*(_restore(getattr(obj, k), saved[k], f"{where}.{k}")
                           for k in obj._fields))
    if isinstance(obj, dict):
        if not isinstance(saved, dict) or list(saved) != list(obj):
            raise mismatch()
        return {k: _restore(v, saved[k], f"{where}.{k}") for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(obj):
            raise mismatch()
        return type(obj)(_restore(v, s, f"{where}[{i}]")
                         for i, (v, s) in enumerate(zip(obj, saved)))
    if isinstance(obj, int) and not isinstance(obj, bool):
        return int(saved)
    if saved != obj:
        raise mismatch()
    return obj


def state_to_dict(state) -> dict:
    """A train state (``train/state.py``: ``DinoState`` or ``ProbeState``) as
    a dict of CPU tensors and numbers, one entry per field in its
    :func:`_plain` form (modules as state dicts, the optimizer state by its
    fields' names), and ``trainable``: the names of the tensors the optimizer
    state follows, in its order."""
    out = {f.name: _plain(getattr(state, f.name)) for f in dataclasses.fields(state)}
    out["trainable"] = [n for n, _ in state.trainable()]
    return out


def load_state_dict_into(state, saved: dict):
    """Copy a dict of :func:`state_to_dict` into ``state`` in place; returns
    ``state``. The structure must match (same config): other trained
    tensors, optimizer fields, flags or shapes raise ``ValueError``."""
    if saved["trainable"] != [n for n, _ in state.trainable()]:
        raise ValueError("checkpoint: the trained tensors do not match this run's")
    with torch.no_grad():
        for f in dataclasses.fields(state):
            setattr(state, f.name, _restore(getattr(state, f.name), saved[f.name], f.name))
    return state


def load_payload(path: str) -> dict:
    """The dict saved in the checkpoint directory ``path``."""
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                      weights_only=True)


def save_state(path: str, state, extra: Optional[dict] = None) -> None:
    """Write the train state ``state``, and the loop's own numbers ``extra``
    under the key ``"extra"``, to the checkpoint directory ``path`` (replaced
    if it exists; written under a temporary name, then renamed)."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    payload = state_to_dict(state)
    if extra is not None:
        payload["extra"] = dict(extra)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def restore_state(path: str, state):
    """Load the checkpoint directory ``path`` into ``state`` in place."""
    return load_state_dict_into(state, load_payload(path))


class Checkpointer:
    """Per-epoch checkpointer with the reference's directory contract."""

    def __init__(self, cfg, base_dir: Optional[str] = None, frequency: int = 1,
                 keep_prev: bool = False, run_id: Optional[str] = None):
        self.cfg = cfg
        base = Path(base_dir or _get_dotted(cfg, "checkpoint.dir") or "trained_models")
        method = _get_dotted(cfg, "method") or "base"
        self.run_id = run_id or _random_run_id()
        self.path = base / method / self.run_id
        self.name = _get_dotted(cfg, "name") or "run"
        self.frequency = frequency
        self.keep_prev = keep_prev
        self.last_ckpt: Optional[Path] = None
        self.path.mkdir(parents=True, exist_ok=True)
        self._save_args()

    def _save_args(self):
        args = self.cfg.to_dict() if hasattr(self.cfg, "to_dict") else dict(self.cfg)
        args["wandb_run_id"] = self.run_id
        with open(self.path / "args.json", "w") as f:
            json.dump(args, f, default=lambda o: "<not serializable>")

    def ckpt_path(self, epoch: int) -> Path:
        return self.path / f"{self.name}-{self.run_id}-ep={epoch}"

    def step_ckpt_path(self, step: int) -> Path:
        return self.path / f"{self.name}-{self.run_id}-step={step}"

    def _save(self, state: Any, ckpt: Path, extra: Optional[dict]):
        save_state(str(ckpt), state, extra)
        if self.last_ckpt and self.last_ckpt != ckpt and not self.keep_prev:
            shutil.rmtree(self.last_ckpt, ignore_errors=True)
        self.last_ckpt = ckpt

    def save(self, state: Any, epoch: int, extra: Optional[dict] = None):
        if epoch % self.frequency != 0:
            return
        self._save(state, self.ckpt_path(epoch), extra)

    def save_step(self, state: Any, step: int, extra: Optional[dict] = None):
        """Mid-epoch checkpoint at an exact global step (preemption safety; the
        reference requeues via ``SLURMEnvironment(requeue_signal=SIGUSR1)``)."""
        self._save(state, self.step_ckpt_path(step), extra)


class AutoResumer:
    """Find the newest compatible checkpoint to resume from."""

    SHOULD_MATCH = SHOULD_MATCH

    def __init__(self, checkpoint_dir: str = "trained_models", max_hours: float = 36):
        self.checkpoint_dir = Path(checkpoint_dir)
        self.max_seconds = max_hours * 3600

    def find_checkpoint(self, cfg) -> Tuple[Optional[str], Optional[str]]:
        """Returns (checkpoint_path, run_id) or (None, None)."""
        want = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
        candidates = []
        if not self.checkpoint_dir.exists():
            return None, None
        for args_json in self.checkpoint_dir.glob("**/args.json"):
            try:
                with open(args_json) as f:
                    args = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if any(_get_dotted(args, k) != _get_dotted(want, k) for k in self.SHOULD_MATCH):
                continue
            run_dir = args_json.parent
            for ckpt in run_dir.iterdir():
                m = re.search(r"-(?:ep|step)=(\d+)$", ckpt.name)
                if not m or not ckpt.is_dir():
                    continue
                age = time.time() - ckpt.stat().st_mtime
                if age <= self.max_seconds:
                    candidates.append((ckpt.stat().st_mtime, int(m.group(1)),
                                       str(ckpt), args.get("wandb_run_id")))
        if not candidates:
            return None, None
        candidates.sort()
        _, _, path, run_id = candidates[-1]
        return path, run_id
