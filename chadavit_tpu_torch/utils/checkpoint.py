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

A checkpoint directory holds ``state.pt``, a ``torch.save`` of the whole DINO
train state (the orbax tree of the JAX package): the student and the teacher
state dicts, the optimizer state (LARS step count, the names of the trainable
tensors and their momentum buffers), the center and the step, all on the
CPU. Restoring loads it in place into a state built for the same config, so
an exact-step resume continues the run bit for bit.
"""

from __future__ import annotations

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


def state_to_dict(state) -> dict:
    """The DINO train state (``train/state.py::DinoState``) as a dict of CPU
    tensors and numbers."""
    opt = state.opt_state
    return {
        "step": int(state.step),
        "student": {k: {n: _cpu(t) for n, t in m.state_dict().items()}
                    for k, m in state.student.items()},
        "teacher": {k: {n: _cpu(t) for n, t in m.state_dict().items()}
                    for k, m in state.teacher.items()},
        # the momentum buffers follow the student's trainable tensors, named here
        "opt_state": {"count": int(opt.count), "one_d": list(opt.one_d),
                      "names": [n for n, _ in state.trainable()],
                      "momentum": None if opt.momentum is None
                      else [_cpu(b) for b in opt.momentum]},
        "center": _cpu(state.center),
    }


def load_state_dict_into(state, saved: dict):
    """Copy a dict of :func:`state_to_dict` into ``state`` in place; returns
    ``state``. The structure must match (same config)."""
    with torch.no_grad():
        for side in ("student", "teacher"):
            for k, m in getattr(state, side).items():
                m.load_state_dict(saved[side][k])
        opt = saved["opt_state"]
        mom = state.opt_state.momentum
        if (opt["names"] != [n for n, _ in state.trainable()]
                or (mom is None) != (opt["momentum"] is None)
                or (mom is not None and len(mom) != len(opt["momentum"]))):
            raise ValueError("checkpoint: the optimizer state does not match this run's")
        if mom is not None:
            for b, s in zip(mom, opt["momentum"]):
                b.copy_(s)
        state.opt_state = state.opt_state._replace(count=int(opt["count"]),
                                                   one_d=list(opt["one_d"]))
        state.center = saved["center"].to(state.center.device)
        state.step = int(saved["step"])
    return state


def save_state(path: str, state) -> None:
    """Write ``state`` to the checkpoint directory ``path`` (replaced if it
    exists; written under a temporary name, then renamed)."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state_to_dict(state), os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def restore_state(path: str, state):
    """Load the checkpoint directory ``path`` into ``state`` in place."""
    saved = torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                       weights_only=True)
    return load_state_dict_into(state, saved)


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

    def _save(self, state: Any, ckpt: Path):
        save_state(str(ckpt), state)
        if self.last_ckpt and self.last_ckpt != ckpt and not self.keep_prev:
            shutil.rmtree(self.last_ckpt, ignore_errors=True)
        self.last_ckpt = ckpt

    def save(self, state: Any, epoch: int):
        if epoch % self.frequency != 0:
            return
        self._save(state, self.ckpt_path(epoch))

    def save_step(self, state: Any, step: int):
        """Mid-epoch checkpoint at an exact global step (preemption safety; the
        reference requeues via ``SLURMEnvironment(requeue_signal=SIGUSR1)``)."""
        self._save(state, self.step_ckpt_path(step))


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
