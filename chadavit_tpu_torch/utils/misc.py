"""Seeding and host bookkeeping of the train loop.

Counterpart of the parts of ``chadavit_tpu/utils/misc.py`` the pretrain loop
uses: ``seed_everything`` (:237), ``resolve_seed`` (:245), ``host_rss_bytes``
(:254), ``HostMemGuard`` (:324) and ``pretty_param_summary`` (:377).
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch
from torch import nn


def seed_everything(seed: int) -> torch.Generator:
    """Seed python's, numpy's and torch's global RNGs; returns a CPU
    ``torch.Generator`` seeded with ``seed`` (the JAX function returns a
    PRNG key; reference ``seed_everything_manual``, ``misc.py:547``)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def resolve_seed(cfg, default: int = 5) -> int:
    """Config seed with an explicit None check so ``seed: 0`` is honored;
    None means ``default`` (5, the value every shipped config uses)."""
    seed = cfg.get("seed")
    return default if seed is None else int(seed)


def host_rss_bytes() -> int:
    """Resident set size of this process in bytes (0 where /proc is absent)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:  # pragma: no cover - non-Linux
        pass
    return 0


class HostMemGuard:
    """A hook kept where the JAX loop checks host memory, doing nothing.

    The JAX package's guard checkpoints and re-execs the process when a
    networked TPU client that keeps every uploaded host batch pushes the
    resident set past a threshold (``chadavit_tpu/utils/misc.py:145-191``).
    The CUDA runtime keeps no such copies, so here :meth:`check` never
    fires; ``host_mem_guard_mb`` is read and ignored."""

    def __init__(self, guard_mb: Optional[int] = None, can_restart: bool = True):
        self.guard_mb, self.can_restart = guard_mb, can_restart

    def check(self, save, where: str = "") -> None:
        return None


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def pretty_param_summary(modules) -> str:
    """Per-top-level-module parameter counts (the RichModelSummary analogue,
    reference ``main_pretrain.py:287``): ``modules`` is a module (its direct
    children are listed) or a dict of modules."""
    items = (modules.items() if isinstance(modules, dict)
             else modules.named_children())
    lines, total = [], 0
    named = dict(items)
    if isinstance(modules, nn.Module):  # parameters held by the module itself
        own = sum(p.numel() for p in modules.parameters(recurse=False))
        if own:
            lines.append(f"  {'(own)':<24s} {own:>12,d}")
            total += own
    for k in sorted(named):
        n = param_count(named[k])
        total += n
        lines.append(f"  {k:<24s} {n:>12,d}")
    lines.append(f"  {'TOTAL':<24s} {total:>12,d}")
    return "\n".join(lines)
