"""The DINO and probe train states.

Counterpart of ``chadavit_tpu/train/state.py``. ``DinoState`` (:14): the student
and the teacher (same structure; the teacher is a materialised copy, reference
``momentum.py:27-41``), the optimizer state, the EMA center ``(1, P)``
(reference ``losses/dino.py:59``) and the step. Here the student and teacher
are ``{"backbone": nn.Module, "head": nn.Module}`` and the step function
updates them in place. ``ProbeState`` (:40): the backbone, the linear
classifier, the optimizer state and the step; a frozen probe trains the
classifier alone, a finetuned one the backbone too.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
from torch import nn


@dataclass
class DinoState:
    step: int
    student: Dict[str, nn.Module]
    teacher: Dict[str, nn.Module]
    opt_state: Any
    center: torch.Tensor  # (1, num_prototypes)

    @classmethod
    def create(cls, student: Dict[str, nn.Module], opt_state: Any,
               num_prototypes: int) -> "DinoState":
        teacher = {k: copy.deepcopy(m).requires_grad_(False) for k, m in student.items()}
        device = next(student["backbone"].parameters()).device
        return cls(step=0, student=student, teacher=teacher, opt_state=opt_state,
                   center=torch.zeros((1, num_prototypes), dtype=torch.float32,
                                      device=device))

    def trainable(self) -> List[Tuple[str, torch.Tensor]]:
        """The student's parameters that take gradients, ``part.name``-named,
        in a fixed order (the optimizer state follows it)."""
        return [(f"{part}.{name}", p) for part in ("backbone", "head")
                for name, p in self.student[part].named_parameters() if p.requires_grad]

    def ema_pairs(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(teacher, student) parameter lists, matched by name."""
        t, s = [], []
        for part in ("backbone", "head"):
            sp = dict(self.student[part].named_parameters())
            for name, tp in self.teacher[part].named_parameters():
                t.append(tp)
                s.append(sp[name])
        return t, s


@dataclass
class ProbeState:
    step: int
    backbone: nn.Module
    classifier: nn.Linear
    opt_state: Any
    finetune: bool = False

    @classmethod
    def create(cls, backbone: nn.Module, classifier: nn.Linear, opt_state: Any,
               finetune: bool = False) -> "ProbeState":
        return cls(step=0, backbone=backbone, classifier=classifier,
                   opt_state=opt_state, finetune=finetune)

    def trainable(self) -> List[Tuple[str, torch.Tensor]]:
        """The tensors the optimizer updates, ``part.name``-named, in a fixed
        order (the optimizer state follows it): the backbone's when
        finetuning, then the classifier's. A frozen backbone is not among
        them: no step touches it."""
        parts = (("backbone", "classifier") if self.finetune else ("classifier",))
        return [(f"{part}.{name}", p) for part in parts
                for name, p in getattr(self, part).named_parameters()]
