"""Checks shared by the kernel wrappers before they hand pointers to C."""

from __future__ import annotations

from collections import Counter

import torch

# Launches per C entry point (``ln_linear_fwd``, ``ln_linear_fwd_bf16``, ...),
# counted where a wrapper launches its kernel and nowhere else.
LAUNCHES: Counter = Counter()


def counted(name: str) -> None:
    """Count one launch of entry point ``name``."""
    LAUNCHES[name] += 1


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the call takes the plain version: its first tensor lies on
    the CPU. A CUDA tensor goes to the kernel; any other device raises."""
    dev = tensors[0].device.type
    if dev == "cpu":
        return True
    if dev != "cuda":
        raise ValueError(f"the port's kernels run on CUDA tensors, got {dev}")
    for t in tensors:
        if t is None:
            raise ValueError("the kernels need valid_len")
        if t.device != tensors[0].device:
            raise ValueError(f"tensors on {tensors[0].device} and {t.device}")
    return False


# The activation dtypes the kernels are built for, and the suffix of their C
# entry points: the float32 instances keep the plain names, the bf16 ones end
# in _bf16. Every call takes one activation dtype; LN parameters, row stats,
# lse and parameter gradients are float32 in both.
KERNEL_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}


def entry_point(name: str, dtype: torch.dtype) -> str:
    """The C entry point of kernel ``name`` for activations of ``dtype``;
    raises on a dtype there is no kernel for (nothing is cast quietly)."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernels take float32 or bfloat16 activations, "
                        f"got {dtype}")
    return name + KERNEL_DTYPES[dtype]


def vector_operand(t: torch.Tensor, name: str, dtype: torch.dtype = torch.float32,
                   align: int = 0) -> int:
    """Pointer of a contiguous CUDA tensor of ``dtype`` (float32 or bfloat16),
    aligned for the kernels' loads of four elements (16 bytes for float32, 8
    for bfloat16), or to ``align`` bytes where that is more (the tensor-core
    kernels' 16-byte copies)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype} here, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    align = max(align, 4 * t.element_size())
    if t.data_ptr() % align:
        raise ValueError(f"{name}: must be aligned to {align} bytes")
    return t.data_ptr()


def valid_len_operand(valid_len: torch.Tensor, batch: int,
                      device: torch.device) -> int:
    if valid_len is None:
        raise ValueError("the kernels need valid_len")
    if (valid_len.dtype != torch.int32 or valid_len.shape != (batch,)
            or valid_len.device != device or not valid_len.is_contiguous()):
        raise ValueError(
            f"valid_len must be a contiguous int32 ({batch},) tensor on {device}, "
            f"got {valid_len.dtype} {tuple(valid_len.shape)} on {valid_len.device}")
    return valid_len.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd records a call on these tensors."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """A forward-only kernel wrapper hands back a tensor without a graph, so
    it raises where autograd would record the call."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name} has no gradient of its own: call it under torch.no_grad(), or "
            "use fused_encoder_block, whose backward is the layer's kernels")
