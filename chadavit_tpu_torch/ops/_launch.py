"""Checks shared by the kernel wrappers before they hand pointers to C."""

from __future__ import annotations

import torch


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


def float_operand(t: torch.Tensor, name: str) -> int:
    """Pointer of a contiguous float32 CUDA tensor, aligned for float4 loads."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernels take float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
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
