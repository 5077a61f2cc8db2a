"""DINO projection head, in PyTorch.

Counterpart of ``chadavit_tpu/models/dino_head.py`` (``DINOHead`` :20-72):
an MLP (hidden 2048, exact GELU) -> L2-normalised bottleneck (256, norm
clamped at 1e-12) -> weight-normalised prototype layer without bias. The
weight norm is written out: ``weight_v`` ``(P, bottleneck)`` is normalised per
prototype and scaled by ``weight_g`` ``(P, 1)``, which starts at 1 and gets no
gradient under ``norm_last_layer`` (reference ``dino.py:78-84``).

Parameter names follow the reference torch state dict: ``mlp.0``, ``mlp.2``,
``mlp.4`` (GELUs between) and ``last_layer.weight_v`` /
``last_layer.weight_g``. BatchNorm in the head is not ported.

``dtype`` is the compute dtype, as the JAX head's (``dino_head.py:65-72``):
the parameters stay float32 and are cast to it at use, and the logits come
out in it; the train step upcasts them to float32 for the loss.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class _WeightNormPrototypes(nn.Module):
    """The prototype layer's two parameters under torch weight-norm names."""

    def __init__(self, bottleneck_dim: int, num_prototypes: int, train_g: bool):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(num_prototypes, bottleneck_dim))
        self.weight_g = nn.Parameter(torch.ones(num_prototypes, 1), requires_grad=train_g)
        nn.init.kaiming_uniform_(self.weight_v, a=5 ** 0.5)


class DINOHead(nn.Module):
    def __init__(self, in_dim: int, num_prototypes: int, use_bn: bool = False,
                 norm_last_layer: bool = True, num_layers: int = 3,
                 hidden_dim: int = 2048, bottleneck_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if use_bn:
            raise NotImplementedError("BatchNorm in the DINO head is not ported")
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"dtype {dtype}: the head computes in float32 or bfloat16")
        self.dtype = dtype
        self.norm_last_layer = norm_last_layer
        num_layers = max(num_layers, 1)
        if num_layers == 1:
            self.mlp = nn.Linear(in_dim, bottleneck_dim)
        else:
            layers = [nn.Linear(in_dim, hidden_dim), nn.GELU()]
            for _ in range(num_layers - 2):
                layers += [nn.Linear(hidden_dim, hidden_dim), nn.GELU()]
            layers.append(nn.Linear(hidden_dim, bottleneck_dim))
            self.mlp = nn.Sequential(*layers)
        self.last_layer = _WeightNormPrototypes(bottleneck_dim, num_prototypes,
                                                train_g=not norm_last_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        for layer in (self.mlp if isinstance(self.mlp, nn.Sequential) else [self.mlp]):
            if isinstance(layer, nn.Linear):
                x = F.linear(x, layer.weight.to(dt), layer.bias.to(dt))
            else:
                x = layer(x)
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        v = self.last_layer.weight_v.to(dt)
        w = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-12)
        g = self.last_layer.weight_g.to(dt)
        w = w * (g.detach() if self.norm_last_layer else g)
        return torch.matmul(x, w.t())


def random_head_state_dict(head: DINOHead, seed: int) -> dict:
    """Weights for ``head`` drawn with numpy from ``seed``, after the JAX
    head's initializers: truncated normal 0.02 for the MLP kernels,
    uniform(+-sqrt(3 / bottleneck)) for ``weight_v`` (variance scaling, fan
    in), ``weight_g`` = 1. The MLP biases get N(0, 0.02) in place of zeros, so
    that a comparison of two implementations exercises them."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in head.state_dict().items():
        shape = tuple(t.shape)
        if name == "last_layer.weight_g":
            a = np.ones(shape)
        elif name == "last_layer.weight_v":
            lim = np.sqrt(3.0 / shape[1])
            a = rng.uniform(-lim, lim, shape)
        elif name.endswith(".bias"):
            a = 0.02 * rng.standard_normal(shape)
        else:
            a = np.clip(rng.standard_normal(shape), -2.0, 2.0) * 0.02
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out
