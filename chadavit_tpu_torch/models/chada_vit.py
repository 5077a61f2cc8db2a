"""Channel-Adaptive Vision Transformer (ChAda-ViT), forward, in PyTorch.

Counterpart of ``chadavit_tpu/models/chada_vit.py`` (``channel_padding_mask``
:74, ``PatchEmbed`` :88, ``EncoderLayer`` :140, ``ChAdaViT`` :287,
``chada_vit`` :533, ``densify_one_channel_batch`` :555). The numerics follow
the JAX model: the post-norm layer applies ``norm1`` twice, the FFN is ReLU,
LayerNorm stats are f32 fast variance with the ``max(0, .)`` clamp, eps 1e-5
in the blocks and 1e-6 in the final norm.

Inputs are dense: ``x (B, C_max, H, W)`` and ``channel_counts (B,)``. The
valid tokens of image ``b`` are the prefix ``1 + N * channel_counts[b]``.

Parameter names follow the reference torch state-dict layout
(``cls_token``, ``channel_token``, ``pos_embed``, ``token_learner.proj``,
``blocks.{i}.self_attn.*``, ``blocks.{i}.linear{1,2}``, ``blocks.{i}.norm{1,2}``,
``norm``), so a reference checkpoint loads through ``load_state_dict``.

With grad enabled (the DINO student) each layer runs
``fused_block.FusedEncoderBlock``, whose backward is the layer's kernels; the
tokenizer, the pos/channel tokens and the final norm stay plain torch ops with
autograd, as the JAX package leaves them to XLA. With ``ln_impl="pallas"``
the final norm, and with ``block_impl="xla"`` also the three LayerNorms of
each unfused layer, run the LayerNorm kernels (``ops/layernorm.py``), as the
JAX model's ``ln_impl`` does (``chada_vit.py:229-234``, ``:363-365``).
Dropout is not ported: a rate above 0 raises.

``dtype`` is the compute dtype, float32 or bfloat16, as the JAX modules'
``dtype``: the parameters stay float32 (``param_dtype``, the only one
honoured) and are cast at use; the tokenizer, the layers and the final norm
compute in ``dtype`` (LayerNorm statistics in float32), and the embeddings
come out in ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from chadavit_tpu_torch.ops import fused_block
from chadavit_tpu_torch.ops.attention import masked_multihead_attention
from chadavit_tpu_torch.ops.layernorm import layernorm

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
LN_IMPLS = ("auto", "xla", "pallas")  # ops/layernorm.py::layernorm's impl


def _check_dtypes(dtype: torch.dtype, param_dtype: torch.dtype) -> None:
    if dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(f"dtype {dtype}: the port computes in float32 or bfloat16")
    if param_dtype != torch.float32:
        raise NotImplementedError(
            f"param_dtype {param_dtype}: the port keeps its parameters in float32")


def channel_padding_mask(channel_counts: torch.Tensor, max_channels: int,
                         num_patches: int) -> torch.Tensor:
    """``(B, 1 + max_channels * num_patches)`` bool, True = padded token;
    position 0 (CLS) is always valid."""
    chan_idx = torch.arange(max_channels * num_patches,
                            device=channel_counts.device) // num_patches
    mask = chan_idx[None, :] >= channel_counts[:, None].long()
    cls_col = torch.zeros((channel_counts.shape[0], 1), dtype=torch.bool,
                          device=channel_counts.device)
    return torch.cat([cls_col, mask], dim=1)


class TokenLearner(nn.Module):
    """Single-channel patch embedding (reference ``TokenLearner``). The
    stride == kernel convolution runs as unfold + matmul, the JAX
    ``use_conv=False`` lowering of the same function, so no TF32 convolution
    enters the f32 path. It computes in the input's dtype: kernel and bias
    are cast to it, as the JAX ``PatchEmbed`` casts to its ``dtype``."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(1, embed_dim, kernel_size=patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (..., H, W) single-channel planes -> (..., N, D)
        p = self.patch_size
        *lead, h, w = x.shape
        gh, gw = h // p, w // p
        n = len(lead)
        x = x.reshape(*lead, gh, p, gw, p).permute(*range(n), n, n + 2, n + 1, n + 3)
        x = x.reshape(*lead, gh * gw, p * p)
        kernel = self.proj.weight.reshape(self.proj.weight.shape[0], p * p).to(x.dtype)
        return torch.matmul(x, kernel.t()) + self.proj.bias.to(x.dtype)


class SelfAttentionParams(nn.Module):
    """The parameters of torch ``MultiheadAttention`` under its names, so that
    reference state dicts load; the attention itself is the port's."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)


class EncoderLayer(nn.Module):
    """Post-norm encoder layer with the reference's double-norm1 quirk.

    ``block_impl="auto"`` runs :func:`fused_block.fused_encoder_block` unless
    attention weights are asked for: on CUDA that is the kernel chain, which
    raises without ``valid_len`` or at widths it is not built for. ``"xla"``
    forces the unfused plain path, which also returns attention weights and
    serves CPU calls without ``valid_len``. The layer computes in ``dtype``
    (its input is cast to it) with float32 parameters cast at use.
    ``ln_impl`` selects the unfused path's three LayerNorms, as the JAX
    layer's (``chada_vit.py:229-234``): ``"auto"``/``"xla"`` the plain one,
    ``"pallas"`` the LayerNorm kernels (``ops/layernorm.py``); the fused
    path keeps its own.
    """

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int = 2048,
                 layer_norm_eps: float = 1e-5, block_impl: str = "auto",
                 dropout_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, ln_impl: str = "auto"):
        super().__init__()
        if block_impl not in ("auto", "xla"):
            raise ValueError(f"block impl {block_impl!r}: want 'auto' or 'xla'")
        if ln_impl not in LN_IMPLS:
            raise ValueError(f"ln impl {ln_impl!r}: want one of {LN_IMPLS}")
        if dropout_rate > 0:
            raise NotImplementedError(f"dropout rate {dropout_rate}: dropout is not ported")
        _check_dtypes(dtype, param_dtype)
        self.dtype = dtype
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.layer_norm_eps = layer_norm_eps
        self.block_impl = block_impl
        self.ln_impl = ln_impl
        self.self_attn = SelfAttentionParams(embed_dim)
        self.linear1 = nn.Linear(embed_dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, embed_dim)
        self.norm1 = nn.LayerNorm(embed_dim, eps=layer_norm_eps)
        self.norm2 = nn.LayerNorm(embed_dim, eps=layer_norm_eps)

    def weights(self) -> tuple:
        """The 12 layer parameters in :func:`fused_encoder_block`'s order."""
        a = self.self_attn
        return (a.in_proj_weight, a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
                self.norm1.weight, self.norm1.bias, self.norm2.weight, self.norm2.bias,
                self.linear1.weight, self.linear1.bias,
                self.linear2.weight, self.linear2.bias)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor],
                valid_len: Optional[torch.Tensor] = None,
                return_attention: bool = False) -> torch.Tensor:
        eps, dt = self.layer_norm_eps, self.dtype
        x = x.to(dt)
        if (self.block_impl == "auto" and not return_attention
                and (valid_len is not None or x.is_cuda)):
            return fused_block.fused_encoder_block(
                x, valid_len, *self.weights(), self.num_heads, eps, eps)

        def linear(t, lin):
            return F.linear(t, lin.weight.to(dt), lin.bias.to(dt))

        def ln(v, norm, residual=None):
            return layernorm(v, norm.weight, norm.bias, eps, impl=self.ln_impl,
                             residual=residual)

        d = self.embed_dim
        qkv = torch.matmul(ln(x, self.norm1), self.self_attn.in_proj_weight.to(dt).t()) \
            + self.self_attn.in_proj_bias.to(dt)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        attn_out, attn_weights = masked_multihead_attention(
            q, k, v, key_padding_mask, self.num_heads,
            return_weights=return_attention, valid_len=valid_len)
        if return_attention:
            return attn_weights
        attn_out = linear(attn_out, self.self_attn.out_proj)
        x = ln(attn_out, self.norm1, residual=x)
        h = linear(torch.relu(linear(x, self.linear1)), self.linear2)
        return ln(h, self.norm2, residual=x)


class ChAdaViT(nn.Module):
    """Channel-Adaptive ViT on a dense ``(B, C_max, H, W)`` batch plus
    ``(B,)`` channel counts."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 192, depth: int = 12, num_heads: int = 2,
                 ffn_dim: int = 2048, max_channels: int = 10,
                 return_all_tokens: bool = True, layer_norm_eps: float = 1e-5,
                 final_norm_eps: float = 1e-6, block_impl: str = "auto",
                 drop_path_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, ln_impl: str = "auto"):
        super().__init__()
        _check_dtypes(dtype, param_dtype)
        self.dtype = dtype
        self.ln_impl = ln_impl
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.max_channels = max_channels
        self.return_all_tokens = return_all_tokens
        self.final_norm_eps = final_norm_eps
        n = self.num_patches
        self.token_learner = TokenLearner(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.channel_token = nn.Parameter(torch.zeros(1, max_channels, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1, n + 1, embed_dim))
        self.blocks = nn.ModuleList(
            # the JAX model's per-layer dropout rates (chada_vit.py:341-349)
            EncoderLayer(embed_dim, num_heads, ffn_dim, layer_norm_eps, block_impl,
                         dropout_rate=drop_path_rate * i / max(depth - 1, 1),
                         dtype=dtype, param_dtype=param_dtype, ln_impl=ln_impl)
            for i in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=final_norm_eps)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.norm.weight, self.norm.bias, self.final_norm_eps,
                         impl=self.ln_impl)

    def _patch_pos_embed(self, w: int, h: int) -> torch.Tensor:
        p = self.patch_size
        if (w // p) * (h // p) != self.num_patches or w != h:
            # the JAX model resizes bicubically here (jax.image.resize), which
            # torch's bicubic does not reproduce; not ported yet
            raise NotImplementedError(
                f"input {w}x{h} differs from the model's {self.img_size} px grid")
        return self.pos_embed[:, :, 1:]

    def tokenize(self, x: torch.Tensor, channel_counts: torch.Tensor,
                 max_channels: Optional[int] = None):
        """Channel-aware tokenization. Returns ``(embeddings (B, 1 + C*N, D),
        key_padding_mask (B, 1 + C*N))``. Channel tokens are added unless an
        explicit ``max_channels`` differs from the model's capacity (the
        reference quirk the attention-map path relies on)."""
        add_channel_tokens = max_channels is None or max_channels == self.max_channels
        b, c, h, w = x.shape
        if max_channels is not None and c != max_channels:
            raise ValueError(f"x has {c} channels, max_channels={max_channels}")
        if c > self.max_channels:
            raise ValueError(f"x has {c} channels, the model takes {self.max_channels}")
        n = (h // self.patch_size) * (w // self.patch_size)
        mask = channel_padding_mask(channel_counts, c, n)
        dt = self.dtype
        tokens = self.token_learner(x.to(dt))  # (B, C, N, D)
        tokens = tokens + self._patch_pos_embed(w, h).to(dt)
        if add_channel_tokens:
            tokens = tokens + self.channel_token[:, :c].to(dt)
        tokens = tokens.reshape(b, c * n, self.embed_dim)
        cls = (self.cls_token.to(dt) + self.pos_embed[:, :, 0].to(dt)).expand(
            b, 1, self.embed_dim)
        return torch.cat([cls, tokens], dim=1), mask

    def forward(self, x: torch.Tensor, channel_counts: torch.Tensor,
                return_dense_tokens: bool = False):
        """``(B, D)`` CLS embeddings when ``return_all_tokens`` is False;
        otherwise ``(tokens (B, C_max*N, D), valid (B, C_max*N))``. Padded
        positions (``valid == False``) are not contractual."""
        emb, mask = self.tokenize(x, channel_counts)
        # pad the sequence to the multiple the kernels tile by (1961 -> 2048);
        # the padded keys are masked, the padded rows sliced off below
        s_real = emb.shape[1]
        s_pad = -(-s_real // fused_block.SEQ_PAD) * fused_block.SEQ_PAD
        emb = F.pad(emb, (0, 0, 0, s_pad - s_real))
        mask = F.pad(mask, (0, s_pad - s_real), value=True)
        valid_len = (1 + channel_counts.to(torch.int32) * self.num_patches).to(torch.int32)
        for blk in self.blocks:
            emb = blk(emb, mask, valid_len=valid_len)
        emb = self.final_norm(emb)[:, :s_real]
        mask = mask[:, :s_real]
        if self.return_all_tokens or return_dense_tokens:
            return emb[:, 1:], ~mask[:, 1:]
        return emb[:, 0]

    def get_last_selfattention(self, x: torch.Tensor) -> torch.Tensor:
        """Attention weights ``(B, H, S, S)`` of the last block for a
        single-channel batch ``(B, 1, H, W)``."""
        counts = torch.ones((x.shape[0],), dtype=torch.int32, device=x.device)
        emb, mask = self.tokenize(x, counts, max_channels=1)
        valid_len = torch.full((x.shape[0],), emb.shape[1], dtype=torch.int32,
                               device=x.device)
        for blk in self.blocks[:-1]:
            emb = blk(emb, mask, valid_len=valid_len)
        return self.blocks[-1](emb, mask, valid_len=valid_len, return_attention=True)

    def get_intermediate_layers(self, x: torch.Tensor, channel_counts: torch.Tensor,
                                n: int = 1) -> list:
        """Normed outputs of the last ``n`` blocks."""
        emb, mask = self.tokenize(x, channel_counts)
        valid_len = (1 + channel_counts.to(torch.int32) * self.num_patches).to(torch.int32)
        outputs = []
        for i, blk in enumerate(self.blocks):
            emb = blk(emb, mask, valid_len=valid_len)
            if len(self.blocks) - i <= n:
                outputs.append(self.final_norm(emb))
        return outputs


# The JAX factory's keys that the port takes only at the values it honours;
# any other value raises with the key's name. ``patch_embed_conv`` selects one
# of two lowerings of the same patch embedding, both honoured by the port's
# one. ``ln_impl="pallas"`` runs the LayerNorm kernels. A device mesh belongs
# to a later slice.
_FACTORY_VALUES = {
    "param_dtype": (torch.float32,),
    "attn_impl": ("auto",),
    "ln_impl": LN_IMPLS,
    "seq_pad_multiple": (fused_block.SEQ_PAD,),
    "patch_embed_conv": (True, False),
    "shard_mesh": (None,),
}


def chada_vit(**kwargs) -> ChAdaViT:
    """Canonical factory (reference ``chada_vit.py:333-339``): depth 12,
    heads 2, final-norm eps 1e-6. It reads the JAX factory's keys
    (``chadavit_tpu/models/chada_vit.py:533-552``): ``dtype`` (float32 or
    bfloat16) and ``block_impl`` are honoured, and ``param_dtype``,
    ``attn_impl``, ``ln_impl``, ``seq_pad_multiple``, ``patch_embed_conv`` and
    ``shard_mesh`` are taken at the values in :data:`_FACTORY_VALUES`
    (``ln_impl`` at all three of the JAX package's); any other value raises
    ``NotImplementedError``."""
    for key, honoured in _FACTORY_VALUES.items():
        if key in kwargs and kwargs[key] not in honoured:
            raise NotImplementedError(
                f"chada_vit: {key}={kwargs[key]!r} is not ported; the port takes "
                f"{key} in {honoured}")
    return ChAdaViT(
        patch_size=kwargs.get("patch_size", 16),
        embed_dim=kwargs.get("embed_dim", 192),
        depth=kwargs.get("depth", 12),
        num_heads=kwargs.get("num_heads", 2),
        return_all_tokens=kwargs.get("return_all_tokens", True),
        max_channels=kwargs.get("max_number_channels", 10),
        img_size=kwargs.get("img_size", 224),
        block_impl=kwargs.get("block_impl", "auto"),
        ln_impl=kwargs.get("ln_impl", "auto"),
        drop_path_rate=kwargs.get("drop_path_rate", 0.0),
        dtype=kwargs.get("dtype", torch.float32),
        param_dtype=kwargs.get("param_dtype", torch.float32),
    )


def random_state_dict(model: ChAdaViT, seed: int) -> dict:
    """Weights for ``model`` drawn with numpy from ``seed``, so that any
    process (and the JAX package, through its importer) can rebuild them.

    The draws follow the JAX model's initializers: truncated normal 0.02 for
    the tokens, lecun normal for the patch kernel, xavier uniform for the
    attention projections, uniform(+-1/sqrt(fan_in)) for the FFN. Biases get
    N(0, 0.02) and the LayerNorm parameters 1 + N(0, 0.1) and N(0, 0.05), so
    that a comparison of two implementations exercises every parameter.
    """
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        if name in ("cls_token", "channel_token", "pos_embed"):
            a = np.clip(rng.standard_normal(shape), -2.0, 2.0) * 0.02
        elif name.endswith("norm1.weight") or name.endswith("norm2.weight") \
                or name == "norm.weight":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("norm1.bias") or name.endswith("norm2.bias") \
                or name == "norm.bias":
            a = 0.05 * rng.standard_normal(shape)
        elif leaf in ("bias", "in_proj_bias"):
            a = 0.02 * rng.standard_normal(shape)
        elif name == "token_learner.proj.weight":
            fan_in = int(np.prod(shape[1:]))
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif leaf == "in_proj_weight" or name.endswith("out_proj.weight"):
            lim = np.sqrt(6.0 / (shape[0] + shape[1]))
            a = rng.uniform(-lim, lim, shape)
        else:  # linear1 / linear2 weights
            lim = 1.0 / np.sqrt(shape[1])
            a = rng.uniform(-lim, lim, shape)
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def densify_one_channel_batch(flat, list_num_channels, max_channels: int):
    """The reference's ragged collate layout ``(sum(c_i), 1, H, W)`` plus
    per-image channel counts -> dense ``(B, C_max, H, W)`` and ``(B,)``."""
    flat = torch.as_tensor(np.asarray(flat))
    if flat.dim() == 4:
        flat = flat[:, 0]
    counts = torch.as_tensor(np.asarray(list_num_channels, dtype=np.int32))
    h, w = flat.shape[-2:]
    dense = torch.zeros((counts.shape[0], max_channels, h, w), dtype=flat.dtype)
    off = 0
    for i, c in enumerate(counts.tolist()):
        dense[i, :c] = flat[off:off + c]
        off += c
    return dense, counts
