"""Action recognition: per-frame encoder + temporal decoder
(counterpart of ``evam_tpu/models/zoo/action.py``).

The encoder embeds each frame; a 16-frame clip of embeddings goes
through a temporal transformer decoder to per-clip class logits
(action-recognition-0001 encoder + decoder). Submodules carry flax's
auto-names (``TransformerBlock_0.MultiHeadDotProductAttention_0.query``,
``LayerNorm_1``, ...) so a reference checkpoint maps key for key
(``models/convert.py``).

Port notes, where a plain torch translation goes wrong:

* flax's ``nn.LayerNorm`` uses ``epsilon=1e-6`` (torch: 1e-5);
* flax's ``nn.gelu`` is the tanh approximation (torch: exact);
* flax's ``MultiHeadDotProductAttention`` divides the query by
  ``sqrt(head_dim)`` before the product and has biased query, key,
  value and output projections, kept here in flax's ``DenseGeneral``
  layout and contracted with einsum;
* the encoder's spatial mean is over H, W: axes (2, 3) in NCHW.

The attention is plain torch (einsum, softmax, einsum), as the
reference computes it in flax outside any Pallas kernel. The
reference's parallel hooks (``attention_fn``, ``mlp_constraint``,
``moe_experts``, ``moe_constraint``) belong to its frozen parallel code
and raise naming that slice.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from evam_tpu_torch import slices
from evam_tpu_torch.models.zoo.layers import ConvBlock, SeparableConv

CLIP_LEN = 16
#: flax ``nn.LayerNorm``'s default epsilon
LN_EPS = 1e-6


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class ActionEncoder(nn.Module):
    """Frame → embedding (action-recognition-0001-encoder counterpart).
    Input is the reference's NHWC ``[B, H, W, 3]``."""

    def __init__(self, embed_dim: int = 512, width: int = 32):
        super().__init__()
        w = width
        self.embed_dim = embed_dim
        self.ConvBlock_0 = ConvBlock(3, w, stride=2)
        self.SeparableConv_0 = SeparableConv(w, w * 2, 2)
        self.SeparableConv_1 = SeparableConv(w * 2, w * 4, 2)
        self.SeparableConv_2 = SeparableConv(w * 4, w * 8, 2)
        self.SeparableConv_3 = SeparableConv(w * 8, w * 16, 2)
        self.Dense_0 = nn.Linear(w * 16, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvBlock_0(x.permute(0, 3, 1, 2))
        for i in range(4):
            x = getattr(self, f"SeparableConv_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


class _DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` as attention uses it: ``weight`` in flax's
    kernel layout (``[D, H, hd]`` in, ``[H, hd, D]`` out) and a bias of
    the output's trailing shape."""

    def __init__(self, weight_shape: tuple[int, ...],
                 bias_shape: tuple[int, ...]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.zeros(bias_shape))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads)`` self-attention
    with ``qkv_features`` = ``out_features`` = the input's dim."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        hd = dim // heads
        self.head_dim = hd
        self.query = _DenseGeneral((dim, heads, hd), (heads, hd))
        self.key = _DenseGeneral((dim, heads, hd), (heads, hd))
        self.value = _DenseGeneral((dim, heads, hd), (heads, hd))
        self.out = _DenseGeneral((heads, hd, dim), (dim,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def project(p: _DenseGeneral) -> torch.Tensor:
            return torch.einsum("btd,dhk->bthk", x, p.weight) + p.bias

        q = project(self.query) / math.sqrt(self.head_dim)
        k = project(self.key)
        v = project(self.value)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        h = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return torch.einsum("bqhd,hdo->bqo", h, self.out.weight) + self.out.bias


def _refuse_parallel(attention_fn, mlp_constraint, moe_experts,
                     moe_constraint) -> None:
    hooks = {"attention_fn": attention_fn is not None,
             "mlp_constraint": mlp_constraint is not None,
             "moe_experts": moe_experts > 0,
             "moe_constraint": moe_constraint is not None}
    named = [k for k, on in hooks.items() if on]
    if named:
        raise NotImplementedError(
            f"TransformerBlock {', '.join(named)} comes with "
            f"{slices.PARALLEL}")


class TransformerBlock(nn.Module):
    """Pre-norm block: attention then a gelu MLP, each residual."""

    def __init__(self, dim: int, heads: int = 8, mlp_ratio: int = 4,
                 attention_fn: Callable | None = None,
                 mlp_constraint: Callable | None = None,
                 moe_experts: int = 0,
                 moe_constraint: Callable | None = None):
        super().__init__()
        _refuse_parallel(attention_fn, mlp_constraint, moe_experts,
                         moe_constraint)
        self.LayerNorm_0 = layer_norm(dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, heads)
        self.LayerNorm_1 = layer_norm(dim)
        self.Dense_0 = nn.Linear(dim, dim * mlp_ratio)
        self.Dense_1 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)


class ActionDecoder(nn.Module):
    """Clip of embeddings ``[B, T, in_dim]`` → class logits ``[B, C]``
    (action-recognition-0001-decoder counterpart). ``in_dim`` is the
    encoder's embedding (512; flax infers it from the example input)
    and ``T`` the clip length the ``pos_embed`` was made for."""

    def __init__(self, num_classes: int = 400, dim: int = 512,
                 depth: int = 4, heads: int = 8, in_dim: int = 512,
                 clip_len: int = CLIP_LEN,
                 attention_fn: Callable | None = None,
                 mlp_constraint: Callable | None = None,
                 moe_experts: int = 0,
                 moe_constraint: Callable | None = None):
        super().__init__()
        _refuse_parallel(attention_fn, mlp_constraint, moe_experts,
                         moe_constraint)
        self.depth = depth
        self.pos_embed = nn.Parameter(torch.zeros(1, clip_len, dim))
        self.Dense_0 = nn.Linear(in_dim, dim)
        for i in range(depth):
            self.add_module(f"TransformerBlock_{i}",
                            TransformerBlock(dim, heads))
        self.LayerNorm_0 = layer_norm(dim)
        self.Dense_1 = nn.Linear(dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(x) + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"TransformerBlock_{i}")(x)
        return self.Dense_1(self.LayerNorm_0(x).mean(dim=1))


class ActionRecognizer(nn.Module):
    """Fused encoder+decoder over a full clip ``[B, T, H, W, 3]``."""

    def __init__(self, num_classes: int = 400, embed_dim: int = 512):
        super().__init__()
        self.embed_dim = embed_dim
        self.ActionEncoder_0 = ActionEncoder(embed_dim)
        self.ActionDecoder_0 = ActionDecoder(num_classes, embed_dim,
                                             in_dim=embed_dim)

    def forward(self, clip: torch.Tensor) -> torch.Tensor:
        b, t = clip.shape[:2]
        emb = self.ActionEncoder_0(clip.reshape((b * t,) + clip.shape[2:]))
        return self.ActionDecoder_0(emb.reshape(b, t, self.embed_dim))
