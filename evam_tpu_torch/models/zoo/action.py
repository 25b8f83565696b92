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
reference computes it in flax outside any Pallas kernel.

The reference's parallel hooks carry over (``evam_tpu_torch/parallel``):

* ``attention_fn(q, k, v)`` swaps the attention computation (ring or
  Ulysses sequence parallelism) and gets the unscaled projections
  ``[B, T, H, hd]``, as flax hands them to its ``attention_fn``;
* ``tensor_parallel`` (an ``AxisGroup`` of the ``model`` axis) holds a
  1/tp share of the weights, in ``param_spec``'s layout
  (``evam_tpu/parallel/train.py``): attention heads, ``Dense_0``'s
  columns, ``Dense_1``'s rows, the MoE experts. Megatron's conjugate
  exchanges (``parallel/comm.py``) stand where the reference passes a
  sharding constraint (``mlp_constraint``, ``moe_constraint``);
* ``moe_experts`` > 0 swaps the MLP for ``parallel/moe.py``'s
  ``MoeMlp``;
* ``ActionDecoder``'s ``sequence_parallel`` (the ``seq`` axis) takes
  this rank's block of the clip: its slice of ``pos_embed``, and a
  pooled mean summed over the axis.

The ``state_dict`` names stay the reference's; under tensor parallelism
the sharded entries hold this rank's slice.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from evam_tpu_torch.models.zoo.layers import ConvBlock, SeparableConv
from evam_tpu_torch.parallel import comm
from evam_tpu_torch.parallel.moe import MoeMlp

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
    with ``qkv_features`` = ``out_features`` = the input's dim. Under
    ``tensor_parallel`` the rank holds heads/tp heads and the output
    projection's partial sums are reduced over the group before its
    bias."""

    def __init__(self, dim: int, heads: int,
                 attention_fn: Callable | None = None,
                 tensor_parallel: comm.AxisGroup = comm.SINGLE):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        if heads % tensor_parallel.size:
            raise ValueError(f"{heads} heads do not split over "
                             f"{tensor_parallel.size} model shards")
        hd = dim // heads
        h = heads // tensor_parallel.size
        self.head_dim = hd
        self.attention_fn = attention_fn
        self.tp = tensor_parallel
        self.query = _DenseGeneral((dim, h, hd), (h, hd))
        self.key = _DenseGeneral((dim, h, hd), (h, hd))
        self.value = _DenseGeneral((dim, h, hd), (h, hd))
        self.out = _DenseGeneral((h, hd, dim), (dim,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = comm.copy_to_group(x, self.tp)

        def project(p: _DenseGeneral) -> torch.Tensor:
            return torch.einsum("btd,dhk->bthk", x, p.weight) + p.bias

        if self.attention_fn is not None:
            h = self.attention_fn(project(self.query), project(self.key),
                                  project(self.value))
        else:
            q = project(self.query) / math.sqrt(self.head_dim)
            k = project(self.key)
            v = project(self.value)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
            weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
            h = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        out = torch.einsum("bqhd,hdo->bqo", h, self.out.weight)
        return comm.reduce_from_group(out, self.tp) + self.out.bias


class TransformerBlock(nn.Module):
    """Pre-norm block: attention then a gelu MLP (or, with
    ``moe_experts``, a mixture of experts), each residual. Under
    ``tensor_parallel`` ``Dense_0`` is column-parallel and ``Dense_1``
    row-parallel (its bias added once, after the reduction)."""

    def __init__(self, dim: int, heads: int = 8, mlp_ratio: int = 4,
                 attention_fn: Callable | None = None,
                 tensor_parallel: comm.AxisGroup = comm.SINGLE,
                 moe_experts: int = 0):
        super().__init__()
        tp = tensor_parallel
        self.tp = tp
        self.LayerNorm_0 = layer_norm(dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, heads, attention_fn, tp)
        self.LayerNorm_1 = layer_norm(dim)
        self.moe = moe_experts > 0
        if self.moe:
            self.MoeMlp_0 = MoeMlp(dim, moe_experts, mlp_ratio, tp)
        else:
            hidden = dim * mlp_ratio
            if hidden % tp.size:
                raise ValueError(f"MLP width {hidden} does not split over "
                                 f"{tp.size} model shards")
            self.Dense_0 = nn.Linear(dim, hidden // tp.size)
            self.Dense_1 = nn.Linear(hidden // tp.size, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        h = self.LayerNorm_1(x)
        if self.moe:
            return x + self.MoeMlp_0(h)
        h = F.gelu(self.Dense_0(comm.copy_to_group(h, self.tp)),
                   approximate="tanh")
        h = comm.reduce_from_group(F.linear(h, self.Dense_1.weight), self.tp)
        return x + (h + self.Dense_1.bias)


class ActionDecoder(nn.Module):
    """Clip of embeddings ``[B, T, in_dim]`` → class logits ``[B, C]``
    (action-recognition-0001-decoder counterpart). ``in_dim`` is the
    encoder's embedding (512; flax infers it from the example input)
    and ``T`` the clip length the ``pos_embed`` was made for. Under
    ``sequence_parallel`` the input is this rank's block of T/sp
    positions."""

    def __init__(self, num_classes: int = 400, dim: int = 512,
                 depth: int = 4, heads: int = 8, in_dim: int = 512,
                 clip_len: int = CLIP_LEN,
                 attention_fn: Callable | None = None,
                 tensor_parallel: comm.AxisGroup = comm.SINGLE,
                 moe_experts: int = 0,
                 sequence_parallel: comm.AxisGroup = comm.SINGLE):
        super().__init__()
        self.depth = depth
        self.seq = sequence_parallel
        self.pos_embed = nn.Parameter(torch.zeros(1, clip_len, dim))
        self.Dense_0 = nn.Linear(in_dim, dim)
        for i in range(depth):
            self.add_module(f"TransformerBlock_{i}", TransformerBlock(
                dim, heads, attention_fn=attention_fn,
                tensor_parallel=tensor_parallel, moe_experts=moe_experts))
        self.LayerNorm_0 = layer_norm(dim)
        self.Dense_1 = nn.Linear(dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = self.pos_embed
        if self.seq.size > 1:
            t = x.shape[1]
            pos = pos[:, self.seq.index * t:(self.seq.index + 1) * t]
        x = self.Dense_0(x) + pos
        for i in range(self.depth):
            x = getattr(self, f"TransformerBlock_{i}")(x)
        x = self.LayerNorm_0(x)
        if self.seq.size > 1:
            pooled = comm.all_reduce(x.sum(dim=1), self.seq) / (
                x.shape[1] * self.seq.size)
        else:
            pooled = x.mean(dim=1)
        return self.Dense_1(pooled)


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
