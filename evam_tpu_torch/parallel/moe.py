"""Mixture-of-experts MLP with expert parallelism (counterpart of
``evam_tpu/parallel/moe.py``).

E experts behind a learned softmax router; dense dispatch (every expert
runs on every token, outputs weighted by the gate), as in the
reference. The parameters keep the reference's names and shapes:
``router`` (a Dense), ``experts_up`` ``[E, D, H]``, ``experts_up_bias``
``[E, H]``, ``experts_down`` ``[E, H, D]``, ``experts_down_bias``
``[E, D]``.

Expert parallelism shares the tensor-parallel ``model`` group: a rank
holds ``E/tp`` experts (the leading axis of each expert tensor, as the
reference's ``P("model")``), runs them on the replicated tokens, and
the router-weighted combine is summed over the group. The router stays
replicated; the tokens and the gates enter the local experts through
:func:`comm.copy_to_group`, so the router's gradient is whole on every
rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from evam_tpu_torch.parallel import comm


class MoeMlp(nn.Module):
    def __init__(self, dim: int, num_experts: int = 4, mlp_ratio: int = 4,
                 tensor_parallel: comm.AxisGroup = comm.SINGLE):
        super().__init__()
        tp = tensor_parallel
        if num_experts % tp.size:
            raise ValueError(f"{num_experts} experts do not split over "
                             f"{tp.size} model shards")
        e, h = num_experts // tp.size, dim * mlp_ratio
        self.tp = tp
        self.router = nn.Linear(dim, num_experts)
        self.experts_up = nn.Parameter(torch.empty(e, dim, h))
        self.experts_up_bias = nn.Parameter(torch.zeros(e, h))
        self.experts_down = nn.Parameter(torch.empty(e, h, dim))
        self.experts_down_bias = nn.Parameter(torch.zeros(e, dim))

    @torch.no_grad()
    def reset_experts(self, generator: torch.Generator) -> None:
        """flax's ``lecun_normal`` on the expert kernels (the expert axis
        counts in the fan-in, as flax's receptive field) and zero biases;
        meant for the unsharded module."""
        for w in (self.experts_up, self.experts_down):
            fan_in = w.shape[0] * w.shape[1]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        self.experts_up_bias.zero_()
        self.experts_down_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gates = torch.softmax(self.router(x), dim=-1)  # [B, T, E]
        e = self.experts_up.shape[0]
        lo = self.tp.index * e
        xe = comm.copy_to_group(x, self.tp)
        ge = comm.copy_to_group(gates, self.tp)[..., lo:lo + e]
        hidden = torch.einsum("btd,edh->bteh", xe, self.experts_up)
        hidden = F.gelu(hidden + self.experts_up_bias, approximate="tanh")
        out = torch.einsum("bteh,ehd->bted", hidden, self.experts_down)
        out = out + self.experts_down_bias
        # the router-weighted combine reduces the expert axis, over the
        # group when the experts are sharded
        return comm.reduce_from_group(
            torch.einsum("bted,bte->btd", out, ge), self.tp)
