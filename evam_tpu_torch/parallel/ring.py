"""Ring attention: sequence-parallel attention over a mesh axis
(counterpart of ``evam_tpu/parallel/ring.py``).

Each rank holds one block of the sequence (and, under tensor
parallelism, its share of the heads). The K/V blocks travel round the
``seq`` ring, one hop a step (:func:`comm.ring_shift`, an isend/irecv
pair whose backward sends the gradient the other way, ``ppermute``'s
transpose), while every rank accumulates its queries' output with the
online softmax: a running max and sum in float32, as in the reference's
``_ring_attention_kernel`` (a ``shard_map`` body in plain ``jnp``, no
Pallas kernel, so plain torch here too).

The tensors this module takes are the rank's own shards ``[B/dp, T/sp,
H/tp, D]``, not global arrays: the port runs one program per rank.
"""

from __future__ import annotations

from typing import Callable

import torch

from evam_tpu_torch.parallel import comm
from evam_tpu_torch.parallel.mesh import ProcessMesh

NEG_INF = -1e30


def _axis_size(mesh: ProcessMesh, name: str | None) -> int:
    return mesh.shape.get(name, 1) if name else 1


def _ring_loop(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               axis: comm.AxisGroup, causal: bool,
               scale: float) -> torch.Tensor:
    """The rank's queries against every K/V block of the ring, its own
    block first. Block i is the one owned by ring member (me - i) mod n."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    n, me = axis.size, axis.index
    qf = q.float() * scale
    o = qf.new_zeros((b, h, tq, d))
    m = qf.new_full((b, h, tq), NEG_INF)
    l = qf.new_zeros((b, h, tq))
    kv = torch.stack([k, v])  # one hop carries both blocks
    for i in range(n):
        k_blk, v_blk = kv[0], kv[1]
        owner = (me - i) % n
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())
        if causal:
            q_pos = me * tq + torch.arange(tq, device=q.device)
            k_pos = owner * tk + torch.arange(tk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                v_blk.float())
        m = m_new
        if i + 1 < n:  # the reference's last hop only brings blocks home
            kv = comm.ring_shift(kv, axis)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # [B, Tq, H, D]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: ProcessMesh, *, seq_axis: str = "seq",
                   head_axis: str | None = "model",
                   causal: bool = False) -> torch.Tensor:
    """Sequence-parallel attention of this rank's shards ``[B, Tl, H, D]``
    over ``mesh.shape[seq_axis]`` blocks. Heads ride ``head_axis``
    (independent in attention: no exchange). A seq axis of one with a
    head axis of one is :func:`plain_attention`."""
    n = _axis_size(mesh, seq_axis)
    scale = q.shape[-1] ** -0.5
    if n == 1 and _axis_size(mesh, head_axis) == 1:
        return plain_attention(q, k, v, causal=causal, scale=scale)
    return _ring_loop(q, k, v, mesh.axis(seq_axis), causal, scale)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Single-rank attention in the same layout, float32 inside."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        mask = (torch.arange(t_q, device=q.device)[:, None]
                >= torch.arange(t_k, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def make_attention_fn(mesh: ProcessMesh, *, seq_axis: str = "seq",
                      head_axis: str | None = "model",
                      causal: bool = False) -> Callable:
    """Ring attention as the decoder's ``attention_fn(q, k, v)`` (the
    counterpart of ``make_flax_attention_fn``): the attention's
    parameters are unchanged, only the computation swaps."""

    def attention_fn(query, key, value):
        return ring_attention(query, key, value, mesh, seq_axis=seq_axis,
                              head_axis=head_axis, causal=causal)

    return attention_fn
