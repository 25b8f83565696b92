"""Ulysses-style all-to-all sequence parallelism (counterpart of
``evam_tpu/parallel/ulysses.py``).

One ``all_to_all`` re-shards this rank's ``[B, T/n, H, D]`` shard to
``[B, T, H/n, D]`` (every position, a 1/n share of the heads), dense
attention runs locally on those heads, and a second ``all_to_all``
brings the sequence sharding back. Both exchanges are
:func:`comm.all_to_all`, whose backward is the inverse exchange. The
reference's ``_ulysses_kernel`` is a ``shard_map`` body in plain
``jnp``; this is plain torch.

Against the ring (``parallel/ring.py``): Q, K and V move once each way,
then one dense attention; but the sequence shards cannot outnumber the
heads (n must divide H).
"""

from __future__ import annotations

from typing import Callable

import torch

from evam_tpu_torch.parallel import comm
from evam_tpu_torch.parallel.mesh import ProcessMesh
from evam_tpu_torch.parallel.ring import plain_attention


def _seq_to_heads(x: torch.Tensor, axis: comm.AxisGroup) -> torch.Tensor:
    """``[B, Tl, H, D]`` → ``[B, n·Tl, H/n, D]``: head group j goes to
    member j; the sequence pieces come back in member order."""
    b, tl, h, d = x.shape
    n = axis.size
    x = x.reshape(b, tl, n, h // n, d).permute(2, 0, 1, 3, 4)
    x = comm.all_to_all(x, axis)  # [n (source), B, Tl, H/n, D]
    return x.permute(1, 0, 2, 3, 4).reshape(b, n * tl, h // n, d)


def _heads_to_seq(x: torch.Tensor, axis: comm.AxisGroup) -> torch.Tensor:
    """The inverse: ``[B, T, H/n, D]`` → ``[B, T/n, H, D]``."""
    b, t, hn, d = x.shape
    n = axis.size
    x = x.reshape(b, n, t // n, hn, d).permute(1, 0, 2, 3, 4)
    x = comm.all_to_all(x, axis)  # [n (source head group), B, Tl, H/n, D]
    return x.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * hn, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: ProcessMesh, *, seq_axis: str = "seq",
                      head_axis: str | None = "model",
                      causal: bool = False) -> torch.Tensor:
    """All-to-all sequence-parallel attention of this rank's shards
    ``[B, T/n, H/m, D]`` (n seq shards, m head shards). The global head
    count must divide by n·m (the length divides by n: the shards are
    equal, ``ActionTrainer.shard_batch`` checks it)."""
    n = mesh.shape.get(seq_axis, 1)
    m = mesh.shape.get(head_axis, 1) if head_axis else 1
    scale = q.shape[-1] ** -0.5
    if n == 1 and m == 1:
        return plain_attention(q, k, v, causal=causal, scale=scale)
    h = q.shape[2] * m
    if h % (n * m):
        raise ValueError(
            f"ulysses needs heads % (seq*model shards) == 0, got H={h} "
            f"seq={n} model={m} (use ring_attention to scale past the "
            "head count)"
        )
    axis = mesh.axis(seq_axis)
    qh, kh, vh = (_seq_to_heads(x, axis) for x in (q, k, v))
    out = plain_attention(qh, kh, vh, causal=causal, scale=scale)
    return _heads_to_seq(out, axis).to(q.dtype)


def make_attention_fn(mesh: ProcessMesh, *, seq_axis: str = "seq",
                      head_axis: str | None = "model",
                      causal: bool = False) -> Callable:
    """Ulysses as the decoder's ``attention_fn(q, k, v)`` (the same
    contract as ``ring.make_attention_fn``)."""

    def attention_fn(query, key, value):
        return ulysses_attention(query, key, value, mesh,
                                 seq_axis=seq_axis, head_axis=head_axis,
                                 causal=causal)

    return attention_fn
