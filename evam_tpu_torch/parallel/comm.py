"""The exchanges the parallel layers make, as autograd functions.

``shard_map`` in the reference gives every collective its transpose
for free; here each one is a ``torch.autograd.Function`` over a process
group of one mesh axis (:class:`AxisGroup`). Two conventions meet:

* **true transposes**, where each rank's objective is its own share of
  the loss and the gradients of all ranks add up: :func:`all_reduce`
  (forward sum, backward sum), :func:`ring_shift` (``ppermute``: the
  backward sends the other way) and :func:`all_to_all` (the backward is
  the inverse exchange);
* **Megatron's conjugate pair** for tensor parallelism, where every
  rank of the group computes the same scalar: :func:`copy_to_group`
  (identity forward, sum backward) where a replicated activation enters
  sharded weights, and :func:`reduce_from_group` (sum forward, identity
  backward) where their partial outputs leave.

A group of one is the identity throughout, and needs no process group.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One rank's view of one mesh axis (or a product of axes): the
    group's size, this rank's index in it, and the global ranks of the
    group in index order. ``group`` is None for a group of one."""

    size: int = 1
    index: int = 0
    ranks: tuple[int, ...] = (0,)
    group: dist.ProcessGroup | None = None

    def peer(self, offset: int) -> int:
        """Global rank of the member ``offset`` places along the ring."""
        return self.ranks[(self.index + offset) % self.size]


SINGLE = AxisGroup()


def _sum(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis.group)
    return x


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.axis), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.axis), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _shift(x: torch.Tensor, axis: AxisGroup, offset: int) -> torch.Tensor:
    """Send ``x`` to the member ``offset`` along, receive from the one
    ``offset`` back: one isend/irecv pair, posted together."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, axis.peer(offset), axis.group),
           dist.P2POp(dist.irecv, out, axis.peer(-offset), axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _shift(x, axis, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.axis, -1), None


def _exchange(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """``x``'s leading axis (one chunk per member) exchanged: chunk j
    goes to member j, and chunk j of the result came from member j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.axis), None


def all_reduce(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Sum over the group; the backward sums the gradients (``psum``)."""
    return x if axis.size == 1 else _AllReduce.apply(x, axis)


def copy_to_group(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Megatron's *f*: identity forward, sum of gradients backward."""
    return x if axis.size == 1 else _CopyToGroup.apply(x, axis)


def reduce_from_group(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Megatron's *g*: sum forward, identity backward."""
    return x if axis.size == 1 else _ReduceFromGroup.apply(x, axis)


def ring_shift(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """``ppermute`` by one: member i's ``x`` goes to member i + 1; the
    result is member i - 1's. The backward sends the gradient back."""
    return x if axis.size == 1 else _RingShift.apply(x, axis)


def all_to_all(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Tiled ``all_to_all`` over the leading axis (size = the group's):
    chunk j goes to member j; the backward is the same exchange."""
    if x.shape[0] != axis.size:
        raise ValueError(f"leading axis {x.shape[0]} != group size "
                         f"{axis.size}")
    return x if axis.size == 1 else _AllToAll.apply(x, axis)


def all_gather(x: torch.Tensor, axis: AxisGroup, dim: int) -> torch.Tensor:
    """The group's pieces of ``x`` concatenated along ``dim``, in index
    order (no gradient: checkpoints and checks use it)."""
    if axis.size == 1:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)
