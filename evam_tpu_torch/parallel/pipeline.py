"""Pipeline parallelism: GPipe microbatch rotation over a ``pipe`` mesh
axis (counterpart of ``evam_tpu/parallel/pipeline.py``).

Stage s runs slice s of a stack of stage parameters. Microbatches enter
at stage 0; after each tick every stage hands its output to the next
(:func:`comm.ring_shift`, an isend/irecv pair whose backward sends the
gradient back), and after S + M - 1 ticks every microbatch has crossed
every stage. As in the reference every rank runs every tick: the fill
and drain ticks compute on what the ring holds and are masked out of
the result, so every hop takes part in the backward on every rank
(an unmatched send would leave its peer waiting). The last stage's
outputs are summed over the axis, so every rank holds them.
"""

from __future__ import annotations

from typing import Callable

import torch

from evam_tpu_torch.parallel import comm
from evam_tpu_torch.parallel.mesh import ProcessMesh, build_pipe_mesh

__all__ = ["build_pipe_mesh", "pipeline_apply", "stack_stage_params"]


def stack_stage_params(param_list: list[dict[str, torch.Tensor]]
                       ) -> dict[str, torch.Tensor]:
    """[per-stage ``state_dict``s] → one dict with a leading stage axis."""
    return {k: torch.stack([p[k] for p in param_list])
            for k in param_list[0]}


def pipeline_apply(apply_fn: Callable, stacked_params: dict[str, torch.Tensor],
                   x: torch.Tensor, mesh: ProcessMesh, pipe_axis: str = "pipe",
                   microbatches: int | None = None) -> torch.Tensor:
    """Run ``x`` through the S pipelined stages of ``mesh``.

    ``apply_fn(stage_params, h) -> h`` applies ONE stage (shape
    preserving); ``stacked_params`` has a leading stage axis of size S
    (this rank reads its own slice, so a gradient reaches that slice
    only); ``x`` ``[M, mb, ...]`` holds the microbatches (M defaults to
    S). Returns ``[M, mb, ...]``, on every rank. Under autograd the
    output's gradient is taken to be the same on every rank (the
    gather's backward is the identity, as for the reference's
    replicated output)."""
    axis = mesh.axis(pipe_axis)
    n_stages, me = axis.size, axis.index
    m = x.shape[0] if microbatches is None else microbatches
    if x.shape[0] != m:
        raise ValueError(f"x leading dim {x.shape[0]} != microbatches {m}")
    params = {k: v[me] for k, v in stacked_params.items()}
    first = 1.0 if me == 0 else 0.0
    buf = torch.zeros_like(x[0])
    outs = [torch.zeros_like(x[0]) for _ in range(m)]
    for t in range(m + n_stages - 1):
        # stage 0 takes microbatch t (clamped); the others the hop's
        # arrival — blended, so the arrival is in the graph on every rank
        inp = x[min(t, m - 1)] * first + buf * (1.0 - first)
        out = apply_fn(params, inp)
        # the last stage finished microbatch t - (S - 1) this tick
        done = min(max(t - (n_stages - 1), 0), m - 1)
        valid = 1.0 if me == n_stages - 1 and t >= n_stages - 1 else 0.0
        outs[done] = out * valid + outs[done] * (1.0 - valid)
        if t + 1 < m + n_stages - 1:
            buf = comm.ring_shift(out, axis)
    result = torch.stack(outs)
    if me != n_stages - 1:
        result = result * 0.0
    return comm.reduce_from_group(result, axis)
