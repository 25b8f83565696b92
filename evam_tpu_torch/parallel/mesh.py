"""Process meshes over ``torch.distributed`` (counterpart of
``evam_tpu/parallel/mesh.py`` and of the mesh helpers of
``evam_tpu/parallel/train.py`` and ``pipeline.py``).

The reference lays a ``jax.sharding.Mesh`` over devices and lets
``shard_map`` and XLA place the collectives. Here a mesh is a layout of
the process group's ranks, one device per rank: ``ProcessMesh(shape,
axes)`` puts rank ``r`` at the row-major coordinates of ``r`` in
``shape`` (the order ``np.reshape`` gives the reference's device array)
and builds one process group per axis line through the rank, and for
any product of axes asked for (the training mesh's data × seq, over
which gradients are reduced). Every rank builds the same groups in the
same order, as ``dist.new_group`` requires.

* :func:`initialize_distributed` reads the reference's own variables
  (``JAX_COORDINATOR``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) and
  joins the process group: ``nccl`` on the card, ``gloo`` on the CPU.
* :func:`launch` runs a function on N ranks of a fresh process group on
  this host (``spawn`` start method, ``file://`` rendezvous in a
  temporary directory, so no TCP port can collide); :class:`World`
  keeps the ranks for several runs.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from evam_tpu_torch.device import resolve_device
from evam_tpu_torch.parallel.comm import SINGLE, AxisGroup

log = logging.getLogger("evam_tpu_torch.parallel.mesh")


def initialize_distributed(device: str | torch.device | None = None) -> bool:
    """Multi-host init from the reference's environment
    (``JAX_COORDINATOR`` host:port, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``); a no-op when they are unset or the count is 1.
    ``device`` picks the backend: the card (the default) takes ``nccl``,
    the CPU ``gloo``. Returns whether it joined a group."""
    coord = os.environ.get("JAX_COORDINATOR")
    nproc = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if not coord or nproc <= 1:
        return False
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}", world_size=nproc,
        rank=int(os.environ.get("JAX_PROCESS_ID", "0")))
    log.info("torch.distributed initialized: %d processes (%s)", nproc,
             backend)
    return True


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ProcessMesh:
    """The world's first ``prod(shape)`` ranks laid out as ``shape``
    over ``axes``; ``groups`` lists extra axis products to build a
    group for. A rank outside the mesh has ``coords`` None."""

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...],
                 groups: tuple[tuple[str, ...], ...] = ()):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} does not match axes {axes}")
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        world, rank = _world()
        if self.size > world:
            raise ValueError(f"mesh {dict(self.shape)} needs {self.size} "
                             f"ranks, the world has {world}")
        self.rank = rank
        self.coords: dict[str, int] | None = None
        if rank < self.size:
            rest, coords = rank, {}
            for ax in reversed(self.axes):
                rest, coords[ax] = divmod(rest, self.shape[ax])
            self.coords = {ax: coords[ax] for ax in self.axes}
        self._groups: dict[tuple[str, ...], AxisGroup] = {}
        for combo in [(ax,) for ax in self.axes] + [tuple(g) for g in groups]:
            self._groups[combo] = self._build(combo)

    def _rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for ax in self.axes:
            r = r * self.shape[ax] + coords[ax]
        return r

    def _build(self, combo: tuple[str, ...]) -> AxisGroup:
        """One group per line of ``combo`` through the mesh, built on
        every rank in the same order; returns this rank's."""
        size = math.prod(self.shape[ax] for ax in combo)
        if size == 1:
            return SINGLE if self.coords is None else AxisGroup(
                ranks=(self.rank,))
        others = [ax for ax in self.axes if ax not in combo]
        mine = SINGLE
        for fixed in itertools.product(*(range(self.shape[ax])
                                         for ax in others)):
            ranks = tuple(
                self._rank_of({**dict(zip(others, fixed)),
                               **dict(zip(combo, free))})
                for free in itertools.product(*(range(self.shape[ax])
                                                for ax in combo)))
            group = dist.new_group(list(ranks))
            if self.rank in ranks:
                mine = AxisGroup(size=size, index=ranks.index(self.rank),
                                 ranks=ranks, group=group)
        return mine

    def axis(self, *names: str) -> AxisGroup:
        """This rank's group over one axis or a product built at
        construction."""
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is outside the mesh "
                               f"{dict(self.shape)}")
        return self._groups[tuple(names)]


def factor_mesh(n: int) -> tuple[int, int, int]:
    """Split n ranks into (data, seq, model) sizes, as the reference
    does: model and seq each take a factor of 2 when available (tp
    all-reduces every layer, sp rings once per attention, dp only
    reduces gradients)."""
    tp = 2 if n % 2 == 0 and n >= 8 else 1
    rem = n // tp
    sp = 2 if rem % 2 == 0 else 1
    dp = rem // sp
    return dp, sp, tp


TRAIN_AXES = ("data", "seq", "model")


def build_train_mesh(shape: tuple[int, int, int] | None = None
                     ) -> ProcessMesh:
    """The (data, seq, model) training mesh over every rank of the
    world (one rank without a process group), with the data × seq group
    the gradients are reduced over."""
    n = _world()[0]
    dp, sp, tp = shape if shape is not None else factor_mesh(n)
    if dp * sp * tp != n:
        raise ValueError(f"mesh {dp}x{sp}x{tp} != {n} devices")
    return ProcessMesh((dp, sp, tp), TRAIN_AXES, groups=(("data", "seq"),))


def build_pipe_mesh(n_stages: int | None = None) -> ProcessMesh:
    """A one-axis ``pipe`` mesh over the world's first ``n_stages``
    ranks (default: all)."""
    return ProcessMesh((n_stages or _world()[0],), ("pipe",))


# ------------------------------------------------------------ launching


def _rank_main(rank: int, world: int, backend: str, jobs, results) -> None:
    """A rank's loop: one job at a time, each in a process group of its
    own (``file://`` rendezvous), destroyed after the job."""
    torch.set_num_threads(1)
    while True:
        job = jobs.get()
        if job is None:
            return
        store, size, fn, args = job
        if rank >= size:
            continue
        try:
            dist.init_process_group(backend, init_method=f"file://{store}",
                                    world_size=size, rank=rank)
            try:
                out = fn(*args)
            finally:
                dist.destroy_process_group()
            results.put((rank, True, out))
        except BaseException:  # noqa: BLE001 — reported to the caller
            results.put((rank, False, traceback.format_exc()))


class RankFailed(RuntimeError):
    """A rank raised, died or outlived its time."""


class World:
    """``n`` rank processes on this host, started once (``spawn``) and
    given jobs by :meth:`run`: each job joins a fresh process group of
    the size it asks for, so one ``World`` runs meshes of several
    sizes. A job that raises, a rank that dies and a job that outlives
    ``timeout`` fail :meth:`run`; the last two stop every rank."""

    def __init__(self, n: int, backend: str = "gloo"):
        self.n, self.backend = n, backend
        self._dir = tempfile.mkdtemp(prefix="evam-world-")
        self._jobs_done = 0
        ctx = multiprocessing.get_context("spawn")
        self._jobs = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, n, backend, self._jobs[r],
                                         self._results),
                                   name=f"evam-rank-{r}", daemon=True)
                       for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args: Any, size: int | None = None,
            timeout: float = 120.0) -> list[Any]:
        """``fn(*args)`` on ranks ``0..size-1`` (default: all) inside
        one process group; returns their results in rank order."""
        size = self.n if size is None else size
        if not 1 <= size <= self.n:
            raise ValueError(f"a job of {size} ranks in a world of {self.n}")
        if self._procs is None:
            raise RankFailed("the world was stopped")
        self._jobs_done += 1
        store = os.path.join(self._dir, f"job{self._jobs_done}")
        for q in self._jobs:
            q.put((store, size, fn, args))
        got: dict[int, Any] = {}
        errors: list[str] = []
        deadline = time.monotonic() + timeout
        while len(got) + len(errors) < size:
            try:
                rank, ok, out = self._results.get(timeout=0.2)
            except queue.Empty:
                dead = [p.name for p in self._procs if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    self.stop()
                    why = (f"ranks {dead} died" if dead else
                           f"the job outlived its {timeout} s")
                    raise RankFailed(f"{getattr(fn, '__name__', fn)}: {why}"
                                     + "".join(errors)) from None
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"\n--- rank {rank}:\n{out}")
        if errors:
            raise RankFailed(f"{getattr(fn, '__name__', fn)} failed on "
                             f"{len(errors)} rank(s):" + "".join(errors))
        return [got[r] for r in range(size)]

    def stop(self) -> None:
        """Stop every rank (killing one that does not exit)."""
        procs, self._procs = self._procs, None
        if procs is None:
            return
        for q in self._jobs:
            q.put(None)
        # an idle rank exits at once; a busy or hung one is killed
        deadline = time.monotonic() + 1
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        for q in [*self._jobs, self._results]:
            q.close()
            q.cancel_join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def launch(world: int, fn: Callable, *args: Any, backend: str = "gloo",
           timeout: float = 120.0) -> list[Any]:
    """Run ``fn(*args)`` on ``world`` fresh ranks of one process group
    (``spawn``, ``file://`` rendezvous, one thread each) and return
    their results in rank order. ``fn`` must be importable by name. A
    rank that raises, dies or hangs past ``timeout`` fails the call and
    never hangs the caller."""
    with World(world, backend) as w:
        return w.run(fn, *args, timeout=timeout)
