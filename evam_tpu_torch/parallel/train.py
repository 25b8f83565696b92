"""Distributed training of the action recognizer: dp × sp × tp (and MoE
expert parallelism) over one process mesh (counterpart of
``evam_tpu/parallel/train.py``).

The reference jits one step over a ``(data, seq, model)`` device mesh
and lets XLA place the collectives. Here every rank runs the same
program on its own shards, and the exchanges are explicit:

* **data** (``data`` axis): the clip batch splits; gradients are summed
  over data × seq after the backward, in one all-reduce.
* **sequence** (``seq`` axis): the clip's frames split; the encoder
  sees this rank's frames only (more data parallelism), the decoder its
  block of positions, with ring attention (``parallel/ring.py``) or
  Ulysses (``parallel/ulysses.py``) inside and the pooled mean summed
  over the axis.
* **tensor** (``model`` axis): attention heads, the MLP's hidden width
  and the MoE experts split Megatron-style (``models/zoo/action.py``).

Each rank's objective is its share of the global mean loss: its clips'
summed negative log-likelihood over the global batch, divided by the
seq size (every seq rank of a data shard holds the same logits). The
exchanges over ``seq`` are true transposes, so the summed gradients are
those of the global mean; over ``model`` Megatron's pair keeps them
whole on every rank.

The step follows the reference's arithmetic: uint8 clips over 255, cast
to bfloat16 and, as flax promotes a bfloat16 input against float32
parameters, computed in float32 (no autocast); the encoder under
``torch.utils.checkpoint`` when ``remat_encoder`` is set; the loss the
mean of ``-log_softmax``; ``torch.optim.AdamW(lr, weight_decay)``, the
same decoupled update and defaults as ``optax.adamw``.

Port notes:

* :meth:`ActionTrainer.state_from_jax` carries a reference train state
  (params and optax's ``mu``/``nu``/``count``) onto this rank's shards;
* the reference checkpoints with orbax, which the card's machine lacks:
  :meth:`ActionTrainer.save_checkpoint` writes one ``torch.save`` file
  of the whole (gathered) state, which restores onto any mesh layout. A
  port checkpoint is not an orbax checkpoint, and orbax cannot read it.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from evam_tpu_torch.device import resolve_device
from evam_tpu_torch.models.convert import params_from_jax
from evam_tpu_torch.models.registry import init_params
from evam_tpu_torch.models.zoo.action import ActionDecoder, ActionEncoder
from evam_tpu_torch.parallel import comm, ring, ulysses
from evam_tpu_torch.parallel.mesh import ProcessMesh


@dataclasses.dataclass
class ActionTrainConfig:
    num_classes: int = 400
    embed_dim: int = 512
    depth: int = 4
    heads: int = 8
    encoder_width: int = 32
    frame_size: tuple[int, int] = (224, 224)
    clip_len: int = 16
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    remat_encoder: bool = True
    #: > 0 enables the mixture-of-experts decoder MLP (expert
    #: parallelism over the model axis, parallel/moe.py)
    moe_experts: int = 0
    #: sequence-parallel attention strategy: "ring" (K/V ring, scales
    #: past the head count) or "ulysses" (all-to-all head exchange;
    #: needs heads % seq == 0)
    sp_strategy: str = "ring"


def shard_dim(name: str, ndim: int) -> int | None:
    """The dimension of ``state_dict`` entry ``name`` (torch layout)
    that splits over the ``model`` axis, or None where it replicates:
    ``param_spec``'s placement (``evam_tpu/parallel/train.py``)."""
    if "MoeMlp" in name:
        return 0 if "experts" in name else None
    if "MultiHeadDotProductAttention" in name:
        # q/k/v weights [D, H, hd], biases [H, hd]; out weight [H, hd, D]
        if ".out." in name:
            return 0 if ndim >= 2 else None
        return {3: 1, 2: 0}.get(ndim)
    if "TransformerBlock" in name and ".Dense_0." in name:
        return 0  # column-parallel: weight [4D, D], bias [4D]
    if "TransformerBlock" in name and ".Dense_1." in name:
        return 1 if ndim == 2 else None  # row-parallel: weight [D, 4D]
    return None


@dataclasses.dataclass
class TrainState:
    """One rank's training state: its shards of the encoder and decoder
    (``model["enc"]``, ``model["dec"]``), their AdamW state and the step
    count."""

    model: nn.ModuleDict
    optimizer: torch.optim.AdamW
    step: int = 0


def _adam_moments(opt_state) -> tuple[int, Any, Any]:
    """optax ``scale_by_adam``'s (count, mu, nu) out of an ``adamw``
    state (a tuple of named tuples), or of a mapping with those keys."""
    if isinstance(opt_state, Mapping) and "mu" in opt_state:
        return (int(np.asarray(opt_state["count"])), opt_state["mu"],
                opt_state["nu"])
    if all(hasattr(opt_state, k) for k in ("mu", "nu", "count")):
        return int(np.asarray(opt_state.count)), opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            try:
                return _adam_moments(part)
            except ValueError:
                continue
    raise ValueError("no adam state (mu, nu, count) in the optimizer state")


class ActionTrainer:
    """The models, the optimizer and the step of one rank of ``mesh``."""

    def __init__(self, mesh: ProcessMesh, config: ActionTrainConfig,
                 device: str | torch.device | None = None):
        self.mesh = mesh
        self.config = config
        self.device = resolve_device(device)
        self.data = mesh.axis("data")
        self.seq = mesh.axis("seq")
        self.tp = mesh.axis("model")
        #: the axes gradients are summed over
        self.grad_axis = mesh.axis("data", "seq")
        if config.sp_strategy == "ulysses":
            self.attention_fn = ulysses.make_attention_fn(mesh)
        elif config.sp_strategy == "ring":
            self.attention_fn = ring.make_attention_fn(mesh)
        else:
            raise ValueError(f"unknown sp_strategy {config.sp_strategy!r}")

    # ------------------------------------------------------------ state

    def _modules(self, sharded: bool) -> nn.ModuleDict:
        cfg = self.config
        enc = ActionEncoder(embed_dim=cfg.embed_dim, width=cfg.encoder_width)
        dec = ActionDecoder(
            num_classes=cfg.num_classes, dim=cfg.embed_dim, depth=cfg.depth,
            heads=cfg.heads, in_dim=cfg.embed_dim, clip_len=cfg.clip_len,
            attention_fn=self.attention_fn if sharded else None,
            tensor_parallel=self.tp if sharded else comm.SINGLE,
            moe_experts=cfg.moe_experts,
            sequence_parallel=self.seq if sharded else comm.SINGLE)
        return nn.ModuleDict({"enc": enc, "dec": dec})

    def _local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole ``state_dict`` entry."""
        dim = shard_dim(name, full.dim())
        if dim is None or self.tp.size == 1:
            return full
        n = full.shape[dim] // self.tp.size
        return full.narrow(dim, self.tp.index * n, n)

    def _state(self, params: dict[str, torch.Tensor], step: int = 0,
               adam: tuple[dict, dict] | None = None) -> TrainState:
        """A state of this rank's shards from whole tensors: the params
        and, when given, AdamW's moments after ``step`` steps."""
        model = self._modules(sharded=True)
        model.load_state_dict({k: self._local(k, v) for k, v in params.items()})
        model.to(self.device)
        opt = torch.optim.AdamW(model.parameters(),
                                lr=self.config.learning_rate,
                                weight_decay=self.config.weight_decay)
        if adam is not None:
            mu, nu = adam
            for name, p in model.named_parameters():
                opt.state[p] = {
                    "step": torch.tensor(float(step)),
                    "exp_avg": self._local(name, mu[name]).to(
                        self.device, torch.float32).clone(),
                    "exp_avg_sq": self._local(name, nu[name]).to(
                        self.device, torch.float32).clone()}
        return TrainState(model, opt, step)

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh params (flax's initializers, drawn from ``seed`` for the
        whole model, so every layout starts from the same weights)."""
        full = self._modules(sharded=False)
        init_params(full, torch.Generator().manual_seed(seed))
        return self._state(full.state_dict())

    def state_from_jax(self, jax_state) -> TrainState:
        """The reference's train state (``{"params", "opt_state",
        "step"}`` of ``ActionTrainer.init_state`` or a step) on this
        rank's shards. ``opt_state`` may be optax's own or a mapping of
        ``mu``, ``nu`` and ``count``."""
        count, mu, nu = _adam_moments(jax_state["opt_state"])
        params = params_from_jax(dict(jax_state["params"]))
        adam = (params_from_jax(dict(mu)), params_from_jax(dict(nu)))
        step = int(np.asarray(jax_state["step"]))
        if count != step:
            raise ValueError(f"adam count {count} != step {step}")
        return self._state(params, step, adam if step else None)

    # ------------------------------------------------------------- data

    def shard_batch(self, clips: np.ndarray, labels: np.ndarray
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's block of a global batch: clips ``[B, T, H, W, 3]``
        uint8 split over data (B) and seq (T), labels over data."""
        b, t = clips.shape[:2]
        dp, sp = self.data.size, self.seq.size
        if b % dp:
            raise ValueError(f"batch {b} not divisible by {dp} data shards")
        if t % sp:
            raise ValueError(f"sequence length {t} not divisible by {sp} "
                             "shards")
        bl, tl = b // dp, t // sp
        d, s = self.data.index, self.seq.index
        c = np.ascontiguousarray(clips[d * bl:(d + 1) * bl,
                                       s * tl:(s + 1) * tl])
        lbl = np.asarray(labels[d * bl:(d + 1) * bl], np.int64)
        return (torch.from_numpy(c).to(self.device),
                torch.from_numpy(lbl).to(self.device))

    # ------------------------------------------------------------- step

    def _forward(self, model: nn.ModuleDict, clips: torch.Tensor,
                 labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, t = clips.shape[:2]
        x = clips.float() / 255.0
        frames = x.reshape((b * t,) + x.shape[2:])
        # bfloat16 in, float32 parameters: flax computes in float32
        frames = frames.to(torch.bfloat16).float()
        if self.config.remat_encoder:
            emb = checkpoint(model["enc"], frames, use_reentrant=False)
        else:
            emb = model["enc"](frames)
        logits = model["dec"](emb.reshape(b, t, -1))
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(1, labels[:, None])[:, 0]
        return nll, logits.argmax(-1) == labels

    def loss_and_grads(self, state: TrainState, clips: torch.Tensor,
                       labels: torch.Tensor) -> dict[str, torch.Tensor]:
        """Forward and backward of one batch: leaves each parameter's
        ``.grad`` summed over data × seq (the gradient of the global mean
        loss, this rank's shard of it) and returns the global loss and
        accuracy."""
        model = state.model
        model.zero_grad(set_to_none=True)
        nll, correct = self._forward(model, clips, labels)
        batch = labels.shape[0] * self.data.size
        (nll.sum() / (batch * self.seq.size)).backward()
        params = [p for p in model.parameters()]
        if self.grad_axis.size > 1:
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            dist.all_reduce(flat, group=self.grad_axis.group)
            offset = 0
            for p in params:
                n = p.numel()
                p.grad.copy_(flat[offset:offset + n].view_as(p))
                offset += n
        sums = torch.stack([nll.detach().sum(), correct.float().sum()])
        if self.data.size > 1:
            dist.all_reduce(sums, group=self.data.group)
        sums = sums / batch
        return {"loss": sums[0], "accuracy": sums[1]}

    def train_step(self, state: TrainState, clips: torch.Tensor,
                   labels: torch.Tensor) -> tuple[TrainState, dict]:
        """One AdamW step on this rank's batch block (``shard_batch``);
        returns the state (updated in place) and ``{"loss",
        "accuracy"}`` of the batch before the update."""
        metrics = self.loss_and_grads(state, clips, labels)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    # ------------------------------------------------------ checkpoints

    def gather(self, tensors: dict[str, torch.Tensor]
               ) -> dict[str, torch.Tensor]:
        """Whole tensors from this rank's shards (keyed by ``state_dict``
        name), on the CPU: sharded entries gathered over ``model``."""
        out = {}
        for name, t in tensors.items():
            dim = shard_dim(name, t.dim())
            if dim is not None:
                t = comm.all_gather(t, self.tp, dim)
            out[name] = t.detach().cpu().clone()
        return out

    def full_state(self, state: TrainState) -> dict[str, Any]:
        """The whole state: params, AdamW moments and the step."""
        named = dict(state.model.named_parameters())
        moments = {k: {} for k in ("exp_avg", "exp_avg_sq")}
        for name, p in named.items():
            st = state.optimizer.state.get(p)
            for k in moments:
                moments[k][name] = (st[k] if st else torch.zeros_like(p))
        return {"params": self.gather(named),
                "exp_avg": self.gather(moments["exp_avg"]),
                "exp_avg_sq": self.gather(moments["exp_avg_sq"]),
                "step": state.step}

    def save_checkpoint(self, state: TrainState, path) -> None:
        """Write the whole state to ``path`` (one file, rank 0 writes it;
        every rank returns once it is on disk)."""
        full = self.full_state(state)
        if self.mesh.rank == 0:
            path = os.path.abspath(os.fspath(path))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            torch.save(full, tmp)
            os.replace(tmp, path)
        if dist.is_initialized():
            dist.barrier()

    def restore_checkpoint(self, path) -> TrainState:
        """A state on this trainer's mesh from a checkpoint written on any
        layout."""
        full = torch.load(os.path.abspath(os.fspath(path)),
                          map_location="cpu", weights_only=True)
        step = int(full["step"])
        adam = (full["exp_avg"], full["exp_avg_sq"]) if step else None
        return self._state(full["params"], step, adam)


def build_action_trainer(mesh: ProcessMesh,
                         config: ActionTrainConfig | None = None,
                         device: str | torch.device | None = None
                         ) -> ActionTrainer:
    """The trainer of this rank of ``mesh`` (the card unless ``device``
    says otherwise)."""
    return ActionTrainer(mesh, config or ActionTrainConfig(), device)
