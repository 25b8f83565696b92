"""The parallel training path of the port (``evam_tpu_torch/parallel``)
against the reference's (``evam_tpu/parallel``), on the CPU.

The reference runs on the 8 virtual CPU devices ``conftest.py`` forces;
the port on gloo ranks of one :class:`World` (8 spawned processes, one
thread each, kept for the module; each job joins a fresh process group
of the size it needs). The same numpy inputs, drawn from a seed, go to
both; each rank returns its shard and the test puts the global array
together. The rank functions below import nothing of JAX (a spawned
rank imports this module); the reference is called in the test process
only, inside the tests.

Tolerances:

* attention (ring, Ulysses, plain) and its gradients: atol 1e-5, as the
  reference's own tests (float32; the online softmax sums the blocks in
  another order than one softmax, measured ~1e-7);
* the trainer at the small config (embed 32, depth 1, heads 4, 32×32
  clips of 4 frames, batch 4): loss and accuracy within 1e-5; the
  gradients, read through AdamW's first moment (``mu`` = (1 - b1)·g
  after the first step; after the second it mixes both steps'), within
  atol 1e-6 + rtol 1e-4, and the second moment within rtol 1e-3; the
  parameters after each step within atol 1e-6 wherever the reference's
  first gradient has |g| >= 1e-6, and within 2·lr everywhere: Adam's
  first step moves a parameter by lr·sign(g), so a gradient within
  rounding of zero may point either way. The masked entries are the
  attention's key biases (their exact gradient is zero: the softmax
  ignores a shift common to every key) and the encoder's dead relu6
  units (gradient exactly zero in both);
* the reference's own step at 2×2×2 doubles the gradient of the
  encoder's depthwise kernels (``SeparableConv_*/Conv_0``, the grouped
  convs) against its step at 1×1×1 on the same state, and only theirs:
  XLA's partitioning of the grouped conv's filter gradient on the
  virtual CPU mesh. The port gives the same gradient on every layout,
  so those kernels are held to the reference's 1×1×1 run, and the test
  asserts the factor of two, so a fixed reference shows here. The MoE
  step is held to the reference's 1×1×1 run whole;
* the pipeline's outputs: atol 1e-5; its gradients (sums over every
  microbatch, up to ~10): atol 1e-5 of each tensor's largest magnitude.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from evam_tpu_torch.models.convert import params_from_jax, params_to_jax
from evam_tpu_torch.parallel import pipeline, ring, train, ulysses
from evam_tpu_torch.parallel.mesh import (
    ProcessMesh,
    RankFailed,
    World,
    build_pipe_mesh,
    build_train_mesh,
    factor_mesh,
    initialize_distributed,
)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5
SMALL = dict(num_classes=8, embed_dim=32, depth=1, heads=4, encoder_width=4,
             frame_size=(32, 32), clip_len=4)
BATCH = 4


@pytest.fixture(scope="module")
def world():
    w = World(8)
    yield w
    w.stop()


def _batch(seed: int = 0, classes: int = 8):
    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 255, (BATCH, SMALL["clip_len"], 32, 32, 3),
                         np.uint8)
    labels = rng.integers(0, classes, (BATCH,)).astype(np.int32)
    return clips, labels


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _shard(x: np.ndarray, mesh: ProcessMesh, heads: bool = True):
    """This rank's [B/dp, T/sp, H/tp, ...] block of a global array."""
    c, s = mesh.coords, mesh.shape
    b, t = x.shape[0] // s["data"], x.shape[1] // s["seq"]
    out = x[c["data"] * b:(c["data"] + 1) * b, c["seq"] * t:(c["seq"] + 1) * t]
    if heads:
        h = x.shape[2] // s["model"]
        out = out[:, :, c["model"] * h:(c["model"] + 1) * h]
    return torch.from_numpy(np.ascontiguousarray(out))


def _unshard(blocks, shape):
    """Global array from the ranks' blocks (rank order = mesh order)."""
    dp, sp, tp = shape
    rows = [[np.concatenate([blocks[(d * sp + s) * tp + m] for m in range(tp)],
                            axis=2) for s in range(sp)] for d in range(dp)]
    return np.concatenate([np.concatenate(r, axis=1) for r in rows], axis=0)


# ------------------------------------------------------ rank functions


def _attention_rank(shape, strategy, causal, q, k, v, cot):
    """One rank's output and q/k/v gradients of attention at ``shape``."""
    mesh = build_train_mesh(shape)
    fn = ring.ring_attention if strategy == "ring" else \
        ulysses.ulysses_attention
    ql, kl, vl = (_shard(a, mesh).requires_grad_() for a in (q, k, v))
    out = fn(ql, kl, vl, mesh, causal=causal)
    (out * _shard(cot, mesh)).sum().backward()
    return [t.detach().numpy() for t in (out, ql.grad, kl.grad, vl.grad)]


def _ulysses_guard_rank(shape, q):
    mesh = build_train_mesh(shape)
    ql = _shard(q, mesh, heads=False)  # 3 heads a rank: H = 6, not % 4
    try:
        ulysses.ulysses_attention(ql, ql, ql, mesh)
    except ValueError as exc:
        return str(exc)
    return None


def _trainer_rank(shape, cfg, state, clips, labels, steps):
    """The port's trainer from a reference state: per step the metrics
    and the whole state after it (rank 0), and this rank's shards."""
    mesh = build_train_mesh(shape)
    trainer = train.build_action_trainer(
        mesh, train.ActionTrainConfig(**cfg), device="cpu")
    st = trainer.state_from_jax(state) if state is not None else \
        trainer.init_state(0)
    c, lbl = trainer.shard_batch(clips, labels)
    out = {"metrics": [], "full": [],
           "local_shapes": {k: tuple(v.shape)
                            for k, v in st.model.state_dict().items()}}
    for _ in range(steps):
        st, m = trainer.train_step(st, c, lbl)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        full = trainer.full_state(st)
        out["full"].append(full if mesh.rank == 0 else None)
    return out


def _checkpoint_rank(shape, cfg, clips, labels, path, action):
    mesh = build_train_mesh(shape)
    trainer = train.build_action_trainer(
        mesh, train.ActionTrainConfig(**cfg), device="cpu")
    c, lbl = trainer.shard_batch(clips, labels)
    if action == "save":
        st = trainer.init_state(0)
        st, _ = trainer.train_step(st, c, lbl)
        trainer.save_checkpoint(st, path)
    else:
        st = trainer.restore_checkpoint(path)
    restored = trainer.full_state(st)
    st, m = trainer.train_step(st, c, lbl)
    return {"state": restored if mesh.rank == 0 else None,
            "next_loss": float(m["loss"])}


def _pipeline_rank(n_stages, stage_states, x, dim, heads, cot):
    from evam_tpu_torch.models.zoo.action import TransformerBlock

    mesh = build_pipe_mesh(n_stages)
    block = TransformerBlock(dim, heads)
    stacked = {k: v.requires_grad_() for k, v in pipeline.stack_stage_params(
        [params_from_jax(p) for p in stage_states]).items()}

    def apply_fn(p, h):
        return torch.func.functional_call(block, p, (h,))

    out = pipeline.pipeline_apply(apply_fn, stacked, torch.from_numpy(x),
                                  mesh)
    (out * torch.from_numpy(cot)).sum().backward()
    me = mesh.coords["pipe"]
    return {"out": out.detach().numpy(),
            "grads": {k: v.grad[me].numpy() for k, v in stacked.items()},
            "zero_elsewhere": all(
                float(v.grad.abs().sum() - v.grad[me].abs().sum()) == 0.0
                for v in stacked.values())}


def _coords_rank(shape):
    mesh = build_train_mesh(shape)
    return mesh.coords, {",".join(names): mesh.axis(*names).ranks
                         for names in (("data",), ("seq",), ("model",),
                                       ("data", "seq"))}


def _raise_on_rank_one():
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank one fails")
    return "fine"


def _hang_on_rank_one():
    if torch.distributed.get_rank() == 1:
        import time

        time.sleep(600)
    return "fine"


# ------------------------------------------------------------- helpers


def _jax_mesh(shape):
    import jax

    from evam_tpu.parallel.train import build_train_mesh as jbuild

    return jbuild(devices=jax.devices()[:int(np.prod(shape))], shape=shape)


def _jax_attention(strategy, mesh, causal, q, k, v, cot):
    import jax
    import jax.numpy as jnp

    from evam_tpu.parallel.ring import ring_attention
    from evam_tpu.parallel.ulysses import ulysses_attention

    fn = ring_attention if strategy == "ring" else ulysses_attention

    def loss(q, k, v):
        out = fn(q, k, v, mesh, causal=causal)
        return (out * cot).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(a) for a in (out, *grads)]


def _plain_tree(state):
    """A reference train state as numpy dicts (no optax class: a spawned
    rank does not import optax)."""
    import jax

    adam = state["opt_state"][0]
    return {"params": jax.tree.map(np.asarray, state["params"]),
            "opt_state": {"mu": jax.tree.map(np.asarray, adam.mu),
                          "nu": jax.tree.map(np.asarray, adam.nu),
                          "count": int(adam.count)},
            "step": int(state["step"])}


def _compute_reference_run(shape, moe: int):
    """The reference trainer from ``init_state(0)`` for two steps: the
    initial state, and per step the metrics and the state after."""
    import jax

    from evam_tpu.parallel.train import ActionTrainConfig, build_action_trainer

    cfg = ActionTrainConfig(**SMALL, moe_experts=moe)
    trainer = build_action_trainer(_jax_mesh(shape), cfg)
    state = trainer.init_state(0)
    init = _plain_tree(state)
    # optax's own named tuples, numpy leaves (the step donates state)
    raw = jax.tree.map(np.asarray, state)
    c, lbl = trainer.shard_batch(*_batch())
    run = []
    for _ in range(2):
        state, m = trainer.train_step(state, c, lbl)
        run.append(({k: float(v) for k, v in m.items()}, _plain_tree(state)))
    return init, run, raw


#: (mesh shape, MoE experts) → the reference's run, computed on a
#: background thread from the module's start: its compiles are the
#: file's longest waits, and the attention tests run meanwhile
_REFERENCE_RUNS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _reference_runs():
    with ThreadPoolExecutor(max_workers=1) as pool:
        for key in (((2, 2, 2), 0), ((1, 1, 1), 0), ((1, 1, 1), 4)):
            _REFERENCE_RUNS[key] = pool.submit(_compute_reference_run, *key)
        yield
        _REFERENCE_RUNS.clear()


def _reference_run(shape, moe: int = 0):
    return _REFERENCE_RUNS[(shape, moe)].result()


def _as_torch(tree) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


#: the encoder's grouped (depthwise) conv kernels
DEPTHWISE = tuple(f"enc.SeparableConv_{i}.Conv_0.weight" for i in range(4))


def _hold_to_reference(port: dict, ref_run, lr: float,
                       depthwise_run=None) -> None:
    """Metrics, gradients (via AdamW's moments) and parameters of each
    step within the stated tolerances; ``depthwise_run``, where given,
    stands in for ``ref_run`` on the depthwise kernels."""
    first_grad = None
    for i, (metrics, ref_state) in enumerate(ref_run):
        got = port["metrics"][i]
        assert abs(got["loss"] - metrics["loss"]) < ATOL, (i, got, metrics)
        assert abs(got["accuracy"] - metrics["accuracy"]) < ATOL
        full = port["full"][i]
        assert full["step"] == ref_state["step"] == i + 1
        ref = {k: _as_torch(t) for k, t in (
            ("mu", ref_state["opt_state"]["mu"]),
            ("nu", ref_state["opt_state"]["nu"]),
            ("params", ref_state["params"]))}
        if depthwise_run is not None:
            dw_state = depthwise_run[i][1]
            dw = {k: _as_torch(t) for k, t in (
                ("mu", dw_state["opt_state"]["mu"]),
                ("nu", dw_state["opt_state"]["nu"]),
                ("params", dw_state["params"]))}
            if i == 0:  # the reference's defect, pinned
                for name in DEPTHWISE:
                    np.testing.assert_allclose(ref["mu"][name],
                                               2 * dw["mu"][name],
                                               atol=1e-6, rtol=1e-4)
            for part in ref:
                ref[part].update({n: dw[part][n] for n in DEPTHWISE})
        assert set(full["params"]) == set(ref["params"])
        if first_grad is None:
            first_grad = {k: v / 0.1 for k, v in ref["mu"].items()}
        for name, want in ref["params"].items():
            where = f"{name} step {i + 1}"
            np.testing.assert_allclose(full["exp_avg"][name].numpy(),
                                       ref["mu"][name], atol=1e-6, rtol=1e-4,
                                       err_msg="mu " + where)
            np.testing.assert_allclose(full["exp_avg_sq"][name].numpy(),
                                       ref["nu"][name], atol=1e-9, rtol=1e-3,
                                       err_msg="nu " + where)
            got_p = full["params"][name].numpy()
            np.testing.assert_allclose(got_p, want, atol=2 * lr,
                                       err_msg=where)
            firm = np.abs(first_grad[name]) >= 1e-6
            np.testing.assert_allclose(got_p[firm], want[firm], atol=1e-6,
                                       rtol=0, err_msg=where)


# ---------------------------------------------------------------- ring


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_the_reference(self, world, causal):
        q, k, v, cot = _qkv((4, 8, 4, 16), seed=0)
        ref = _jax_attention("ring", _jax_mesh((2, 2, 2)), causal,
                             q, k, v, cot)
        got = world.run(_attention_rank, (2, 2, 2), "ring", causal,
                        q, k, v, cot)
        out = _unshard([g[0] for g in got], (2, 2, 2))
        np.testing.assert_allclose(out, ref[0], atol=ATOL, rtol=0)

    @pytest.mark.parametrize("causal", [False, True])
    def test_grads_match_jax_grad(self, world, causal):
        q, k, v, cot = _qkv((2, 8, 4, 16), seed=1)
        ref = _jax_attention("ring", _jax_mesh((2, 2, 2)), causal,
                             q, k, v, cot)
        got = world.run(_attention_rank, (2, 2, 2), "ring", causal,
                        q, k, v, cot)
        for i, name in ((1, "q"), (2, "k"), (3, "v")):
            grad = _unshard([g[i] for g in got], (2, 2, 2))
            np.testing.assert_allclose(grad, ref[i], atol=ATOL, rtol=0,
                                       err_msg=name)

    def test_seq_axis_of_one_falls_back(self):
        import jax.numpy as jnp

        from evam_tpu.parallel.ring import plain_attention as jplain

        mesh = ProcessMesh((1,), ("data",))
        q = _qkv((2, 4, 2, 8), seed=2)[0]
        out = ring.ring_attention(torch.from_numpy(q), torch.from_numpy(q),
                                  torch.from_numpy(q), mesh, seq_axis="data",
                                  head_axis=None)
        plain = ring.plain_attention(*[torch.from_numpy(q)] * 3)
        assert torch.equal(out, plain)
        ref = np.asarray(jplain(*[jnp.asarray(q)] * 3))
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)

    def test_a_seq_axis_of_one_with_sharded_heads_runs_the_loop(self, world):
        """1×1×2: no hop, but the online softmax (the reference's
        ``shard_map`` path) over the rank's own heads."""
        q, k, v, cot = _qkv((2, 4, 4, 8), seed=3)
        ref = _jax_attention("ring", _jax_mesh((1, 1, 2)), True, q, k, v, cot)
        got = world.run(_attention_rank, (1, 1, 2), "ring", True,
                        q, k, v, cot, size=2)
        for i in range(4):
            np.testing.assert_allclose(
                _unshard([g[i] for g in got], (1, 1, 2)), ref[i],
                atol=ATOL, rtol=0)


# ------------------------------------------------------------- ulysses


class TestUlyssesAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_the_reference_with_grads(self, world, causal):
        q, k, v, cot = _qkv((4, 8, 4, 16), seed=0)
        ref = _jax_attention("ulysses", _jax_mesh((2, 2, 2)), causal,
                             q, k, v, cot)
        got = world.run(_attention_rank, (2, 2, 2), "ulysses", causal,
                        q, k, v, cot)
        for i in range(4):
            np.testing.assert_allclose(
                _unshard([g[i] for g in got], (2, 2, 2)), ref[i],
                atol=ATOL, rtol=0)

    def test_agrees_with_ring(self, world):
        q, k, v, cot = _qkv((2, 8, 4, 16), seed=2)
        uly = world.run(_attention_rank, (2, 2, 2), "ulysses", True,
                        q, q, q, cot)
        rng_ = world.run(_attention_rank, (2, 2, 2), "ring", True,
                         q, q, q, cot)
        for i in range(4):
            np.testing.assert_allclose(
                _unshard([g[i] for g in uly], (2, 2, 2)),
                _unshard([g[i] for g in rng_], (2, 2, 2)),
                atol=ATOL, rtol=0)

    def test_head_count_guard(self, world):
        from evam_tpu.parallel.ulysses import ulysses_attention as jul

        q = _qkv((2, 8, 3, 16), seed=3)[0]
        with pytest.raises(ValueError, match="heads") as info:
            jul(q, q, q, _jax_mesh((2, 2, 2)))
        msgs = world.run(_ulysses_guard_rank, (2, 2, 2), q)
        assert all(m is not None and "heads % (seq*model shards)" in m
                   for m in msgs), msgs
        assert msgs[0].split(",")[0] == str(info.value).split(",")[0]


# --------------------------------------------------------------- meshes


def test_factor_mesh_matches_the_reference_for_1_to_64():
    from evam_tpu.parallel.train import factor_mesh as jfactor

    for n in range(1, 65):
        assert factor_mesh(n) == jfactor(n), n
        assert np.prod(factor_mesh(n)) == n


def test_build_train_mesh_shapes_and_errors_match_the_reference():
    import jax

    from evam_tpu.parallel.train import build_train_mesh as jbuild

    mesh = build_train_mesh()
    assert mesh.shape == dict(jbuild(devices=jax.devices()[:1]).shape)
    assert mesh.axis("data", "seq").size == 1
    with pytest.raises(ValueError) as ref:
        jbuild(devices=jax.devices()[:1], shape=(2, 1, 1))
    with pytest.raises(ValueError) as got:
        build_train_mesh((2, 1, 1))
    assert str(got.value) == str(ref.value)


MESH_CASES = [([-1], ["data"]), ([8], ["data"]), ([4, 2], ["data", "model"]),
              ([-1, 2], ["data", "model"]), ([2, -1], ["data", "model"]),
              ([3], ["data"]), ([-1, 3], ["data", "model"]),
              ([2, 2], ["data", "model"]), ([-1, -1], ["data", "model"]),
              ([2], ["data", "model"])]


@pytest.mark.parametrize("shape,axes", MESH_CASES)
def test_serving_mesh_matches_build_mesh(shape, axes):
    """``device.mesh_devices`` over 8 devices: the reference's data size
    for a shape it accepts (the model axis replicating), its error for
    one it refuses."""
    import jax

    from evam_tpu.parallel.mesh import build_mesh
    from evam_tpu_torch.device import mesh_devices

    try:
        plan = build_mesh(shape=list(shape), axes=list(axes),
                          devices=jax.devices()[:8])
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            mesh_devices("cpu", shape, axes, count=8)
        assert str(got.value) == str(exc)
        return
    devices = mesh_devices("cpu", shape, axes, count=8)
    assert len(devices) == plan.data_size


def test_dryrun_parts_on_the_world(world):
    """The dry run's three rank parts on 8 ranks and its serving part
    over a 2-entry data mesh print the reference's lines."""
    from evam_tpu_torch.parallel import dryrun

    lines = world.run(dryrun._rank, 8)[0]
    assert lines[0].startswith(
        "dryrun_multichip: mesh {'data': 2, 'seq': 2, 'model': 2} over 8 "
        "devices (dp x sp(ring) x tp + ep/MoE), 1 train step ok, loss=")
    assert lines[1] == ("dryrun_multichip: ulysses all-to-all SP over seq=2 "
                        "matches reference attention")
    assert lines[2].startswith("dryrun_multichip: pp over 8 stages "
                               "(microbatch ring), 1 sgd step ok, loss=")
    serving = dryrun._serving_part(2)
    assert serving.startswith("dryrun_multichip: serving BatchEngine sharded "
                              "over {'data': 2}, 6 items in ")


# -------------------------------------------------------------- trainer


class TestActionTrainer:
    @pytest.mark.parametrize("shape", [(2, 2, 2), (1, 1, 1)])
    def test_two_steps_match_the_reference(self, world, shape):
        init, run, raw = _reference_run(shape)
        clips, labels = _batch()
        if shape == (1, 1, 1):
            # in this process, from the reference's state as it is
            # (optax's named tuples)
            port = _trainer_rank(shape, SMALL, raw, clips, labels, 2)
        else:
            port = world.run(_trainer_rank, shape, SMALL, init, clips,
                             labels, 2)[0]
        depthwise = _reference_run((1, 1, 1))[1] if shape == (2, 2, 2) \
            else None
        _hold_to_reference(port, run, lr=3e-4, depthwise_run=depthwise)

    def test_loss_decreases(self, world):
        cfg = {**SMALL, "heads": 2, "learning_rate": 1e-2}
        clips, labels = _batch()
        port = world.run(_trainer_rank, (2, 2, 2), cfg, None, clips, labels,
                         4)[0]
        losses = [m["loss"] for m in port["metrics"]]
        assert losses[-1] < losses[0], losses
        assert port["full"][-1]["step"] == 4

    def test_tensor_parallel_shards_are_a_tp_th_of_the_weight(self, world):
        clips, labels = _batch()
        port = world.run(_trainer_rank, (2, 2, 2), SMALL, None, clips,
                         labels, 1)
        full = port[0]["full"][0]["params"]
        blk = "dec.TransformerBlock_0."
        for name, dim in ((blk + "Dense_0.weight", 0),
                          (blk + "Dense_0.bias", 0),
                          (blk + "Dense_1.weight", 1),
                          (blk + "MultiHeadDotProductAttention_0.query.weight",
                           1),
                          (blk + "MultiHeadDotProductAttention_0.out.weight",
                           0)):
            for p in port:
                local = p["local_shapes"][name]
                want = list(full[name].shape)
                want[dim] //= 2
                assert list(local) == want, (name, local, want)
        for name in (blk + "Dense_1.bias", blk + "LayerNorm_0.weight",
                     "dec.pos_embed", "enc.Dense_0.weight"):
            assert port[3]["local_shapes"][name] == tuple(full[name].shape)


class TestMoE:
    def test_moe_trainer_steps_match_the_reference(self, world):
        init, run, _ = _reference_run((1, 1, 1), moe=4)
        moe = init["params"]["dec"]["TransformerBlock_0"]["MoeMlp_0"]
        assert moe["experts_up"].shape == (4, 32, 128)
        clips, labels = _batch()
        cfg = {**SMALL, "moe_experts": 4}
        port = world.run(_trainer_rank, (2, 2, 2), cfg, init, clips, labels,
                         2)
        name = "dec.TransformerBlock_0.MoeMlp_0.experts_up"
        assert all(p["local_shapes"][name] == (2, 32, 128) for p in port)
        _hold_to_reference(port[0], run, lr=3e-4)

    def test_moe_tree_converts_both_ways(self):
        import jax

        init, _, _ = _reference_run((1, 1, 1), moe=4)
        tree = init["params"]["dec"]
        back = params_to_jax(params_from_jax(tree))
        flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (_, a), (_, b) in zip(flat_a, flat_b):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ------------------------------------------------------------- pipeline


def _jax_pipeline(n_stages, dim, heads, m, seed):
    import jax
    import jax.numpy as jnp

    from evam_tpu.models.zoo.action import TransformerBlock
    from evam_tpu.parallel.pipeline import (
        build_pipe_mesh as jpipe,
        pipeline_apply as japply,
        stack_stage_params as jstack,
    )

    mesh = jpipe(devices=jax.devices(), n_stages=n_stages)
    block = TransformerBlock(dim=dim, heads=heads)
    x0 = jnp.zeros((2, 4, dim))
    params = [block.init(k, x0)["params"]
              for k in jax.random.split(jax.random.PRNGKey(seed), n_stages)]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, 2, 4, dim)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def loss(sp):
        out = japply(lambda p, h: block.apply({"params": p}, h), sp,
                     jnp.asarray(x), mesh)
        return (out * cot).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jstack(params))
    stages = [jax.tree.map(np.asarray, p) for p in params]
    g = [_as_torch(jax.tree.map(lambda a, i=i: np.asarray(a[i]), grads))
         for i in range(n_stages)]
    return stages, x, cot, np.asarray(out), g


class TestPipelineParallel:
    def test_matches_the_reference_with_grads(self, world):
        """4 stages, 3 microbatches: every fill and drain tick, the last
        microbatch clamped, as the reference's two tests together."""
        n_stages, m = 4, 3
        stages, x, cot, ref, ref_grads = _jax_pipeline(n_stages, 16, 2, m,
                                                       seed=n_stages)
        got = world.run(_pipeline_rank, n_stages, stages, x, 16, 2, cot,
                        size=n_stages)
        for r in got:  # every rank holds the last stage's outputs
            np.testing.assert_allclose(r["out"], ref, atol=ATOL, rtol=0)
        for s, r in enumerate(got):
            assert r["zero_elsewhere"]
            for name, g in r["grads"].items():
                scale = max(1.0, float(np.abs(ref_grads[s][name]).max()))
                np.testing.assert_allclose(g, ref_grads[s][name],
                                           atol=ATOL * scale, rtol=0,
                                           err_msg=f"{s} {name}")


# ----------------------------------------------------------- checkpoint


def test_checkpoint_saved_at_2x2x2_restores_at_1x2x4_and_1x1x1(world,
                                                              tmp_path):
    clips, labels = _batch()
    path = str(tmp_path / "ckpt" / "state.pt")
    saved = world.run(_checkpoint_rank, (2, 2, 2), SMALL, clips, labels,
                      path, "save")
    want = saved[0]["state"]
    assert want["step"] == 1
    for shape, size in (((1, 2, 4), 8), ((1, 1, 1), 1)):
        got = world.run(_checkpoint_rank, shape, SMALL, clips, labels, path,
                        "restore", size=size)
        state = got[0]["state"]
        assert state["step"] == 1
        for part in ("params", "exp_avg", "exp_avg_sq"):
            for name, t in want[part].items():
                assert torch.equal(state[part][name], t), (shape, part, name)
        # the restored state trains on as the saved layout does
        assert abs(got[0]["next_loss"] - saved[0]["next_loss"]) < ATOL


# ----------------------------------------------------- launch and init


def test_a_failing_rank_fails_the_run_and_the_world_goes_on(world):
    with pytest.raises(RankFailed, match="rank one fails"):
        world.run(_raise_on_rank_one, size=2, timeout=60)
    assert world.run(_raise_on_rank_one, size=1) == ["fine"]


_INIT_WORKER = textwrap.dedent("""
    import torch, torch.distributed as dist
    from evam_tpu_torch.parallel.mesh import initialize_distributed
    torch.set_num_threads(1)
    assert initialize_distributed(device="cpu")
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    x = torch.full((8, 16), float(dist.get_rank()))
    dist.all_reduce(x)
    assert float(x.sum()) == 8 * 16 * 1.0, float(x.sum())
    print(f"proc {dist.get_rank()}: global sum ok ({float(x.sum())})")
    dist.destroy_process_group()
""")


def test_initialize_distributed_across_two_processes(tmp_path):
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for pid in range(2):
        env = dict(os.environ, JAX_COORDINATOR=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _INIT_WORKER], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=90)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert all("global sum ok" in o for o in outs)


@pytest.mark.parametrize("env", [{}, {"JAX_COORDINATOR": "127.0.0.1:1",
                                      "JAX_NUM_PROCESSES": "1"}])
def test_initialize_distributed_is_a_no_op_unset_or_alone(monkeypatch, env):
    for key in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert not initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_axis_groups_follow_the_reference_device_order(world):
    """Rank r sits where device r sits in the reference's (data, seq,
    model) mesh, and each axis group holds the devices along its line."""
    import jax

    mesh = _jax_mesh((2, 2, 2))
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    grid = np.vectorize(lambda d: ids[d.id])(mesh.devices)
    got = world.run(_coords_rank, (2, 2, 2))
    for r, (coords, groups) in enumerate(got):
        d, s, m = (int(i) for i in np.argwhere(grid == r)[0])
        assert coords == {"data": d, "seq": s, "model": m}
        assert groups["data"] == tuple(grid[:, s, m])
        assert groups["seq"] == tuple(grid[d, :, m])
        assert groups["model"] == tuple(grid[d, s, :])
        assert groups["data,seq"] == tuple(grid[:, :, m].reshape(-1))


def test_a_hung_rank_fails_the_caller_after_its_timeout(world):
    """Last in the module: a hang stops the world (every rank killed)."""
    with pytest.raises(RankFailed, match="outlived"):
        world.run(_hang_on_rank_one, size=2, timeout=1)
    with pytest.raises(RankFailed, match="stopped"):
        world.run(_raise_on_rank_one, size=1)
