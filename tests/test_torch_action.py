"""Action recognition in the port against the reference, on the CPU.

Sizes: the encoder at 64×64 and width 8 (decoder dim 8 × 16 = 128, its
input the fixed 512-wide embedding), as ``tests/test_stages.py`` sizes
them; ``ActionRecognizer`` at its own widths (encoder width 32, embed
512) on a 48×48 clip.

Tolerance: atol 1e-5 on float32 logits, embeddings and probabilities
(the two frameworks sum convolutions, matmuls and LayerNorm statistics
in different orders; measured differences are ~1e-6).

* ``ActionEncoder``, ``TransformerBlock``, ``ActionDecoder`` and
  ``ActionRecognizer`` with the reference's weights through
  ``params_from_jax``; the encode and decode steps on the reference's
  ``weights.msgpack`` (the reference saves, the port loads) and on the
  port's (the port saves, the reference loads): weights bridged both
  ways.
* The reference's ``test_action_stage_never_blocks_on_decoder``, with
  the same stub decoder, against the port's ``ActionStage``.
* ``action_recognition/general`` through both stage chains
  (``build_stages`` → ``StreamRunner``) on the same weights and frames:
  no tensor before frame 16, then the same argmax frame by frame and
  probabilities within 1e-5; and through both REST servers at float32
  (the same tolerance) and INT8 (the encoder runs bfloat16 in both, so
  argmax equal where the reference's top-2 margin exceeds the bfloat16
  tolerance 1e-3 below, probabilities within it; measured ~1e-8).
* The parallel hooks (``attention_fn``, tensor parallelism,
  ``moe_experts``) at one rank against the reference's at mesh 1×1×1
  (``tests/test_torch_parallel.py`` holds them at 2×2×2).
"""

from __future__ import annotations

import json
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evam_tpu.engine import EngineHub as JaxHub
from evam_tpu.engine import steps as jsteps
from evam_tpu.graph import PipelineLoader as JaxLoader
from evam_tpu.graph import resolve_parameters as jresolve
from evam_tpu.media.source import SyntheticSource as JaxSynthetic
from evam_tpu.models import ModelRegistry as JaxRegistry
from evam_tpu.models.zoo import action as jaction
from evam_tpu.stages import StreamRunner as JaxRunner
from evam_tpu.stages import build_stages as jbuild
from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.engine import steps as tsteps
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.graph import PipelineLoader, resolve_parameters
from evam_tpu_torch.media.source import SyntheticSource
from evam_tpu_torch.models.convert import params_from_jax
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.models.zoo import action as taction
from evam_tpu_torch.server.registry import PipelineRegistry
from evam_tpu_torch.stages.build import build_stages
from evam_tpu_torch.stages.context import FrameContext
from evam_tpu_torch.stages.infer import ActionStage, _wire_frame
from evam_tpu_torch.stages.runner import StreamRunner
from test_torch_server import (  # the reference-parity harness
    REPO,
    PortServer,
    _body,
    native_reference,  # noqa: F401 — fixture
)
from test_torch_track import _reference_serve

torch.set_num_threads(1)
ATOL = 1e-5
#: INT8 (bfloat16 encoder in both frameworks): probabilities within
#: this, argmax equal where the reference's top-2 margin exceeds it —
#: bfloat16's relative step 2^-8 on logits of magnitude ~3 moves a
#: probability of at most ~0.05 by ~6e-4
BF16_ATOL = 1e-3
ENC = "action_recognition/encoder"
DEC = "action_recognition/decoder"
KEYS = (ENC, DEC)
SMALL = {ENC: (64, 64), DEC: (64, 64)}
NARROW = {ENC: 8, DEC: 8}
PATH = "/pipelines/action_recognition/general"


def _registries(dtype="float32", models_dir=None):
    jreg = JaxRegistry(models_dir=models_dir, dtype=dtype,
                       input_overrides=SMALL, width_overrides=NARROW,
                       allow_random_weights=True)
    treg = ModelRegistry(models_dir=models_dir, dtype=dtype, device="cpu",
                         input_overrides=SMALL, width_overrides=NARROW,
                         allow_random_weights=True)
    return jreg, treg


def _bridge(jm, tm) -> None:
    tm.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                           jm.params)))


def _port(module, x: np.ndarray) -> np.ndarray:
    with torch.inference_mode():
        return module(torch.from_numpy(x)).float().numpy()


def _init_flax(module, x: np.ndarray, seed: int = 0):
    return module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]


# -------------------------------------------------------------- modules


def test_encoder_matches_the_reference():
    jreg, treg = _registries()
    jm, tm = jreg.get(ENC), treg.get(ENC)
    _bridge(jm, tm)
    x = np.random.default_rng(0).uniform(0, 255, (3, 64, 64, 3)).astype(
        np.float32)
    ref = np.asarray(jm.forward(jm.params, jnp.asarray(x)))
    got = _port(tm.forward, x)
    assert got.shape == ref.shape == (3, 512)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dim,heads", [(128, 8), (64, 4)])
def test_transformer_block_matches_the_reference(dim, heads):
    x = np.random.default_rng(1).standard_normal((2, 16, dim)).astype(
        np.float32)
    jblock = jaction.TransformerBlock(dim, heads)
    params = _init_flax(jblock, x, seed=dim)
    tblock = taction.TransformerBlock(dim, heads)
    tblock.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_port(tblock, x), ref, rtol=0, atol=ATOL)


def test_decoder_matches_the_reference():
    jreg, treg = _registries()
    jm, tm = jreg.get(DEC), treg.get(DEC)
    _bridge(jm, tm)
    x = np.random.default_rng(2).standard_normal((3, 16, 512)).astype(
        np.float32)
    ref = np.asarray(jm.forward(jm.params, jnp.asarray(x)))
    got = _port(tm.forward, x)
    assert got.shape == ref.shape == (3, 400)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_recognizer_matches_the_reference():
    clip = np.random.default_rng(3).uniform(0, 255, (1, 16, 48, 48, 3)).astype(
        np.float32)
    jrec = jaction.ActionRecognizer(num_classes=400)
    params = _init_flax(jrec, clip)
    trec = taction.ActionRecognizer(num_classes=400)
    trec.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    ref = np.asarray(jrec.apply({"params": params}, jnp.asarray(clip)))
    got = _port(trec, clip)
    assert got.shape == ref.shape == (1, 400)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def _hooks(hook: str):
    """The same parallel hook for the reference (at its 1×1×1 training
    mesh) and for the port (at world 1): the ring ``attention_fn``, tensor
    parallelism (the reference's ``mlp_constraint``, the port's model
    axis group) or a 4-expert MoE MLP (with its ``moe_constraint``)."""
    import functools

    from jax.sharding import NamedSharding, PartitionSpec as P

    from evam_tpu.parallel.ring import make_flax_attention_fn
    from evam_tpu.parallel.train import build_train_mesh as jbuild
    from evam_tpu_torch.parallel.mesh import build_train_mesh
    from evam_tpu_torch.parallel.ring import make_attention_fn

    jmesh = jbuild(devices=jax.devices()[:1], shape=(1, 1, 1))
    mesh = build_train_mesh((1, 1, 1))

    def constraint(*spec):
        return functools.partial(jax.lax.with_sharding_constraint,
                                 shardings=NamedSharding(jmesh, P(*spec)))

    if hook == "attention_fn":
        return ({"attention_fn": make_flax_attention_fn(jmesh)},
                {"attention_fn": make_attention_fn(mesh)})
    if hook == "tensor_parallel":
        return ({"mlp_constraint": constraint("data", "seq", "model")},
                {"tensor_parallel": mesh.axis("model")})
    return ({"moe_experts": 4,
             "moe_constraint": constraint("data", "seq", "model", None)},
            {"moe_experts": 4})


@pytest.mark.parametrize("hook", ["attention_fn", "tensor_parallel",
                                  "moe_experts"])
def test_parallel_hooks_match_the_reference_at_one_rank(hook):
    """Each hook at world 1 against the reference's block and decoder
    with the same hook at mesh 1×1×1 (the weights bridged, MoE experts
    included): outputs within ATOL, the same ``state_dict`` names as the
    hook-free module's but for the MoE MLP."""
    jhooks, thooks = _hooks(hook)
    x = np.random.default_rng(4).standard_normal((2, 8, 64)).astype(
        np.float32)
    jblock = jaction.TransformerBlock(64, 4, **jhooks)
    params = _init_flax(jblock, x, seed=4)
    tblock = taction.TransformerBlock(64, 4, **thooks)
    tblock.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_port(tblock, x), ref, rtol=0, atol=ATOL)
    names = set(tblock.state_dict())
    plain = set(taction.TransformerBlock(64, 4).state_dict())
    if hook == "moe_experts":
        assert {n for n in names if n.startswith("MoeMlp_0.")} == {
            "MoeMlp_0.router.weight", "MoeMlp_0.router.bias",
            "MoeMlp_0.experts_up", "MoeMlp_0.experts_up_bias",
            "MoeMlp_0.experts_down", "MoeMlp_0.experts_down_bias"}
    else:
        assert names == plain

    jdec = jaction.ActionDecoder(16, 64, depth=2, heads=4, **jhooks)
    dparams = _init_flax(jdec, x, seed=5)
    tdec = taction.ActionDecoder(16, 64, depth=2, heads=4, in_dim=64,
                                 clip_len=8, **thooks)
    tdec.load_state_dict(params_from_jax(jax.tree.map(np.asarray, dparams)))
    ref = np.asarray(jdec.apply({"params": dparams}, jnp.asarray(x)))
    assert ref.shape == (2, 16)
    np.testing.assert_allclose(_port(tdec, x), ref, rtol=0, atol=ATOL)


# ---------------------------------------------------------------- steps


def _wire_batch(n: int, wire: str, seed: int = 0) -> np.ndarray:
    frames = np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                  dtype=np.uint8)
    return np.stack([_wire_frame(f, (64, 64), wire) for f in frames])


@pytest.mark.parametrize("direction", ["reference_saves", "port_saves"])
@pytest.mark.parametrize("wire", ["bgr", "i420"])
def test_steps_match_the_reference_on_shared_weights(tmp_path, direction,
                                                     wire):
    """The weights cross in a models dir: written by one registry's
    ``save_weights``, read by both."""
    models = tmp_path / "models"
    writer_j, writer_t = _registries(models_dir=None)
    for key in KEYS:
        if direction == "reference_saves":
            writer_j.get(key)
            writer_j.save_weights(key, models)
        else:
            writer_t.get(key)
            writer_t.save_weights(key, models)
    jreg, treg = _registries(models_dir=models)
    jenc, tenc = jreg.get(ENC), treg.get(ENC)
    jdec, tdec = jreg.get(DEC), treg.get(DEC)
    assert tenc.weight_source == tdec.weight_source == "msgpack"
    assert jenc.weight_source == jdec.weight_source == "msgpack"

    frames = _wire_batch(4, wire)
    ref = np.asarray(jsteps.build_action_encode_step(jenc, wire)(
        jenc.params, jnp.asarray(frames)))
    got = tsteps.build_action_encode_step(tenc, wire)(
        torch.from_numpy(frames)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 512)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)

    clips = np.stack([np.roll(ref, i, axis=0)[np.arange(16) % 4]
                      for i in range(2)]).astype(np.float32)
    ref_p = np.asarray(jsteps.build_action_decode_step(jdec)(
        jdec.params, jnp.asarray(clips)))
    got_p = tsteps.build_action_decode_step(tdec)(
        torch.from_numpy(clips)).numpy()
    assert got_p.dtype == np.float32 and got_p.shape == (2, 400)
    np.testing.assert_allclose(got_p.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got_p, ref_p, rtol=0, atol=ATOL)


def test_int8_runs_the_float_modules_in_bfloat16():
    """No quantized variant of these families: under INT8 the encoder
    is a bfloat16 float module, the decoder float32 arithmetic over
    bfloat16-rounded weights (flax promotes them against the step's
    float32 clips)."""
    _, treg = _registries(dtype="int8")
    enc, dec = treg.get(ENC), treg.get(DEC)
    assert treg.precision == "INT8"
    assert {p.dtype for p in enc.module.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in dec.module.parameters()} == {torch.float32}
    for p in dec.module.parameters():
        assert torch.equal(p, p.to(torch.bfloat16).float())
    assert not any(hasattr(m, "wq") for m in enc.module.modules())


# ---------------------------------------------------------------- stage


@pytest.fixture
def port_hub():
    _, treg = _registries()
    hub = EngineHub(treg, device="cpu", max_batch=16, deadline_ms=4.0)
    yield hub
    hub.stop()


def test_action_stage_never_blocks_on_decoder(port_hub):
    """The encoder→decoder chain is future-chained: frames keep flowing
    while a decoder batch is pending (the reference's test, on the
    port's stage)."""
    stage = ActionStage("action", {}, port_hub)

    class StubDecoder:
        def __init__(self):
            self.futures = []

        def submit(self, **kw):
            assert kw["clips"].shape[0] == taction.CLIP_LEN
            fut = Future()
            self.futures.append(fut)
            return fut

    stub = StubDecoder()
    stage.dec_engine = stub

    def ctx(i):
        return FrameContext(frame=np.zeros((64, 64, 3), np.uint8), pts_ns=i,
                            seq=i, stream_id="t")

    warmup = [stage.submit(ctx(i)) for i in range(taction.CLIP_LEN - 1)]
    for f in warmup:
        assert f.result(timeout=60) is None  # clip warm-up: no decode

    full = stage.submit(ctx(taction.CLIP_LEN - 1))
    # the encoder completes and hands off to the (stalled) decoder...
    deadline = time.perf_counter() + 60
    while not stub.futures and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert len(stub.futures) == 1
    # ...but the stage keeps accepting frames while it is pending
    more = [stage.submit(ctx(taction.CLIP_LEN + i)) for i in range(3)]
    deadline = time.perf_counter() + 60
    while len(stub.futures) < 4 and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert len(stub.futures) == 4  # 3 more sliding-window decodes queued
    assert not full.done()  # decoder still pending: nothing blocked on it

    probs = np.zeros(400, np.float32)
    probs[7] = 1.0
    for f in stub.futures:
        f.set_result(probs)
    assert np.argmax(full.result(timeout=10)) == 7
    for f in more:
        assert np.argmax(f.result(timeout=10)) == 7


def test_decoder_failure_reaches_the_runner(port_hub):
    """A decoder that fails lands its error on the stage's future, so
    the runner counts a frame error instead of waiting forever."""
    stage = ActionStage("action", {}, port_hub)

    class FailingDecoder:
        def submit(self, **kw):
            raise RuntimeError("decoder is stopping")

    stage.dec_engine = FailingDecoder()
    futs = [stage.submit(FrameContext(frame=np.zeros((64, 64, 3), np.uint8),
                                      pts_ns=i, seq=i, stream_id="t"))
            for i in range(taction.CLIP_LEN)]
    assert futs[-2].result(timeout=60) is None
    with pytest.raises(RuntimeError, match="stopping"):
        futs[-1].result(timeout=60)


# ------------------------------------------------------------- pipeline


def _chain_outputs(loader, resolve, build, runner_cls, source, hub) -> list:
    spec = loader(REPO / "pipelines").get("action_recognition", "general")
    stages, _ = resolve(spec, {})
    outputs = []
    runner = runner_cls("s", build(stages, hub, source_uri="synthetic://t",
                                   publish_fn=lambda c: outputs.append(
                                       c.metadata)),
                        source_uri="synthetic://t")
    runner.run(source.frames())
    assert runner.errors == 0
    return outputs


def assert_actions_agree(ref: list, got: list, atol: float,
                         margin: float = 0.0) -> None:
    """No tensor before frame 16; then one 400-long ``action`` tensor a
    frame in both, argmax equal (where the reference's top-2 margin
    exceeds ``margin``) and probabilities within ``atol``."""
    assert len(ref) == len(got)
    worst = 0.0
    for n, (r, g) in enumerate(zip(ref, got)):
        if n < taction.CLIP_LEN - 1:
            assert "tensors" not in r and "tensors" not in g, n
            continue
        (rt,), (gt,) = r["tensors"], g["tensors"]
        assert gt["name"] == rt["name"] == "action"
        rp, gp = np.asarray(rt["data"]), np.asarray(gt["data"])
        assert gp.shape == rp.shape == (400,)
        worst = max(worst, float(np.abs(gp - rp).max()))
        np.testing.assert_allclose(gp, rp, rtol=0, atol=atol)
        top2 = np.sort(rp)[-2:]
        if top2[1] - top2[0] > margin:
            assert (gt["label_id"], gt["label"]) == (rt["label_id"],
                                                     rt["label"]), n
        assert abs(gt["confidence"] - rt["confidence"]) <= atol
    print(f"action probabilities: max abs diff {worst:.3g} (atol {atol})")


@pytest.mark.usefixtures("native_reference")
def test_pipeline_matches_the_reference(tmp_path):
    models = tmp_path / "models"
    jreg, _ = _registries(models_dir=models)
    for key in KEYS:
        jreg.get(key)
        jreg.save_weights(key)
    _, treg = _registries(models_dir=models)
    jhub = JaxHub(jreg, max_batch=16, deadline_ms=4.0)
    thub = EngineHub(treg, device="cpu", max_batch=16, deadline_ms=4.0)
    try:
        ref = _chain_outputs(JaxLoader, jresolve, jbuild, JaxRunner,
                             JaxSynthetic(width=96, height=64, count=20), jhub)
        got = _chain_outputs(PipelineLoader, resolve_parameters, build_stages,
                             StreamRunner,
                             SyntheticSource(width=96, height=64, count=20),
                             thub)
    finally:
        jhub.stop()
        thub.stop()
    assert len(got) == 20
    assert_actions_agree(ref, got, ATOL)


# ------------------------------------------------------------------ REST


def port_serve(treg: ModelRegistry, keys, path: str, body: dict) -> dict:
    """The same request through the port's server; returns its engine
    rows (every model of ``keys`` served from the models dir)."""
    srv = PortServer(PipelineRegistry(
        Settings(pipelines_dir=str(REPO / "pipelines"), device="cpu",
                 drain_timeout_s=10.0),
        hub=EngineHub(treg, device="cpu", max_batch=16, deadline_ms=100.0)))
    try:
        status, iid = srv.request("POST", path, body)
        assert status == 200, iid
        st = srv.wait(iid, timeout=180, path=path)
        assert st["state"] == "COMPLETED", st
        for key in keys:
            assert srv.registry.hub.model(key).weight_source == "msgpack"
        return srv.registry.hub.stats()
    finally:
        srv.close()


def serve_pair(tmp_path: Path, jreg, treg_factory, keys, path: str,
               body_extra: dict, uri: str) -> tuple[list, list, dict, dict]:
    """One request, with the weights the reference saved, through both
    REST servers. Returns (reference lines, port lines, reference
    engines, port engines); the engines hold the same items and the
    lines the same timestamps and resolutions."""
    for key in keys:
        jreg.get(key)
        jreg.save_weights(key)
    ref_engines, _ = _reference_serve(jreg, path, _body(
        tmp_path / "ref.jsonl", uri, **body_extra))
    got_engines = port_serve(treg_factory(), keys, path, _body(
        tmp_path / "port.jsonl", uri, **body_extra))
    assert sorted(got_engines) == sorted(ref_engines)
    for name, row in got_engines.items():
        assert row["items"] == ref_engines[name]["items"], name
    ref, got = ([json.loads(x) for x in (tmp_path / f).read_text().splitlines()]
                for f in ("ref.jsonl", "port.jsonl"))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g["timestamp"], g["resolution"], g["objects"]) == (
            r["timestamp"], r["resolution"], r["objects"])
    return ref, got, ref_engines, got_engines


@pytest.mark.usefixtures("native_reference")
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_rest_metadata_matches_the_reference(tmp_path, dtype):
    models = tmp_path / "models"
    jreg, _ = _registries(dtype=dtype, models_dir=models)
    ref, got, _, engines = serve_pair(
        tmp_path, jreg, lambda: _registries(dtype=dtype, models_dir=models)[1],
        KEYS, PATH, {}, "synthetic://96x64@30?count=20")
    assert len(got) == 20
    assert sorted(engines) == [f"action_decode:{DEC}", f"action_encode:{ENC}"]
    assert engines[f"action_encode:{ENC}"]["items"] == 20
    assert engines[f"action_decode:{DEC}"]["items"] == 20 - 15
    if dtype == "float32":
        assert_actions_agree(ref, got, ATOL)
    else:
        assert_actions_agree(ref, got, BF16_ATOL, margin=BF16_ATOL)
