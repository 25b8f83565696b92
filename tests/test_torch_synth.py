"""Device-synth serving of the port against the reference, on the CPU.

``EngineHub(device_synth=True)``: video stages submit one uint32 seed a
frame and every wired engine makes its wire batch on the device
(``steps.wrap_device_synth``; ``ops/synth.py``, whose kernel runs on
the card only, so on the CPU the wrapper takes its plain version).
Same seeds through ``evam_tpu`` and ``evam_tpu_torch``:

* ``weyl_bits`` and the wrapped identity step: equal to the reference
  bit for bit (seeds 0, 1, 2³¹ and 2³²−1 cover the wraparound);
* the synth-wrapped detect and fused steps at float32, weights carried
  across by ``params_from_jax``: valid flags and labels equal, boxes and
  scores within 1e-4 (``tests/test_torch_slice.py``), and for the fused
  step the same classified rows with probabilities within 1e-5
  (``tests/test_torch_classify.py``);
* the hub: its two ``ValueError``s, ``synth=1`` in the AOT key, the
  wrapped step in every fleet shard, the mesh twin and a supervisor
  rebuild;
* serving: 8 tracking streams × 12 frames complete with cross-stream
  batching (the reference's ``TestDeviceSynthServe``); one tracking
  stream through both REST servers with both ``_SYNTH_SEQ`` reset: the
  same objects under the same ids (``tests/test_torch_track.py``'s
  float32 tolerance; a frame's objects compared in id order, since two
  at scores within it may leave NMS in either order);
  the port's synth engine equal to its host engine fed the same bytes.
"""

from __future__ import annotations

import itertools
import json
import time

import numpy as np
import pytest
import torch

import jax

from evam_tpu.engine import steps as jsteps
from evam_tpu.models.registry import ModelRegistry as JaxRegistry
from evam_tpu.stages import infer as jinfer
from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.engine import steps as tsteps
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.models.convert import params_from_jax
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.ops import synth
from evam_tpu_torch.ops.color import wire_shape
from evam_tpu_torch.server.registry import PipelineRegistry
from evam_tpu_torch.stages import infer as tinfer
from test_torch_server import REPO, _body
from test_torch_track import (  # the REST parity harness
    TRACK_PATH,
    _port_serve,
    _reference_serve,
    assert_objects_equal,
)

torch.set_num_threads(1)
DET = "object_detection/person_vehicle_bike"
CLS = "object_classification/vehicle_attributes"
SMALL = dict(input_overrides={DET: (64, 64)}, width_overrides={DET: 8, CLS: 8})
#: the wire of the small detector's ingest size (64², i420)
WIRE = wire_shape("i420", 64, 64)
EDGE_SEEDS = np.array([0, 1, 2**31, 2**32 - 1], np.uint32)


def _seeds(n: int = 6, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 2**32, n - len(EDGE_SEEDS), dtype=np.uint64)
    return np.concatenate([EDGE_SEEDS, rand.astype(np.uint32)])


# ---------------------------------------------------------- generator


@pytest.mark.parametrize("n", [1, 17, 144 * 96])
def test_weyl_bits_equal_the_references(n):
    seeds = _seeds(8, seed=n)
    ref = np.asarray(jsteps.weyl_bits(seeds, n))
    got = tsteps.weyl_bits(torch.from_numpy(seeds), n)
    assert ref.dtype == np.uint32 and got.dtype == torch.int64
    assert got.shape == ref.shape == (8, n)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("hw", [(96, 96), (432, 768)])
def test_wrapped_identity_equals_the_references(hw):
    """The wire batch itself: the reference's jitted wrapper around an
    identity step against the port's, bit for bit; the plain version
    and an int32 view of the same seeds give the same bytes."""
    shape = wire_shape("i420", *hw)
    seeds = _seeds()
    ref = np.asarray(jax.jit(jsteps.wrap_device_synth(
        lambda params, frames: frames, shape))(None, seeds))
    got = tsteps.wrap_device_synth(lambda f: f, shape)(torch.from_numpy(seeds))
    assert got.dtype == torch.uint8 and got.shape == ref.shape == (6, *shape)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(synth.synth_wire_reference(
        torch.from_numpy(seeds).view(torch.int32), shape).numpy(), ref)


def test_synth_wire_checks_its_arguments():
    seeds = torch.from_numpy(_seeds())
    with pytest.raises(ValueError, match=r"\[B\]"):
        synth.synth_wire(seeds[None], WIRE)
    with pytest.raises(TypeError, match="uint32 or int32"):
        synth.synth_wire(seeds.view(torch.int32).to(torch.int64), WIRE)
    with pytest.raises(ValueError, match="positive"):
        synth.synth_wire(seeds, (0, 4))
    assert synth.synth_wire(seeds[:0], (7, 13)).shape == (0, 7, 13)
    # the CPU takes the plain version and launches nothing
    before = synth.launches
    synth.synth_wire(seeds, (7, 13))
    assert synth.launches == before


def test_wrapper_declares_its_library():
    def inner(frames):
        return frames

    inner.libraries = ("qgemm",)
    assert tsteps.wrap_device_synth(inner, WIRE).libraries == ("qgemm",
                                                               "synth")


# --------------------------------------------------------------- steps


def _bridged(key):
    jm = JaxRegistry(dtype="float32", precision="FP32",
                     allow_random_weights=True, **SMALL).get(key)
    tm = ModelRegistry(dtype="float32", precision="FP32", device="cpu",
                       allow_random_weights=True, **SMALL).get(key)
    tm.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                           jm.params)))
    return jm, tm


@pytest.mark.parametrize("kind", ["detect", "fused"])
def test_synth_steps_match_the_references(kind):
    jd, td = _bridged(DET)
    kw = dict(wire_format="i420", score_threshold=0.1)
    if kind == "detect":
        ref_step = jsteps.build_detect_step(jd, **kw)
        params = jd.params
        port_step = tsteps.build_detect_step(td, **kw)
    else:
        jc, tc = _bridged(CLS)
        ref_step = jsteps.build_detect_classify_step(jd, jc, **kw)
        params = {"det": jd.params, "cls": jc.params}
        port_step = tsteps.build_detect_classify_step(td, tc, **kw)
    seeds = _seeds(4)
    ref = np.asarray(jax.jit(jsteps.wrap_device_synth(ref_step, WIRE))(
        params, seeds))
    got = tsteps.wrap_device_synth(port_step, WIRE)(
        torch.from_numpy(seeds)).numpy()
    assert got.shape == ref.shape == (4, 32, 7 if kind == "detect" else 18)
    assert ref[..., 6].sum() > 0
    np.testing.assert_array_equal(got[..., 6], ref[..., 6])
    np.testing.assert_array_equal(got[..., 5], ref[..., 5])
    np.testing.assert_allclose(got[..., :5], ref[..., :5], rtol=0, atol=1e-4)
    if kind == "fused":
        classified = ref[..., 7:].sum(-1) > 0.5
        assert classified.any()
        np.testing.assert_array_equal(got[..., 7:].sum(-1) > 0.5, classified)
        np.testing.assert_allclose(got[..., 7:], ref[..., 7:], rtol=0,
                                   atol=1e-5)


# ----------------------------------------------------------------- hub


def _registry():
    return ModelRegistry(device="cpu", dtype="float32",
                         allow_random_weights=True, **SMALL)


def _step_name(engine) -> str:
    return getattr(engine, "_engine", engine).step_fn.__name__


def test_hub_refuses_what_the_reference_refuses():
    hub = EngineHub(_registry(), device="cpu", max_batch=4,
                    device_synth=True)
    try:
        with pytest.raises(ValueError, match="synth_wire_hw"):
            hub.engine("detect", DET, score_threshold=0.1)
        with pytest.raises(ValueError, match="synth_wire_hw"):
            hub.fused_engine(DET, CLS, roi_budget=8)
        eng = hub.engine("detect", DET, score_threshold=0.1,
                         synth_wire_hw=(64, 64))
        assert hub.engine("detect", DET, synth_wire_hw=(64, 64)) is eng
        with pytest.raises(ValueError, match=r"\(64, 64\).*\(128, 64\)"):
            hub.engine("detect", DET, synth_wire_hw=(128, 64))
        fused = hub.fused_engine(DET, CLS, roi_budget=8,
                                 synth_wire_hw=(64, 64))
        with pytest.raises(ValueError, match="device_synth"):
            hub.fused_engine(DET, CLS, roi_budget=8, synth_wire_hw=(64, 128))
        assert fused.name.startswith("detect_classify:")
        # the engines that take no frames are not wired
        dec = hub.engine("action_decode", "action_recognition/decoder")
        assert _step_name(dec) == "step"
    finally:
        hub.stop()


def test_hub_wraps_every_factory_and_keys_the_mode():
    registry = _registry()
    hub = EngineHub(registry, device="cpu", max_batch=4, device_synth=True,
                    restart_backoff_s=0.0)
    fleet = EngineHub(registry, devices=["cpu", "cpu"], fleet="sharded",
                      max_batch=4, device_synth=True)
    plain = EngineHub(registry, device="cpu", max_batch=4)
    try:
        eng = hub.engine("detect", DET, score_threshold=0.1,
                         synth_wire_hw=(64, 64))
        assert eng._engine._aot_key == (
            f"detect:{DET}|wire=i420|synth=1|ragged=off|ub=4|sched=0")
        assert plain.engine("detect", DET)._engine._aot_key.endswith(
            "|wire=i420|synth=0|ragged=off|ub=4|sched=0")
        assert _step_name(eng) == "synth_step"
        seed = np.uint32(7)
        want = eng.submit(frames=seed).result(timeout=60)
        # a supervisor rebuild: the replacement serves the wrapped step
        first = eng._engine
        eng._quarantine_and_rebuild(first, "test rebuild")
        assert eng._engine is not first and eng.restarts == 1
        assert _step_name(eng) == "synth_step"
        np.testing.assert_array_equal(
            eng.submit(frames=seed).result(timeout=60), want)
        # every fleet shard, and the mesh twin, step over seeds
        fe = fleet.fused_engine(DET, CLS, roi_budget=8,
                                synth_wire_hw=(64, 64))
        fe.submit(stream="s0", frames=seed).result(timeout=60)
        # batch-class frames ride the mesh twin, which splits the seeds
        # over the two devices' steps
        for f in [fe.submit(priority="batch", stream="b", frames=s)
                  for s in _seeds(4)]:
            f.result(timeout=60)
        rows = fe.shard_rows()
        assert [label for label, _, _ in rows] == ["s0", "s1", "mesh"]
        for label, _, shard in rows:
            steps = (shard.step_fn.steps if label == "mesh"
                     else [shard.step_fn])
            assert [s.__name__ for s in steps] == ["synth_step"] * len(steps)
            assert "|synth=1|" in shard._engine._aot_key
    finally:
        hub.stop()
        fleet.stop()
        plain.stop()


def test_synth_engine_equals_the_host_engine():
    """The same 4 frames as seeds to a synth hub's fused engine and as
    ``synth_wire_reference``'s bytes to a plain hub's: one batch each,
    equal results."""
    registry = _registry()
    hubs = {"synth": EngineHub(registry, device="cpu", max_batch=4,
                               deadline_ms=200.0, device_synth=True),
            "host": EngineHub(registry, device="cpu", max_batch=4,
                              deadline_ms=200.0)}
    try:
        kw = dict(roi_budget=8, score_threshold=0.1)
        seeds = _seeds(4, seed=3)
        frames = synth.synth_wire_reference(torch.from_numpy(seeds),
                                            WIRE).numpy()
        engines = {name: hub.fused_engine(DET, CLS, synth_wire_hw=(64, 64),
                                          **kw)
                   for name, hub in hubs.items()}
        futures = {"synth": [engines["synth"].submit(frames=s)
                             for s in seeds],
                   "host": [engines["host"].submit(frames=f)
                            for f in frames]}
        out = {k: np.stack([f.result(timeout=60) for f in fs])
               for k, fs in futures.items()}
        for e in engines.values():
            assert e.stats_row()["bucket_batches"] == {"4": 1}
        assert out["synth"][..., 6].sum() > 0
        np.testing.assert_array_equal(out["synth"], out["host"])
    finally:
        for hub in hubs.values():
            hub.stop()


# ------------------------------------------------------------- serving


def test_synth_streams_complete_and_batch():
    """The reference's TestDeviceSynthServe on the port: 8 tracking
    streams × 12 frames on a device-synth hub all complete, and the
    fused engine batches across streams."""
    hub = EngineHub(_registry(), device="cpu", max_batch=16,
                    deadline_ms=4.0, device_synth=True)
    reg = PipelineRegistry(Settings(pipelines_dir=str(REPO / "pipelines"),
                                    device="cpu"), hub=hub)
    n, frames = 8, 12
    try:
        instances = [reg.start_instance(
            "object_tracking", "person_vehicle_bike", {
                "source": {"uri": f"synthetic://96x96@30?count={frames}"
                                  f"&seed={i}", "type": "uri"},
                "destination": {"metadata": {"type": "null"}},
                "parameters": {"detection-threshold": 0.0}})
            for i in range(n)]
        deadline = time.time() + 240
        for inst in instances:
            inst.wait(timeout=max(1, deadline - time.time()))
        states = [i.status()["state"] for i in instances]
        assert states.count("COMPLETED") == n, states
        assert all(i._runner.frames_out == frames for i in instances)
        stats = hub.stats()
        (key,) = [k for k in stats if k.startswith("detect")]
        assert key.startswith("detect_classify:")
        assert stats[key]["items"] >= n * frames
        assert stats[key]["items"] / stats[key]["batches"] > 2.0, stats[key]
    finally:
        reg.stop_all()


def test_one_stream_publishes_the_references_objects(tmp_path, monkeypatch):
    """One tracking stream of 6 frames through both REST servers on
    device-synth hubs, both seed sequences from 0: the same objects
    frame by frame."""
    monkeypatch.setattr(jinfer, "_SYNTH_SEQ", itertools.count())
    monkeypatch.setattr(tinfer, "_SYNTH_SEQ", itertools.count())
    models = tmp_path / "models"
    jreg = JaxRegistry(models_dir=models, dtype="float32",
                       allow_random_weights=True, **SMALL)
    for key in (DET, CLS):
        jreg.get(key)
        jreg.save_weights(key)
    params = {"detection-threshold": 0.0}
    uri = "synthetic://96x96@30?count=6"
    ref_engines, _ = _reference_serve(
        jreg, TRACK_PATH, _body(tmp_path / "ref.jsonl", uri,
                                parameters=params), device_synth=True)
    got_engines, _ = _port_serve(
        models, "float32", TRACK_PATH, _body(tmp_path / "port.jsonl", uri,
                                             parameters=params),
        device_synth=True)
    assert sorted(got_engines) == sorted(ref_engines)
    ref, got = ([json.loads(x) for x in
                 (tmp_path / f).read_text().splitlines()]
                for f in ("ref.jsonl", "port.jsonl"))
    assert len(got) == len(ref) == 6
    assert sum(len(m["objects"]) for m in ref) > 0
    # noise frames give many detections at near-equal scores: two whose
    # scores lie within the tolerance may leave NMS in either order, and
    # the tracker then publishes them in that order, each under its own
    # id in both servers; so each frame's objects are compared by id
    for lines in (ref, got):
        for m in lines:
            m["objects"].sort(key=lambda o: o["id"])
    assert_objects_equal(ref, got, "float32")
