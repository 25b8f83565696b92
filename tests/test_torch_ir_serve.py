"""IR models served by the port against the reference (``evam_tpu``).

The same OpenVINO IR files — the crossroad-0078-shaped SSD (input 64,
width 8), the vehicle-attributes-shaped classifier, a RegionYolo head,
the action encoder and TensorIterator/LSTM decoder and AclNet, written
by the IR builder — are installed in a models directory that both
registries read:

* the registry rows (family, input size, heads, anchors, labels,
  probability flags, weight source) and ``/models`` equal the
  reference's;
* the engine steps — detect (SSD and YOLO), fused detect+classify with
  both models IR (bgr and i420 wires), action encode and decode, audio
  — agree at float32: packed detect rows' boxes and scores within 1e-4
  with equal labels and valid flags, probabilities within 1e-4;
  bfloat16 serving within 2e-2;
* a ``weights.msgpack`` beside an IR overrides it both ways (the
  reference's file read by the port, the port's — byte-equal to the
  reference's ``save_weights`` — read by the reference), and a zoo
  tree there is ignored with a warning;
* one REST POST per pipeline served from an IR models directory —
  person_vehicle_bike, vehicle_attributes (fused, both models IR),
  action_recognition/general (encoder and decoder IRs) and
  audio_detection/environment (AclNet IR) — publishes what the
  reference's server publishes (float32: boxes, confidences and
  probabilities within 1e-4 or, for action and audio, 1e-5; labels
  equal);
* an IR engine never reaches the int8 GEMM (``qgemm``), INT8 or not:
  zero calls, against a zoo engine's nonzero count on the same path.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from evam_tpu.engine import steps as jsteps
from evam_tpu.models.registry import ModelRegistry as JaxRegistry
from evam_tpu.ops.color import bgr_to_i420_host
from evam_tpu_torch.engine import steps as tsteps
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.models.ir_build import (
    build_aclnet_like_ir,
    build_action_decoder_like_ir,
    build_action_encoder_like_ir,
    build_attributes_like_ir,
    build_crossroad_like_ir,
)
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.ops import qlinear as tql
from test_ir import _build_yolo_ir
from test_torch_action import assert_actions_agree
from test_torch_audio import assert_detections_agree
from test_torch_classify_server import (
    _assert_float32_agrees as _assert_attributes_agree,
)
from test_torch_server import (  # the reference-parity harness
    PortServer,
    _assert_float32_agrees,
    _body,
    _port_registry,
    _reference_run,
    native_reference,  # noqa: F401 — fixture
)

torch.set_num_threads(1)

DET = "object_detection/person_vehicle_bike"
CLS = "object_classification/vehicle_attributes"
YOLO = "ir_yolo/1"


@pytest.fixture(scope="module")
def models(tmp_path_factory) -> Path:
    """An IR models directory: the SSD at 64², the attributes classifier
    at 24² and a RegionYolo detector, under their serving keys."""
    root = tmp_path_factory.mktemp("ir_models")
    build_crossroad_like_ir(root / DET / "FP32", input_size=64, width=8,
                            num_classes=4)
    build_attributes_like_ir(root / CLS / "FP32", input_size=24, width=4)
    (root / YOLO / "FP32").mkdir(parents=True)
    _build_yolo_ir(root / YOLO / "FP32")
    return root


def _regs(root: Path, dtype: str = "float32"):
    return (JaxRegistry(models_dir=root, dtype=dtype),
            ModelRegistry(models_dir=root, dtype=dtype, device="cpu"))


def _frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (n, h, w, 3),
                                                np.uint8)


def _wire(frames: np.ndarray, wire: str) -> np.ndarray:
    if wire == "i420":
        return np.stack([bgr_to_i420_host(f) for f in frames])
    return frames


def _assert_rows_agree(ref: np.ndarray, got: np.ndarray) -> None:
    """Packed detect rows: equal labels and valid flags, boxes and scores
    (and any probability block) within 1e-4."""
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., 5:7], ref[..., 5:7])
    np.testing.assert_allclose(got[..., :5], ref[..., :5], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[..., 7:], ref[..., 7:], rtol=0, atol=1e-4)


# ------------------------------------------------------------ registry


def test_registry_serves_ir_models_as_the_reference(models):
    jreg, treg = _regs(models)
    assert treg.keys() == jreg.keys()
    for key in (DET, CLS, YOLO):
        jm, tm = jreg.get(key), treg.get(key)
        assert tm.ir is not None and tm.weight_source == "ir-bin"
        assert vars(tm.spec) == vars(jm.spec), key
        for attr in ("labels", "head_labels", "variances", "conf_is_prob",
                     "head_is_prob", "detector_kind", "out_is_prob",
                     "yolo_specs", "weight_source"):
            assert getattr(tm, attr) == getattr(jm, attr), (key, attr)
        assert (tm.preprocess.height, tm.preprocess.width,
                tm.preprocess.color_space) == (
            jm.preprocess.height, jm.preprocess.width,
            jm.preprocess.color_space)
        if jm.anchors is not None:
            np.testing.assert_array_equal(tm.anchors, jm.anchors)
    assert treg.get(DET).conf_is_prob
    assert treg.get(CLS).spec.heads == (("color", 7), ("type", 4))


def test_int8_registry_serves_the_ir_float_weights(models, caplog):
    """Under INT8 an IR serves its float weights at the registry's dtype
    (bfloat16), with the reference's warning."""
    with caplog.at_level(logging.WARNING):
        m = ModelRegistry(models_dir=models, dtype="int8",
                          device="cpu").get(DET)
    assert "IR-backed" in caplog.text
    assert {v.dtype for v in m.ir.params.values()} == {torch.bfloat16}


def test_models_rows_match_the_reference(tmp_path):
    """``GET /models`` rows — before and after loading — for an IR, an
    IR with its flat weights.msgpack, an IR beside a zoo tree
    (``ir-bin+override`` until loaded, then ``ir-bin``) and the zoo's
    random-weight rows."""
    root = tmp_path / "m"
    build_attributes_like_ir(root / CLS / "FP32", input_size=24, width=4)
    build_crossroad_like_ir(root / DET / "FP32", input_size=64, width=8)
    build_action_decoder_like_ir(
        root / "action_recognition" / "decoder" / "FP32", clip_len=4,
        embed_dim=8, hidden=4, num_classes=6)
    # the reference's own flat IR file beside the classifier, a zoo
    # tree beside the detector
    JaxRegistry(models_dir=root, dtype="float32",
                precision="FP32").save_weights(CLS)
    (root / DET / "FP32" / "weights.msgpack").write_bytes(_zoo_tree_bytes())
    jreg = JaxRegistry(models_dir=root, dtype="float32",
                       allow_random_weights=True)
    treg = ModelRegistry(models_dir=root, dtype="float32", device="cpu",
                         allow_random_weights=True)
    assert treg.describe() == jreg.describe()
    for key in (CLS, DET, "action_recognition/decoder"):
        jreg.get(key)
        treg.get(key)
    rows = {f"{r['name']}/{r['version']}": r["weights"]
            for r in treg.describe()}
    assert rows[CLS] == "ir-bin+override"
    assert rows[DET] == "ir-bin"
    assert rows["action_recognition/decoder"] == "ir-bin"
    assert treg.describe() == jreg.describe()
    srv = PortServer(_port_registry(models_dir=root))
    try:
        status, body = srv.request("GET", "/models")
        assert status == 200
        srv_rows = {f"{r['name']}/{r['version']}": r["weights"] for r in body}
        assert srv_rows[CLS] == "ir-bin+override"
    finally:
        srv.close()


def _zoo_tree_bytes() -> bytes:
    """A nested (zoo-format) params tree, as flax writes one."""
    from evam_tpu_torch.models.convert import packb

    return packb({"Backbone_0": {"Conv_0": {
        "kernel": np.zeros((3, 3, 3, 8), np.float32),
        "bias": np.zeros((8,), np.float32)}}})


# -------------------------------------------------------------- steps


@pytest.mark.parametrize("wire", ["bgr", "i420"])
def test_detect_step_matches_the_reference(models, wire):
    jreg, treg = _regs(models)
    jm, tm = jreg.get(DET), treg.get(DET)
    kw = dict(max_detections=8, score_threshold=0.0, wire_format=wire)
    frames = _wire(_frames(3, 64, 64), wire)
    ref = np.asarray(jax.jit(jsteps.build_detect_step(jm, **kw))(
        jm.params, frames))
    got = tsteps.build_detect_step(tm, **kw)(torch.from_numpy(frames))
    assert int(ref[..., 6].sum()) > 0
    _assert_rows_agree(ref, got.numpy())


@pytest.mark.parametrize("wire", ["bgr", "i420"])
def test_fused_detect_classify_both_ir(models, wire):
    """The flagship forward with both models IR: detections and each
    row's probability block agree with the reference's."""
    jreg, treg = _regs(models)
    kw = dict(max_detections=6, roi_budget=3, score_threshold=0.0,
              wire_format=wire, allowed_label_ids=(1, 2))
    frames = _wire(_frames(2, 64, 64, seed=1), wire)
    jd, jc = jreg.get(DET), jreg.get(CLS)
    td, tc = treg.get(DET), treg.get(CLS)
    ref = np.asarray(jax.jit(jsteps.build_detect_classify_step(jd, jc, **kw))(
        {"det": jd.params, "cls": jc.params}, frames))
    got = tsteps.build_detect_classify_step(td, tc, **kw)(
        torch.from_numpy(frames)).numpy()
    assert got.shape == (2, 6, 7 + 11)
    _assert_rows_agree(ref, got)
    sums = got[..., 7:].sum(-1)
    assert ((np.abs(sums - 2.0) < 1e-3) | (sums == 0.0)).all()
    assert (sums > 0).any()


def test_classify_steps_on_an_ir_classifier(models):
    """The dense and the packed-ragged classify steps on the IR
    classifier (in-graph SoftMax heads, not softmaxed again)."""
    jreg, treg = _regs(models)
    jm, tm = jreg.get(CLS), treg.get(CLS)
    frames = _frames(2, 48, 64, seed=2)
    boxes = np.asarray([[[0.1, 0.1, 0.6, 0.7], [0.3, 0.2, 0.9, 0.9]],
                        [[0.0, 0.0, 1.0, 1.0], [0.5, 0.5, 0.8, 0.9]]],
                       np.float32)
    ref = np.asarray(jax.jit(jsteps.build_classify_step(
        jm, roi_budget=2, wire_format="bgr"))(jm.params, frames, boxes))
    got = tsteps.build_classify_step(tm, roi_budget=2, wire_format="bgr")(
        torch.from_numpy(frames), torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    seg = np.asarray([0, 0, 1, -1], np.int32)
    packed = np.asarray([boxes[0, 0], boxes[0, 1], boxes[1, 0],
                         np.zeros(4, np.float32)])
    ref_p = np.asarray(jax.jit(jsteps.build_classify_step_ragged(
        jm, wire_format="bgr"))(jm.params, frames, packed, seg))
    got_p = tsteps.build_classify_step_ragged(tm, wire_format="bgr")(
        torch.from_numpy(frames), torch.from_numpy(packed),
        torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got_p, ref_p, rtol=0, atol=1e-4)
    assert (got_p[3] == 0).all()


def test_yolo_detect_step_matches_the_reference(models):
    """RegionYolo IR: the raw maps decoded in the detect step (1-based
    labels behind the prepended background column), as the
    reference's."""
    jreg, treg = _regs(models)
    jm, tm = jreg.get(YOLO), treg.get(YOLO)
    assert tm.detector_kind == "yolo"
    assert tm.yolo_specs == [{"anchors": [[81.0, 82.0], [135.0, 169.0]]}]
    kw = dict(max_detections=4, score_threshold=0.0, wire_format="bgr")
    frames = _frames(2, 8, 8, seed=3)
    ref = np.asarray(jax.jit(jsteps.build_detect_step(jm, **kw))(
        jm.params, frames))
    got = tsteps.build_detect_step(tm, **kw)(torch.from_numpy(frames)).numpy()
    _assert_rows_agree(ref, got)
    valid = got[..., 6] > 0.5
    assert valid.any() and (got[..., 5][valid] == 1.0).all()


def test_yolo_decode_and_gather_match_the_reference():
    """Several heads, the size-logit cap (large tw, th) and the
    background column."""
    from evam_tpu.ops.boxes import yolo_gather as ref_gather
    from evam_tpu_torch.ops.boxes import yolo_gather

    rng = np.random.default_rng(5)
    maps = [rng.normal(size=(2, 2 * 7, 4, 4)).astype(np.float32) * 4,
            rng.normal(size=(2, 2 * 7, 2, 3)).astype(np.float32) * 4]
    maps[0][:, 2:4] = 30.0  # past the cap
    specs = [{"anchors": [[10.0, 14.0], [23.0, 27.0]]},
             {"anchors": [[81.0, 82.0], [135.0, 169.0]]}]
    rb, rs = ref_gather([jnp.asarray(m) for m in maps], specs, (64, 96), 2)
    tb, ts = yolo_gather([torch.from_numpy(m) for m in maps], specs,
                         (64, 96), 2)
    np.testing.assert_allclose(tb.numpy(), np.asarray(rb), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=1e-5,
                               atol=1e-6)
    assert (ts[..., 0] == 0).all() and np.isfinite(tb.numpy()).all()


@pytest.mark.parametrize("tail", [False, True], ids=["logits", "softmax"])
def test_action_decoder_ir_step(tmp_path, tail):
    """The TensorIterator/LSTM decoder IR through the decode step: the
    class count from the IR, and an in-graph SoftMax (``out_is_prob``)
    not applied twice."""
    build_action_decoder_like_ir(
        tmp_path / "action_recognition" / "decoder" / "FP32", clip_len=16,
        embed_dim=32, hidden=8, num_classes=12, softmax_tail=tail)
    jreg, treg = _regs(tmp_path)
    jm, tm = jreg.get("action_recognition/decoder"), \
        treg.get("action_recognition/decoder")
    assert tm.spec.family == "action_decoder" and tm.spec.num_classes == 12
    assert tm.out_is_prob == jm.out_is_prob == tail
    clips = np.random.default_rng(6).normal(size=(3, 16, 32)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jsteps.build_action_decode_step(jm))(
        jm.params, clips))
    got = tsteps.build_action_decode_step(tm)(torch.from_numpy(clips)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    if tail:
        with torch.inference_mode():
            raw = tm.forward(torch.from_numpy(clips)).numpy()
        np.testing.assert_array_equal(got, raw)


def test_action_encoder_and_decoder_ir_in_bfloat16(tmp_path):
    """bfloat16 serving: the encoder IR (bf16 frames in) and the decoder
    IR (float32 clips against bf16-rounded weights, as the reference
    computes them) within 2e-2."""
    root = tmp_path
    build_action_encoder_like_ir(
        root / "action_recognition" / "encoder" / "FP32", input_size=32,
        width=4, embed_dim=16)
    build_action_decoder_like_ir(
        root / "action_recognition" / "decoder" / "FP32", clip_len=16,
        embed_dim=16, hidden=8, num_classes=10)
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        jreg, treg = _regs(root, dtype)
        je, te = (r.get("action_recognition/encoder") for r in (jreg, treg))
        frames = _frames(2, 32, 32, seed=7)
        ref = np.asarray(jax.jit(jsteps.build_action_encode_step(
            je, wire_format="bgr"))(je.params, frames))
        got = tsteps.build_action_encode_step(te, wire_format="bgr")(
            torch.from_numpy(frames)).numpy()
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
        jd, td = (r.get("action_recognition/decoder") for r in (jreg, treg))
        clips = np.random.default_rng(8).normal(size=(2, 16, 16)).astype(
            np.float32)
        ref = np.asarray(jax.jit(jsteps.build_action_decode_step(jd))(
            jd.params, clips))
        got = tsteps.build_action_decode_step(td)(
            torch.from_numpy(clips)).numpy()
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_aclnet_ir_audio_step(tmp_path):
    """The AclNet IR (in-graph SoftMax) through the audio step."""
    build_aclnet_like_ir(tmp_path / "audio_detection" / "environment"
                         / "FP32", window=16000, width=4, num_classes=53)
    jreg, treg = _regs(tmp_path)
    jm, tm = (r.get("audio_detection/environment") for r in (jreg, treg))
    assert tm.spec.family == "aclnet" and tm.out_is_prob and jm.out_is_prob
    windows = np.random.default_rng(9).integers(
        -3000, 3000, (2, 16000)).astype(np.int16)
    ref = np.asarray(jax.jit(jsteps.build_audio_step(jm))(jm.params, windows))
    got = tsteps.build_audio_step(tm)(torch.from_numpy(windows)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert not np.allclose(got[0], got[1])


# ------------------------------------------------------------ weights


def test_weights_override_both_ways(tmp_path, caplog):
    """The reference's flat weights.msgpack overrides the port's IR; the
    port's ``save_weights`` writes the reference's bytes (float32: the
    IR's order, bfloat16: sorted) and the reference reads the port's."""
    from flax import serialization

    root = tmp_path / "m"
    target = root / CLS / "FP32"
    build_attributes_like_ir(target, input_size=24, width=4)
    frames = _frames(1, 24, 24, seed=4).astype(np.float32)

    for dtype in ("float32", "bfloat16"):
        jreg, treg = _regs(root, dtype)
        out_j = jreg.save_weights(CLS, tmp_path / f"ref_{dtype}")
        out_t = treg.save_weights(CLS, tmp_path / f"port_{dtype}")
        assert out_t.read_bytes() == out_j.read_bytes(), dtype

    # the reference's override (all zeros → uniform heads) in the port
    jm = JaxRegistry(models_dir=root, dtype="float32").get(CLS)
    zeros = {k: np.zeros_like(v) for k, v in jm.ir.params.items()}
    (target / "weights.msgpack").write_bytes(serialization.to_bytes(zeros))
    tm = ModelRegistry(models_dir=root, dtype="float32", device="cpu").get(CLS)
    assert tm.weight_source == "ir-bin+override"
    with torch.inference_mode():
        out = tm.forward(torch.from_numpy(frames))
    torch.testing.assert_close(out["color"], torch.full((1, 7), 1 / 7))

    # the port's file (scaled weights) read by the reference
    (target / "weights.msgpack").unlink()
    treg = ModelRegistry(models_dir=root, dtype="float32", device="cpu",
                         precision="FP32")
    tm = treg.get(CLS)
    tm.ir.load_params({k: v * 0.5 for k, v in tm.ir.params.items()})
    treg.save_weights(CLS)
    assert (target / "weights.msgpack").exists()
    jm = JaxRegistry(models_dir=root, dtype="float32").get(CLS)
    tm2 = ModelRegistry(models_dir=root, dtype="float32", device="cpu").get(CLS)
    assert jm.weight_source == tm2.weight_source == "ir-bin+override"
    ref = jm.forward(jm.params, jnp.asarray(frames))
    with torch.inference_mode():
        got = tm2.forward(torch.from_numpy(frames))
    for k in ("color", "type"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6)

    # a zoo tree beside the IR: ignored with a warning
    (target / "weights.msgpack").write_bytes(_zoo_tree_bytes())
    with caplog.at_level(logging.WARNING):
        tm3 = ModelRegistry(models_dir=root, dtype="float32",
                            device="cpu").get(CLS)
    assert tm3.weight_source == "ir-bin"
    assert "not an IR weight dict" in caplog.text


# -------------------------------------------------------------- serve


@pytest.mark.usefixtures("native_reference")
def test_rest_post_served_from_an_ir_models_dir(tmp_path, models):
    """person_vehicle_bike from the IR SSD: the port's REST server
    publishes the reference's lines (float32: equal labels, boxes and
    confidences within 1e-4), and reports the IR's weights."""
    path = "/pipelines/" + DET
    body = {"parameters": {"detection-properties": {"threshold": 0.0}}}
    uri = "synthetic://96x96@30?count=4"
    _reference_run(JaxRegistry(models_dir=models, dtype="float32"), path,
                   _body(tmp_path / "ref.jsonl", uri, **body))
    srv = PortServer(_port_registry(models_dir=models))
    try:
        status, iid = srv.request("POST", path,
                                  _body(tmp_path / "port.jsonl", uri, **body))
        assert status == 200, iid
        st = srv.wait(iid, timeout=120, path=path)
        assert st["state"] == "COMPLETED"
        assert st["weights"]["detection"]["weights"][DET] == "ir-bin"
    finally:
        srv.close()
    ref, got = ([json.loads(x) for x in (tmp_path / f).read_text().splitlines()]
                for f in ("ref.jsonl", "port.jsonl"))
    assert len(got) == len(ref) == 4
    assert any(m["objects"] for m in got)
    for g, r in zip(got, ref):
        assert (g["timestamp"], g["resolution"]) == (r["timestamp"],
                                                     r["resolution"])
    _assert_float32_agrees(ref, got)


def _ir_pipeline_models(root: Path) -> Path:
    """Small IRs for every pipeline of the REST test, under their
    serving keys (the encoder's embedding 512 wide, as the action stage
    feeds the decoder; the decoder's 400 classes, as the pipeline's
    labels have)."""
    build_crossroad_like_ir(root / DET / "FP32", input_size=64, width=8)
    build_attributes_like_ir(root / CLS / "FP32", input_size=24, width=4)
    build_action_encoder_like_ir(
        root / "action_recognition" / "encoder" / "FP32", input_size=32,
        width=4, embed_dim=512)
    build_action_decoder_like_ir(
        root / "action_recognition" / "decoder" / "FP32", clip_len=16,
        embed_dim=512, hidden=8, num_classes=400)
    build_aclnet_like_ir(root / "audio_detection" / "environment" / "FP32",
                         window=16000, width=4, num_classes=53)
    return root


#: pipeline → (request parameters, source, frames published, check)
_IR_PIPELINES = {
    "object_classification/vehicle_attributes": (
        {"detection-properties": {"threshold": 0.0}},
        "synthetic://96x96@30?count=6", 6,
        lambda ref, got: _assert_attributes_agree(ref, got)),
    "action_recognition/general": (
        {}, "synthetic://96x64@30?count=20", 20,
        lambda ref, got: assert_actions_agree(ref, got, 1e-5)),
    "audio_detection/environment": (
        {"threshold": 0.0, "sliding-window": 0.5},
        "synthetic-audio://seconds=2&seed=1", 20,
        lambda ref, got: assert_detections_agree(ref, got, 1e-5) == 3),
}


@pytest.mark.usefixtures("native_reference")
@pytest.mark.parametrize("pipeline", list(_IR_PIPELINES))
def test_rest_serves_each_ir_pipeline_as_the_reference(tmp_path, pipeline):
    """vehicle_attributes fused with both models IR, action from the
    encoder and decoder IRs, audio from the AclNet IR: the port's REST
    server publishes the reference's lines from the same IR models
    directory, every model reported as ``ir-bin``."""
    models = _ir_pipeline_models(tmp_path / "models")
    params, uri, n, check = _IR_PIPELINES[pipeline]
    path = "/pipelines/" + pipeline
    ref_engines = _reference_run(
        JaxRegistry(models_dir=models, dtype="float32"), path,
        _body(tmp_path / "ref.jsonl", uri, parameters=params))
    srv = PortServer(_port_registry(models_dir=models))
    try:
        status, iid = srv.request("POST", path, _body(
            tmp_path / "port.jsonl", uri, parameters=params))
        assert status == 200, iid
        st = srv.wait(iid, timeout=120, path=path)
        assert st["state"] == "COMPLETED"
        hub = srv.registry.hub
        got_engines = hub.stats()
        served = {name.split(":")[1].split("+")[0] for name in got_engines}
        served |= {name.split("+")[1].split(":")[0] for name in got_engines
                   if "+" in name}
        assert {hub.model(k).weight_source for k in served} == {"ir-bin"}
    finally:
        srv.close()
    assert sorted(got_engines) == sorted(ref_engines)
    for name, row in got_engines.items():
        assert row["items"] == ref_engines[name]["items"], name
    ref, got = ([json.loads(x) for x in (tmp_path / f).read_text().splitlines()]
                for f in ("ref.jsonl", "port.jsonl"))
    assert len(got) == len(ref) == n
    for g, r in zip(got, ref):
        assert (g["timestamp"], g.get("resolution")) == (
            r["timestamp"], r.get("resolution"))
    check(ref, got)


def test_ir_engines_never_reach_the_int8_gemm(models, monkeypatch):
    """INT8 with the hand kernel selected: the IR detect and fused
    engines serve without one qgemm call; a zoo detect engine on the
    same path makes them (the control)."""
    calls = []
    plain = tql.qgemm

    def spy(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    monkeypatch.setattr(tql, "qgemm", spy)
    frames = _frames(3, 64, 64, seed=5)
    reg = ModelRegistry(models_dir=models, dtype="int8", device="cpu")
    hub = EngineHub(reg, device="cpu", wire_format="bgr", max_batch=4)
    try:
        det = hub.engine("detect", DET, score_threshold=0.0)
        fused = hub.fused_engine(DET, CLS, score_threshold=0.0)
        for eng in (det, fused):
            rows = [f.result(timeout=60) for f in
                    [eng.submit(frames=fr) for fr in frames]]
            assert all(np.isfinite(r).all() for r in rows)
        assert calls == []
    finally:
        hub.stop()
    zoo = ModelRegistry(dtype="int8", device="cpu",
                        input_overrides={DET: (64, 64)},
                        width_overrides={DET: 8}, allow_random_weights=True)
    hub = EngineHub(zoo, device="cpu", wire_format="bgr", max_batch=4)
    try:
        hub.engine("detect", DET).submit(frames=frames[0]).result(timeout=60)
        assert len(calls) == 10  # the SSD's ten pointwise GEMMs
    finally:
        hub.stop()
