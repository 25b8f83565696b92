"""Slice 3 (detect+classify) of the port against the reference, on the CPU.

Same inputs, made with seeded numpy, through the reference's function
(jitted, as its engine steps run it) and the port's. Tolerances:

* ``roi_grid_indices``: equal indices, including boxes whose grid
  positions land exactly on .5; ``crop_rois``: equal pixels;
  ``crop_rois_i420``: atol 1e-3 on the 0-255 scale (XLA fuses the
  BT.601 multiply-adds, the port rounds each);
* letterbox and central-crop: atol 1e-3 on the 0-255 scale (the same
  float32 weights, summed in another order);
* model-proc files: equal fields and equal preprocess specs;
* ``MultiHeadClassifier`` logits at float32: atol 1e-5; INT8 at float32
  (``xla`` and ``pallas``): max abs diff ≤ 1e-2 × max |ref| and ≥ 90 %
  of elements within 1e-4 (one int8 code can flip where the two
  frameworks' float sums differ in the last bit); INT8 bf16 from the
  reference's msgpack: 5e-2 × max |ref| (bf16 rounding at other
  places);
* classify and fused steps, float32: detection rows atol 1e-4, equal
  valid flags and labels, equal classified rows, probabilities atol
  1e-5, and every unclassified row's block exactly zero; INT8/pallas:
  where a detection row agrees with the reference's (same valid flag
  and label, box within 1e-3), the same classified flag and
  probabilities within 2e-2 (bf16 activations), and ≥ 95 % of rows
  agree.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evam_tpu.engine import steps as jsteps
from evam_tpu.graph.spec import StageKind as JKind
from evam_tpu.graph.spec import StageSpec as JSpec
from evam_tpu.modelproc import proc as jproc
from evam_tpu.models.registry import ModelRegistry as JaxRegistry
from evam_tpu.ops import color as jcolor
from evam_tpu.ops import preprocess as jprep
from evam_tpu.ops import qlinear as jql
from evam_tpu.stages import build as jbuild
from evam_tpu.stages import track as jtrack
from evam_tpu.stages.context import Region as JRegion
from evam_tpu.stages.context import Tensor as JTensor
from evam_tpu_torch.engine import steps as tsteps
from evam_tpu_torch.engine.batcher import BatchEngine
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.graph.spec import StageKind, StageSpec
from evam_tpu_torch.modelproc import proc as tproc
from evam_tpu_torch.models.convert import params_from_jax
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.models.zoo.layers import QuantConv, quantize_model
from evam_tpu_torch.ops import color as tcolor
from evam_tpu_torch.ops import preprocess as tprep
from evam_tpu_torch.ops import qlinear as tql
from evam_tpu_torch.stages import build as tbuild
from evam_tpu_torch.stages.context import Region, Tensor
from evam_tpu_torch.stages.track import RegionCoaster

torch.set_num_threads(1)
DET = "object_detection/person_vehicle_bike"
CLS = "object_classification/vehicle_attributes"
SMALL = dict(input_overrides={DET: (64, 64)}, width_overrides={DET: 8, CLS: 8},
             allow_random_weights=True)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
    monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")


# ------------------------------------------------------------ ROI grid


def _boxes(rng, h, w, n=300):
    """Random boxes (partly outside the frame) and boxes whose corners
    sit on multiples of 1/(2(h−1)) and 1/(2(w−1)), so that grid
    positions land on .5."""
    rand = rng.uniform(-0.1, 1.1, (n, 4))
    k = rng.integers(0, 2 * (max(h, w) - 1) + 1, (n, 2))
    half = np.stack([k[:, 0] / (2 * (w - 1)), k[:, 0] / (2 * (h - 1)),
                     k[:, 1] / (2 * (w - 1)), k[:, 1] / (2 * (h - 1))], 1)
    return np.concatenate([rand, half]).astype(np.float32)


@pytest.mark.parametrize("n", [24, 64, 72, 96])
def test_roi_grid_indices_equal_the_references(n):
    rng = np.random.default_rng(n)
    ties = 0
    for h, w in [(65, 129), (432, 768), (512, 512), (97, 33)]:
        boxes = _boxes(rng, h, w)
        ref = jax.jit(jax.vmap(
            lambda b: jprep.roi_grid_indices(b, (h, w), (n, n))))(boxes)
        got = tprep.roi_grid_indices(torch.from_numpy(boxes), (h, w), (n, n))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        # positions that are exactly x.5 in exact arithmetic
        lin = np.linspace(0.0, 1.0, n)
        y0, y1 = boxes[:, 1:2].astype(np.float64), boxes[:, 3:4].astype(np.float64)
        ys = y0 * (h - 1) + (y1 - y0) * (h - 1) * lin
        ties += int((np.abs(ys - np.floor(ys) - 0.5) < 1e-9).sum())
    assert ties > 100, ties  # the test reaches the rounding ties


def test_unit_grid_is_jax_linspace():
    for n in [*range(1, 34), 64, 72, 96, 127, 128]:
        np.testing.assert_array_equal(
            tprep._unit_grid(n, torch.device("cpu")).numpy(),
            np.asarray(jax.jit(lambda: jnp.linspace(0.0, 1.0, n))()))


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest to x, ties to even (exact)."""
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.int32)) & 1))
    return np.float32(best)


def test_fma32_rounds_once():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(500).astype(np.float32)
    b = rng.standard_normal(500).astype(np.float32)
    c = (rng.standard_normal(500) * 10.0 ** rng.integers(-9, 3, 500)).astype(np.float32)
    # a float64 sum that falls on a float32 midpoint while the exact
    # value lies below it: 1 + 2^-23 (odd) + (2^-24 − 2^-70)
    one = np.float32(1 + 2.0 ** -23)
    a = np.append(a, [np.float32(1 + 2.0 ** -23), np.float32(-(1 + 2.0 ** -23))])
    b = np.append(b, [np.float32(2.0 ** -24 * (1 - 2.0 ** -23))] * 2)
    c = np.append(c, [one, -one])
    got = tprep._fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    assert got[-2] == one  # not the tie-to-even 1 + 2^-22 of a float64 sum


# --------------------------------------------------------------- crops


def _frames(rng, b, h, w):
    return rng.integers(0, 256, (b, h, w, 3), np.uint8)


def _crop_boxes(rng, b, r):
    p = rng.uniform(-0.05, 1.05, (b, r, 2, 2))
    return np.concatenate([p.min(2), p.max(2)], -1).astype(np.float32)


def test_crop_rois_equals_the_references():
    rng = np.random.default_rng(1)
    frames, boxes = _frames(rng, 2, 48, 64), _crop_boxes(rng, 2, 5)
    ref = jax.jit(lambda f, b: jprep.crop_rois(f, b, (24, 20)))(frames, boxes)
    got = tprep.crop_rois(torch.from_numpy(frames), torch.from_numpy(boxes),
                          (24, 20))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 24, 20, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_crop_rois_i420_matches_the_references():
    rng = np.random.default_rng(2)
    i420 = rng.integers(0, 256, (2, 72, 64), np.uint8)
    boxes = _crop_boxes(rng, 2, 6)
    ref = jax.jit(lambda f, b: jcolor.crop_rois_i420(f, b, (72, 72)))(i420, boxes)
    got = tcolor.crop_rois_i420(torch.from_numpy(i420), torch.from_numpy(boxes),
                                (72, 72))
    assert got.shape == (2, 6, 72, 72, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", ["aspect-ratio", "central-crop"])
@pytest.mark.parametrize("src_hw,dst_hw", [((50, 30), (32, 24)),
                                           ((30, 50), (24, 32)),
                                           ((20, 20), (36, 28))])
def test_letterbox_and_central_crop_match_the_references(mode, src_hw, dst_hw):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 255, (2, *src_hw, 3)).astype(np.float32)
    kw = dict(resize=mode, color_space="RGB", dtype="float32")
    ref = jax.jit(lambda v: jprep.preprocess_bgr(
        v, jprep.PreprocessSpec(*dst_hw, **kw)))(x)
    got = tprep.preprocess_bgr(torch.from_numpy(x),
                               tprep.PreprocessSpec(*dst_hw, **kw))
    assert got.shape == (2, *dst_hw, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


# ---------------------------------------------------------- model-proc


_PROCS = {
    "full.json": {
        "json_schema_version": "2.0.0",
        "input_preproc": [{"format": "image", "params": {
            "color_space": "RGB", "resize": "aspect-ratio", "crop": "central"}}],
        "output_postproc": [
            {"attribute_name": "color", "converter": "tensor_to_label",
             "method": "softmax", "labels": ["white", "gray", "red"],
             "layer_name": "color"},
            {"attribute_name": "type", "labels": ["car", "bus"]}]},
    "letterbox.json": {"input_preproc": [{"params": {"resize": "aspect-ratio"}}],
                       "output_postproc": [{"labels": ["a", "b"]}]},
    "unknown_resize.json": {"input_preproc": [{"params": {"resize": "fit"}}]},
    "empty.json": {},
    "dumped.json": jproc.dump_model_proc(["x", "y"], attribute_name="color"),
}


@pytest.mark.parametrize("name", sorted(_PROCS))
def test_load_model_proc_matches_the_references(tmp_path, name):
    path = tmp_path / name
    path.write_text(json.dumps(_PROCS[name]))
    ref, got = jproc.load_model_proc(path), tproc.load_model_proc(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for h, w in [(72, 72), (64, 96)]:
        assert dataclasses.asdict(got.preprocess_spec(h, w, dtype="float32")) == \
            dataclasses.asdict(ref.preprocess_spec(h, w, dtype="float32"))
    assert got.labels_for(0) == ref.labels_for(0)
    assert got.labels_for(5) == ref.labels_for(5) == []
    assert tproc.dump_model_proc(["x"], "c") == jproc.dump_model_proc(["x"], "c")
    assert tproc.dump_model_proc(["x"]) == jproc.dump_model_proc(["x"])


def test_registry_reads_model_proc_files(tmp_path, caplog):
    """Labels and preprocessing come from the model's first readable
    model-proc file, as in the reference; a bad file is skipped."""
    (tmp_path / DET / "FP32").mkdir(parents=True)
    (tmp_path / DET / "FP32" / "a_bad.json").write_text("[1, 2]")
    (tmp_path / DET / "FP32" / "b.json").write_text(json.dumps({
        "input_preproc": [{"params": {"color_space": "RGB"}}],
        "output_postproc": [{"labels": ["bg", "walker", "car", "cycle"]}]}))
    (tmp_path / CLS / "FP32").mkdir(parents=True)
    (tmp_path / CLS / "FP32" / "proc.json").write_text(
        json.dumps(_PROCS["full.json"]))
    kw = dict(models_dir=tmp_path, dtype="float32", **SMALL)
    jreg, treg = JaxRegistry(**kw), ModelRegistry(device="cpu", **kw)
    with caplog.at_level(logging.WARNING):
        for key in (DET, CLS):
            jm, tm = jreg.get(key), treg.get(key)
            assert tm.labels == jm.labels
            assert tm.head_labels == jm.head_labels
            assert tm.head_is_prob == jm.head_is_prob == {}
            assert dataclasses.asdict(tm.preprocess) == \
                dataclasses.asdict(jm.preprocess)
            assert dataclasses.asdict(tm.model_proc) == \
                dataclasses.asdict(jm.model_proc)
    assert treg.get(DET).labels == ["bg", "walker", "car", "cycle"]
    assert treg.get(CLS).preprocess.resize == "central-crop"
    assert any("bad model-proc" in r.getMessage() and "a_bad.json" in r.getMessage()
               for r in caplog.records if r.name.startswith("evam_tpu_torch"))


# ---------------------------------------------------------- classifier


def _pair(key, dtype, precision, **extra):
    kw = {**SMALL, **extra}
    jm = JaxRegistry(dtype=dtype, precision=precision, **kw).get(key)
    tm = ModelRegistry(dtype=dtype, precision=precision, device="cpu",
                       **kw).get(key)
    return jm, tm


def _bridge(jm, tm):
    tm.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                           jm.params)))
    quantize_model(tm.module)


def _logits(jm, tm, x):
    jdtype = jax.tree.leaves(jm.params)[0].dtype
    ref = jax.jit(jm.forward)(jm.params, jnp.asarray(x, jdtype))
    tdtype = next(tm.module.parameters()).dtype
    with torch.inference_mode():
        got = tm.forward(torch.from_numpy(x).to(tdtype))
    return ({k: np.asarray(ref[k], np.float32) for k in ref},
            {k: v.float().numpy() for k, v in got.items()})


def _crops(seed, n=6):
    return np.random.default_rng(seed).uniform(0, 255, (n, 72, 72, 3)).astype(
        np.float32)


@pytest.mark.parametrize("precision,backend", [("FP32", "xla"),
                                               ("INT8", "xla"),
                                               ("INT8", "pallas")])
def test_classifier_matches_reference_via_params_from_jax(
        monkeypatch, precision, backend):
    monkeypatch.setattr(jql, "QGEMM_BACKEND", backend)
    monkeypatch.setattr(tql, "QGEMM_BACKEND", backend)
    jm, tm = _pair(CLS, "float32", precision)
    assert tm.module.quant == jm.module.quant == (precision == "INT8")
    _bridge(jm, tm)
    ref, got = _logits(jm, tm, _crops(4))
    assert list(got) == list(ref) == ["color", "type"]
    for k in ref:
        assert got[k].shape == ref[k].shape
        if precision == "FP32":
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5)
        else:
            diff = np.abs(got[k] - ref[k])
            assert diff.max() <= 1e-2 * np.abs(ref[k]).max()
            assert (diff <= 1e-4).mean() >= 0.9


@pytest.mark.usefixtures("pallas")
def test_int8_classifier_via_msgpack(tmp_path):
    jreg = JaxRegistry(models_dir=tmp_path, dtype="int8", **SMALL)
    jm = jreg.get(CLS)
    jreg.save_weights(CLS)
    tm = ModelRegistry(models_dir=tmp_path, dtype="int8", device="cpu",
                       **SMALL).get(CLS)
    assert tm.weight_source == "msgpack"
    assert next(tm.module.parameters()).dtype == torch.bfloat16
    ref, got = _logits(jm, tm, _crops(5))
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() <= 5e-2 * np.abs(ref[k]).max()


@pytest.mark.usefixtures("pallas")
def test_int8_classifier_sends_exactly_its_pointwise_convs_to_qgemm(monkeypatch):
    """The hand kernel's wrapper gets the three pointwise convs, at
    (M, K, N) = (B·324, w, 2w), (B·81, 2w, 4w), (B·25, 4w, 8w), and
    nothing else (the stem conv, depthwise convs and heads do not)."""
    _, tm = _pair(CLS, "int8", "BF16")
    quant = [m for m in tm.module.modules() if isinstance(m, QuantConv)]
    assert len(quant) == 4  # stem + three pointwise
    calls = []
    real = tql.qgemm

    def spy(x, wq, w_scale, bias=None):
        calls.append((x.shape[0], x.shape[1], wq.shape[0]))
        return real(x, wq, w_scale, bias)

    monkeypatch.setattr(tql, "qgemm", spy)
    with torch.inference_mode():
        tm.forward(torch.zeros((3, 72, 72, 3), dtype=torch.bfloat16))
    assert calls == [(3 * 324, 8, 16), (3 * 81, 16, 32), (3 * 25, 32, 64)]


def test_random_classifier_weights_are_seeded():
    a = ModelRegistry(device="cpu", dtype="float32", **SMALL).get(CLS)
    b = ModelRegistry(device="cpu", dtype="float32", **SMALL).get(CLS)
    assert a.weight_source == "random"
    sd_a, sd_b = a.module.state_dict(), b.module.state_dict()
    assert list(sd_a) == list(sd_b)
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    dense = sd_a["Dense_0.weight"]
    assert dense.shape == (7, 64) and dense.std() > 0  # lecun init, not zeros


# --------------------------------------------------------------- steps


def _step_models(dtype, precision):
    out = {}
    for key in (DET, CLS):
        jm, tm = _pair(key, dtype, precision)
        _bridge(jm, tm)
        out[key] = (jm, tm)
    return out


def _wire(rng, wire, n=3):
    bgr = _frames(rng, n, 64, 64)
    if wire == "bgr":
        return bgr
    return np.stack([tcolor.bgr_to_i420_host(f) for f in bgr])


_CASES = [("float32", "FP32"), ("int8", "BF16")]


#: the port's engine modes the parity tests run through: the default
#: engine and the legacy eager path
ENGINE_MODES = [("slot", "pipelined"), ("legacy", "inline")]


def _through_engines(ref_step, ref_params, port_step, inputs, mode):
    """Each item of ``inputs`` (name → [n, ...] arrays) submitted on its
    own to the reference's default engine (``plan=None``) and to the
    port's engine in ``mode`` (assembly, transfer); their rows stacked
    → (ref [n, ...], port [n, ...])."""
    from evam_tpu.engine.batcher import BatchEngine as RefEngine

    names = tuple(inputs)
    n = len(inputs[names[0]])
    ref_eng = RefEngine("parity-ref", ref_step, ref_params, plan=None,
                        max_batch=4, deadline_ms=50.0, input_names=names,
                        stall_timeout_s=0)
    port_eng = BatchEngine("parity-port", port_step, "cpu", max_batch=4,
                           deadline_ms=50.0, input_names=names,
                           assembly=mode[0], transfer=mode[1],
                           stall_timeout_s=0)
    try:
        items = [{k: v[i] for k, v in inputs.items()} for i in range(n)]
        ref = [ref_eng.submit(**it) for it in items]
        got = [port_eng.submit(**it) for it in items]
        return (np.stack([np.asarray(f.result(timeout=300)) for f in ref]),
                np.stack([f.result(timeout=300) for f in got]))
    finally:
        ref_eng.stop()
        port_eng.stop()


@pytest.mark.parametrize("wire", ["i420", "bgr"])
@pytest.mark.parametrize("dtype,precision", _CASES, ids=["float32", "int8"])
def test_classify_step_matches_reference(monkeypatch, wire, dtype, precision):
    if dtype == "int8":
        monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
        monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    jm, tm = _step_models(dtype, precision)[CLS]
    rng = np.random.default_rng(6)
    frames = _wire(rng, wire)
    boxes = _crop_boxes(rng, 3, 8)
    boxes[:, 5:] = 0.0  # unused budget rows, as the stage pads them
    ref = np.asarray(jax.jit(jsteps.build_classify_step(jm, wire_format=wire))(
        jm.params, frames, boxes))
    got = tsteps.build_classify_step(tm, wire_format=wire)(
        torch.from_numpy(frames), torch.from_numpy(boxes)).numpy()
    assert got.shape == ref.shape == (3, 8, 11) and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 2.0, rtol=0, atol=1e-5)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ENGINE_MODES, ids="+".join)
@pytest.mark.parametrize("allowed", [None, "one"], ids=["all", "allowed"])
@pytest.mark.parametrize("wire", ["i420", "bgr"])
@pytest.mark.parametrize("dtype,precision", _CASES, ids=["float32", "int8"])
def test_detect_classify_step_matches_reference(monkeypatch, allowed, wire,
                                                dtype, precision, mode):
    if dtype == "int8":
        monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
        monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    models = _step_models(dtype, precision)
    (jd, td), (jc, tc) = models[DET], models[CLS]
    frames = _wire(np.random.default_rng(7), wire)
    kw = dict(wire_format=wire, score_threshold=0.1)
    if allowed:
        # the label of the fewest valid detections: the filter leaves
        # valid rows unclassified
        plain = np.asarray(jax.jit(jsteps.build_detect_step(jd, **kw))(
            jd.params, frames))
        labels = plain[..., 5][plain[..., 6] > 0.5].astype(int)
        kw["allowed_label_ids"] = (int(np.bincount(labels, minlength=4)[1:]
                                       .argmin()) + 1,)
    ref, got = _through_engines(
        jsteps.build_detect_classify_step(jd, jc, **kw),
        {"det": jd.params, "cls": jc.params},
        tsteps.build_detect_classify_step(td, tc, **kw),
        {"frames": frames}, mode)
    assert got.shape == ref.shape == (3, 32, 18)
    ref_cls, got_cls = ref[..., 7:].sum(-1) > 0.5, got[..., 7:].sum(-1) > 0.5
    assert (got[~got_cls][:, 7:] == 0).all()  # unclassified: exactly zero
    valid = got[..., 6] > 0.5
    ok = (np.isin(got[..., 5], kw["allowed_label_ids"]) if allowed
          else np.ones_like(valid))
    assert not (got_cls & ~(valid & ok)).any()
    # the first 8 eligible rows of each frame (the ROI budget)
    np.testing.assert_array_equal(got_cls.sum(-1),
                                  np.minimum((valid & ok).sum(-1), 8))
    if allowed:
        assert (valid & ~ok).any()  # the filter leaves rows unclassified
    if dtype == "float32":
        np.testing.assert_array_equal(got[..., 6], ref[..., 6])
        np.testing.assert_array_equal(got[..., 5], ref[..., 5])
        np.testing.assert_allclose(got[..., :5], ref[..., :5], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got_cls, ref_cls)
        np.testing.assert_allclose(got[..., 7:], ref[..., 7:], rtol=0, atol=1e-5)
        return
    same = ((got[..., 6] == ref[..., 6]) & (got[..., 5] == ref[..., 5])
            & (np.abs(got[..., :4] - ref[..., :4]).max(-1) <= 1e-3))
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_array_equal(got_cls[same], ref_cls[same])
    np.testing.assert_allclose(got[same][:, 7:], ref[same][:, 7:], rtol=0,
                               atol=2e-2)


# ----------------------------------------------------- host-side parts


def _region_pairs(rng, n):
    out = []
    for _ in range(n):
        # float32 corners, as a detect stage reads them from its rows
        x0, y0 = rng.uniform(0, 0.8, 2).astype(np.float32)
        vals = dict(x0=float(x0), y0=float(y0),
                    x1=float(x0 + np.float32(0.15)),
                    y1=float(y0 + np.float32(0.2)), confidence=0.9,
                    label_id=int(rng.integers(1, 3)), label="vehicle")
        out.append((Region(**vals, tensors=[Tensor("detection", 0.9, 2)]),
                     JRegion(**vals, tensors=[JTensor("detection", 0.9, 2)])))
    return out


def test_region_coaster_is_the_references():
    """Fresh copies on reuse (an append touches only the copy), and the
    same boxes as the reference's coaster when coasting."""
    rng = np.random.default_rng(8)
    port, ref = RegionCoaster(), jtrack.RegionCoaster()
    for _ in range(3):
        pairs = _region_pairs(rng, 4)
        port.observe([p for p, _ in pairs])
        ref.observe([r for _, r in pairs])
    reused = port.reuse()
    originals = [p for p, _ in pairs]
    for copy, orig in zip(reused, originals):
        assert copy is not orig and copy.tensors is not orig.tensors
        assert copy == orig
        copy.tensors.append(Tensor("color", 0.5, 1))
        assert len(orig.tensors) == 1
    for steps in (0, 1, 3):
        got, want = port.coast(steps), ref.coast(steps)
        assert [(g.x0, g.y0, g.x1, g.y1, g.label_id) for g in got] == \
            [(w.x0, w.y0, w.x1, w.y1, w.label_id) for w in want]


@pytest.mark.parametrize("kinds,reclassify", [
    (["source", "decode", "detect", "classify", "metaconvert"], None),
    (["detect", "track", "convert", "classify"], None),
    (["detect", "classify"], 3),
    (["detect", "udf", "classify"], None),
    (["classify", "detect"], None),
    (["detect", "metaconvert"], None),
])
def test_fusion_pass_is_the_references(kinds, reclassify):
    props = {} if reclassify is None else {"reclassify-interval": reclassify}
    port = [StageSpec(StageKind(k), f"s{i}", dict(props) if k == "classify"
                      else {}) for i, k in enumerate(kinds)]
    ref = [JSpec(JKind(k), f"s{i}", dict(props) if k == "classify" else {})
           for i, k in enumerate(kinds)]
    assert tbuild._fusable(port) == jbuild._fusable(ref)


def test_engine_stacks_two_inputs_and_counts_units():
    """Frames and boxes stack per bucket; an item's ``units`` (its real
    boxes) count against the ROI budget the batch computes."""
    engine = BatchEngine("cls", lambda f, b: b.sum(-1) + f.float()[:, :1],
                         device="cpu", max_batch=4, deadline_ms=50.0,
                         input_names=("frames", "boxes"), max_units=8)
    try:
        futs = [engine.submit(units=u, frames=np.full((2,), i, np.uint8),
                              boxes=np.full((8, 4), i, np.float32))
                for i, u in enumerate([3, None, 1])]
        rows = [f.result(timeout=10) for f in futs]
        for i, row in enumerate(rows):
            np.testing.assert_array_equal(row, np.full((8,), 5.0 * i))
        st = engine.stats_row()
        assert (st["items"], st["units"]) == (3, 3 + 8 + 1)
        assert st["unit_slots"] == 8 * sum(int(b) * c for b, c in
                                           st["bucket_batches"].items())
        assert st["unit_occupancy"] == round(st["units"] / st["unit_slots"], 4)
    finally:
        engine.stop()


def test_hub_builds_classify_and_fused_engines():
    reg = ModelRegistry(device="cpu", dtype="float32", **SMALL)
    hub = EngineHub(reg, device="cpu", max_batch=4)
    try:
        cls = hub.engine("classify", CLS, roi_budget=8)
        assert cls.input_names == ("frames", "boxes") and cls.max_units == 8
        assert hub.engine("classify", CLS) is cls
        kw = dict(roi_budget=8, score_threshold=0.1, allowed_label_ids=(2,))
        fused = hub.fused_engine(DET, CLS, **kw)
        assert fused.name == (
            f"detect_classify:{DET}+{CLS}:allowed_label_ids=(2,),"
            "roi_budget=8,score_threshold=0.1")
        assert fused.input_names == ("frames",) and fused.max_units is None
        assert hub.fused_engine(DET, CLS, **kw) is fused
        assert hub.fused_engine(DET, CLS, **{**kw, "allowed_label_ids": None}) \
            is not fused
        assert hub.fused_engine(DET, CLS, "inst", **kw).name.startswith(
            "detect_classify:inst:")
        assert set(hub.stats()) == {f"classify:{CLS}", fused.name,
                                    f"detect_classify:{DET}+{CLS}:"
                                    "allowed_label_ids=None,roi_budget=8,"
                                    "score_threshold=0.1",
                                    "detect_classify:inst:allowed_label_ids=(2,),"
                                    "roi_budget=8,score_threshold=0.1"}
    finally:
        hub.stop()
