"""The accuracy harness (``evam_tpu_torch/models/accuracy.py``) against the
reference's (``evam_tpu/models/accuracy.py``), on the CPU.

The harness's fits are asserted to convergence only on the card
(``chip_smoke.py``'s ``accuracy`` and ``attrs`` phases: recall,
precision and attribute recall at the reference test's thresholds). Here
the port is held to the reference step by step, at a small size (SSD
64×64, width 8; classifier 32×32, width 8):

* ``render_scene`` (with and without ``color_attr``), ``match_anchors``,
  ``anchors_to_corner``, ``_pairwise_iou``, ``unpack_rows``,
  ``evaluate_packed`` and ``evaluate_attrs``: equal bit for bit (numpy
  copies), and the generator left in the same state;
* ``render_vehicle_crop``: equal bit for bit (0 bytes off, measured and
  asserted) once the reference's ``bgr_to_i420_host`` is swapped for the
  port's; against the reference as it stands, whose wire comes from
  ``cv2.cvtColor(BGR2YUV_I420)`` (20-bit BT.601 coefficients, where the
  port's encoder is the native library's 8-bit fixed point: 1 LSB apart
  on ~7 % of luma and ~13 % of chroma bytes), every byte within 2 and at
  most 12 % of bytes off (measured 9.6–9.8 %); the generator left in the
  same state either way;
* ``encode_boxes``: within 1e-6 of the reference's, relative past
  magnitude 1 (torch's and XLA's float32 logs differ by one ulp on ~9 %
  of inputs: 9.5e-7 at an offset of 8, 3.8e-6 at the ~57 an unmatched
  anchor's floored zero box encodes to); ``decode_boxes(encode_boxes(b))``
  within 1e-5 of ``b`` (the exp/log round trip at offsets up to ~10);
* ``resize_area_host``: equal to ``cv2.resize(INTER_AREA)`` byte for
  byte, fractional and integer ratios (skipped where cv2 is absent: the
  card's machine has none);
* the fits' training arrays and minibatch order: equal to the batches
  the reference's ``fit_detector`` and ``fit_classifier`` hand their
  jitted step, read by replacing ``jax.jit`` with a recorder for that
  call; ``_fit_loop``'s with-replacement indices equal to the
  reference's ``_fit_loop``'s on an index array;
* the loss at the initial weights (the reference's carried across with
  ``params_from_jax``; the classifier fed the reference's own crops):
  within 1e-5 relative (float32 sums in another order; measured ~1e-7);
* the parameters after one and after two Adam steps: within atol 1e-6
  wherever the reference's first step moved the entry by at least
  0.99·lr, i.e. its gradient has |g| >= 99·eps ≈ 1e-6 (Adam's first
  update is lr·g/(|g| + eps)); elsewhere within twice Adam's bound on
  each side's travel, 2·Σ_t lr_t·1.01 (its bias-corrected step is at
  most 1.0014·lr_t in the first two steps): a gradient within rounding
  of zero may point either way. Most of those entries are the dead
  relu6 units of the two 1×1 extra levels (gradient exactly zero on both
  sides);
* optax's Adam under ``cosine_decay_schedule`` against the port's
  written-out one on the same gradients: within 1e-7 (float32);
* a 40-step fit in the port, written by ``save_fitted`` (flax's bytes,
  equal to the reference's ``save_fitted`` of the same weights) and
  served from the models dir by both registries' ``build_detect_step``
  on 1080p i420 held-out scenes. float32: valid masks and labels equal,
  every field within 1e-5 (measured < 1e-6), the same
  ``evaluate_packed`` report. INT8 with the qgemm knob on (the
  reference's Pallas kernel in interpret mode, as its CPU tests run it;
  the port's plain qgemm): the two forwards round their bfloat16
  activations in other orders, and a 40-step fit leaves about 12 boxes
  a frame with close scores, so rows may reorder and a box near a
  threshold may flip: ≥ 95 % of each side's valid detections matched by
  the other's (same label, IoU ≥ 0.9: the slice's INT8 tolerance,
  ``tests/test_torch_slice.py``), the same ground truth, and true
  positives within one box in twenty;
* that detector with a 30-step port classifier fit beside it, both
  served by both registries' ``build_detect_classify_step`` (the
  reference test's arguments) on 1080p i420 ``color_attr`` scenes.
  float32: valid masks, labels and classified rows equal, every field
  within 1e-5, the same ``evaluate_attrs`` report. INT8: detections
  matched as above; where a row agrees with the other side's (same valid
  flag and label, box within 1e-3) the same classified flag and
  probabilities within 2e-2 (``tests/test_torch_classify.py``'s INT8
  tolerance: bfloat16 activations); the same ground truth and attribute
  hits within one vehicle in twenty.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evam_tpu.engine.steps import build_detect_classify_step as \
    jax_detect_classify_step
from evam_tpu.engine.steps import build_detect_step as jax_detect_step
from evam_tpu.models import accuracy as ref
from evam_tpu.models.registry import ModelRegistry as JaxRegistry
from evam_tpu.ops import color as jcolor
from evam_tpu.ops import qlinear as jql
from evam_tpu.ops.boxes import decode_boxes as jax_decode_boxes
from evam_tpu.ops.boxes import encode_boxes as jax_encode_boxes
from evam_tpu_torch.engine.steps import (
    build_detect_classify_step,
    build_detect_step,
)
from evam_tpu_torch.models import accuracy as acc
from evam_tpu_torch.models.convert import params_from_jax
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.ops import qlinear as tql
from evam_tpu_torch.ops.boxes import decode_boxes, encode_boxes
from evam_tpu_torch.ops.color import bgr_to_i420_host, resize_area_host

torch.set_num_threads(1)
KEY = "object_detection/person_vehicle_bike"
CLS = "object_classification/vehicle_attributes"
SMALL = dict(input_overrides={KEY: (64, 64)}, width_overrides={KEY: 8})
CLS_SMALL = dict(input_overrides={CLS: (32, 32)}, width_overrides={CLS: 8})
LR = 3e-3
#: a fit's data at the small size: half the scenes at 1080p, shrunk
FIT = dict(n_scenes=8, batch=4)


def _jax_model(**kw):
    return JaxRegistry(dtype="float32", allow_random_weights=True,
                       **SMALL, **kw).get(KEY)


def _port_model(jm=None):
    """The port's float32 SSD at the small size, on the CPU, with the
    reference model's initial weights when ``jm`` is given."""
    tm = ModelRegistry(dtype="float32", device="cpu",
                       allow_random_weights=True, **SMALL).get(KEY)
    if jm is not None:
        tm.module.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, jm.params)))
    return tm


def _state(tree) -> dict[str, torch.Tensor]:
    return params_from_jax(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def models():
    jm = _jax_model()
    return jm, _port_model(jm)


# ------------------------------------------------------ numpy copies


@pytest.mark.parametrize("hw", [(96, 96), (1080, 1920)], ids=str)
@pytest.mark.parametrize("color_attr", [False, True])
@pytest.mark.parametrize("seed", [0, 3, 99])
def test_render_scene_equals_reference(seed, color_attr, hw):
    rng_ref, rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        want = ref.render_scene(rng_ref, hw=hw, color_attr=color_attr)
        got = acc.render_scene(rng, hw=hw, color_attr=color_attr)
        for field in ("frame", "boxes", "labels", "attrs"):
            a, b = getattr(want, field), getattr(got, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(b, a, err_msg=field)
    assert rng.integers(0, 2**62) == rng_ref.integers(0, 2**62)


@pytest.mark.parametrize("pos_iou", [0.4, 0.5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_anchors_equals_reference(models, seed, pos_iou):
    jm, tm = models
    np.testing.assert_array_equal(tm.anchors, np.asarray(jm.anchors))
    corners = acc.anchors_to_corner(tm.anchors)
    want_c = ref.anchors_to_corner(np.asarray(jm.anchors, np.float32))
    np.testing.assert_array_equal(corners, want_c)
    rng = np.random.default_rng(seed)
    for _ in range(4):
        scene = acc.render_scene(rng, hw=(64, 64))
        want = ref.match_anchors(want_c, scene, pos_iou=pos_iou)
        got = acc.match_anchors(corners, scene, pos_iou=pos_iou)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
        assert (got[0] > 0).sum() >= len(scene.boxes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_iou_equals_reference(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (40, 4)).astype(np.float32)
    b = rng.uniform(0, 1, (7, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b[:, 2:] = b[:, :2] + b[:, 2:] * 0.3
    b[0] = (0.2, 0.2, 0.2, 0.5)  # empty: the 1e-9 floor
    got = acc._pairwise_iou(a, b)
    np.testing.assert_array_equal(got, ref._pairwise_iou(a, b))
    assert acc._max_iou(a[0], b) == ref._max_iou(a[0], b)


def _packed_rows(rng, scenes, k=16):
    """Detections around each scene's boxes (jittered, some with a wrong
    label, some invalid) plus noise rows: [B, k, 7 + 2]."""
    out = np.zeros((len(scenes), k, 9), np.float32)
    for i, s in enumerate(scenes):
        rows = []
        for box, label in zip(s.boxes, s.labels):
            for _ in range(2):
                jit = box + rng.normal(0, 0.04, 4).astype(np.float32)
                lab = label if rng.uniform() < 0.8 else rng.integers(1, 4)
                rows.append([*jit, rng.uniform(0.3, 1), lab,
                             float(rng.uniform() < 0.85),
                             *rng.uniform(0, 1, 2)])
        while len(rows) < k:
            x0, y0 = rng.uniform(0, 0.8, 2)
            rows.append([x0, y0, x0 + 0.2, y0 + 0.2, rng.uniform(0, 1),
                         rng.integers(1, 4), float(rng.uniform() < 0.5),
                         0, 0])
        out[i] = np.asarray(rows[:k], np.float32)
    return out


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_unpack_rows_and_evaluate_packed_equal_reference(seed):
    rng = np.random.default_rng(seed)
    scenes = [acc.render_scene(rng, hw=(64, 64)) for _ in range(6)]
    packed = _packed_rows(rng, scenes)
    for rows in packed:
        want, got = ref.unpack_rows(rows), acc.unpack_rows(rows)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            assert g["score"] == w["score"] and g["label_id"] == w["label_id"]
            np.testing.assert_array_equal(g["box"], w["box"])
    for thresh in (0.5, 0.3):
        want = ref.evaluate_packed(packed, scenes, iou_thresh=thresh)
        got = acc.evaluate_packed(packed, scenes, iou_thresh=thresh)
        assert got == want
        # not a trivial report: boxes found, false positives among them
        assert got["recall"] > 0 and got["precision"] < 1


# ----------------------------------------------------------- helpers


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_boxes_matches_reference_and_inverts_decode(models, seed):
    jm, _ = models
    rng = np.random.default_rng(seed)
    anchors = np.asarray(jm.anchors, np.float32)
    n = anchors.shape[0]
    xy = rng.uniform(0, 0.7, (3, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.02, 0.3, (3, n, 2))],
                           -1).astype(np.float32)
    boxes[0, :5] = 0.0  # unmatched anchors' zero targets: the 1e-6 floor
    want = np.asarray(jax_encode_boxes(jnp.asarray(boxes),
                                       jnp.asarray(anchors)))
    got = encode_boxes(torch.from_numpy(boxes), torch.from_numpy(anchors))
    assert got.shape == want.shape and got.dtype == torch.float32
    # 1e-6, relative past magnitude 1: torch's and XLA's float32 logs
    # differ by one ulp on ~9 % of inputs, 9.5e-7 at |offset| 8 and
    # 3.8e-6 at the floored targets' ~57
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 1e-6 * np.maximum(1.0, np.abs(want)))
    back = decode_boxes(got, torch.from_numpy(anchors))
    np.testing.assert_allclose(back.numpy()[1:], boxes[1:], rtol=0,
                               atol=1e-5)
    # the reference's decode of the port's offsets, too
    np.testing.assert_allclose(
        np.asarray(jax_decode_boxes(jnp.asarray(got.numpy()[1:]),
                                    jnp.asarray(anchors))),
        boxes[1:], rtol=0, atol=1e-5)


AREA_CASES = [
    ((1080, 1920, 3), (96, 96)), ((1080, 1920, 3), (512, 512)),
    ((1080, 1920, 3), (64, 64)), ((99, 77, 3), (33, 7)),
    ((100, 130, 3), (37, 41)), ((1080, 1920, 3), (1080, 1)),
    ((1080, 1920, 3), (540, 960)), ((1080, 1920, 3), (360, 640)),
    ((1080, 1920, 3), (270, 480)), ((90, 60, 1), (30, 20)),
    ((64, 64, 2), (32, 32)), ((64, 64, 4), (32, 32)), ((64, 64), (32, 32)),
    ((100, 100), (30, 40)), ((5, 5, 3), (5, 5)),
]


@pytest.mark.parametrize("shape,out_hw", AREA_CASES, ids=str)
def test_resize_area_host_equals_cv2(shape, out_hw):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(sum(shape) + sum(out_hw))
    frame = rng.integers(0, 256, shape, np.uint8)
    got = resize_area_host(frame, *out_hw)
    want = cv2.resize(frame, out_hw[::-1], interpolation=cv2.INTER_AREA)
    assert got.shape == frame.shape[:0] + out_hw + frame.shape[2:]
    # cv2 drops a single channel's axis
    np.testing.assert_array_equal(got, want.reshape(got.shape))


def test_resize_area_host_equals_cv2_on_a_scene():
    cv2 = pytest.importorskip("cv2")
    scene = acc.render_scene(np.random.default_rng(4))
    for out_hw in ((96, 96), (512, 512)):
        np.testing.assert_array_equal(
            resize_area_host(scene.frame, *out_hw),
            cv2.resize(scene.frame, out_hw[::-1],
                       interpolation=cv2.INTER_AREA))


def test_resize_area_host_only_shrinks():
    frame = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError):
        resize_area_host(frame, 16, 8)
    with pytest.raises(ValueError):
        resize_area_host(frame.astype(np.float32), 4, 4)


# --------------------------------------------------------------- fit


def _recording_jit(seen):
    """A ``jax.jit`` stand-in that records the batches handed to the
    reference's ``train_step`` and returns its inputs unchanged."""
    real_jit = jax.jit

    def recorder(fn=None, **kw):
        if getattr(fn, "__name__", None) != "train_step":  # optax's own
            return real_jit(fn, **kw) if fn else (
                lambda f: real_jit(f, **kw))

        def step(params, opt_state, *arrays):
            seen.append(tuple(np.asarray(a) for a in arrays))
            return params, opt_state, jnp.float32(0)
        return step
    return recorder


@pytest.mark.parametrize("n_scenes,batch,steps",
                         [(8, 4, 5), (10, 4, 7), (6, 8, 3)])
def test_fit_data_and_order_equal_the_references(models, monkeypatch,
                                                 n_scenes, batch, steps):
    """The batches the reference's fit hands its jitted step, in order,
    against the port's arrays indexed by the port's order."""
    pytest.importorskip("cv2")  # the reference shrinks with cv2
    jm, tm = models
    seen = []
    monkeypatch.setattr(jax, "jit", _recording_jit(seen))
    ref.fit_detector(jm, seed=7, n_scenes=n_scenes, steps=steps,
                     batch=batch)
    monkeypatch.undo()
    rng = np.random.default_rng(7)
    arrays = acc._fit_data(tm, rng, n_scenes)
    order = acc._minibatches(rng, n_scenes, steps, batch)
    assert [a.dtype for a in arrays] == [np.uint8, np.int32, np.float32]
    assert arrays[0].shape == (n_scenes, 64, 64, 3)
    assert len(seen) == steps == len(order)
    for want, idx in zip(seen, order):
        for w, a in zip(want, arrays):
            assert w.dtype == a.dtype
            np.testing.assert_array_equal(a[idx], w)


@pytest.fixture(scope="module")
def first_steps(models):
    """One- and two-step fits of both packages from the same initial
    weights: {steps: (reference state, port state, reference history,
    port history)}."""
    jm, tm = models
    out = {}
    for steps in (1, 2):
        rp, rh = ref.fit_detector(jm, steps=steps, **FIT)
        tp, th = acc.fit_detector(tm, steps=steps, device="cpu", **FIT)
        out[steps] = (_state(rp), tp, rh, th)
    return out


def _adam_travel(steps: int, lr: float = LR) -> float:
    """Adam's bound on how far one entry moves in ``steps`` steps of the
    fit's schedule (its bias-corrected step is at most 1.0014·lr_t in
    the first two; 1.01 leaves margin)."""
    sched = acc._Adam([], lr, steps)
    return 1.01 * sum(sched.learning_rate(t) for t in range(steps))


@pytest.mark.parametrize("steps", [1, 2])
def test_fit_loss_and_first_updates_match_reference(models, first_steps,
                                                    steps):
    _assert_first_updates(*models, first_steps, steps)


def _assert_first_updates(jm, tm, first_steps, steps, lr=LR):
    """The port's loss history and parameters after ``steps`` Adam steps
    of learning rate ``lr`` against the reference's, from the
    reference's initial weights (the module docstring's tolerances); the
    port's model left as it was."""
    init = _state(jm.params)
    want, got, rh, th = first_steps[steps]
    assert len(th) == len(rh) == steps
    np.testing.assert_allclose(th, rh, rtol=1e-5)
    # the model the caller passed is left as it was
    for k, v in tm.module.state_dict().items():
        torch.testing.assert_close(v, init[k], rtol=0, atol=0)
    moved1 = {k: (first_steps[1][0][k] - init[k]).abs()
              for k in init}
    tight = total = 0
    for k in init:
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32
        diff = (got[k] - want[k]).abs()
        # |g| >= 99·eps on the reference's side: its first step moved the
        # entry by lr·|g| / (|g| + eps) >= 0.99·lr
        well = moved1[k] >= 0.99 * lr
        tight += int(well.sum())
        total += well.numel()
        if well.any():
            assert float(diff[well].max()) <= 1e-6, k
        assert float(diff.max()) <= 2 * _adam_travel(steps, lr), k
    assert tight >= 0.05 * total, (tight, total)


def test_adam_equals_optax_under_the_cosine_schedule():
    import optax

    rng = np.random.default_rng(0)
    shapes = [(3, 4), (7,), (2, 3, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.adam(optax.cosine_decay_schedule(LR, 6, alpha=0.05))
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    tparams = [torch.tensor(p) for p in params]
    opt = acc._Adam(tparams, LR, 6)
    for _ in range(8):  # past the schedule's end: its floor, alpha·lr
        grads = [rng.normal(size=s).astype(np.float32) * 10.0 ** rng.
                 integers(-4, 1) for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state,
                               jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.step([torch.tensor(g) for g in grads])
        for a, b in zip(jparams, tparams):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-7)
    assert opt.learning_rate(8) == pytest.approx(0.05 * LR)


def test_fit_detector_runs_on_the_card_unless_asked(models):
    _, tm = models
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        acc.fit_detector(tm, steps=1, n_scenes=2, batch=2)


# ---------------------------------------------- served in both packages


@pytest.fixture(scope="module")
def fitted_dir(tmp_path_factory):
    """A 40-step fit in the port, written by ``save_fitted``."""
    tm = _port_model()
    state, history = acc.fit_detector(tm, steps=40, n_scenes=16,
                                      device="cpu")
    assert all(np.isfinite(history)) and history[-1] < history[0]
    root = tmp_path_factory.mktemp("fitted")
    path = acc.save_fitted(state, KEY, root)
    assert path == root / KEY / "FP32" / "weights.msgpack"
    return root, state


def test_save_fitted_writes_the_references_bytes(fitted_dir, tmp_path):
    from evam_tpu_torch.models.convert import params_to_jax

    root, state = fitted_dir
    tree = jax.tree.map(lambda t: t.numpy(), params_to_jax(state))
    ref_path = ref.save_fitted(tree, KEY, tmp_path)
    assert (root / KEY / "FP32" / "weights.msgpack").read_bytes() \
        == ref_path.read_bytes()


def _holdout(n=8, seed=99, color_attr=False):
    rng = np.random.default_rng(seed)
    scenes = [acc.render_scene(rng, hw=(1080, 1920), color_attr=color_attr)
              for _ in range(n)]
    return scenes, np.stack([bgr_to_i420_host(s.frame) for s in scenes])


def _iou(a, b):
    lt = np.maximum(a[:2], b[:, :2])
    rb = np.minimum(a[2:4], b[:, 2:4])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
    area = lambda x: np.prod(np.clip(x[..., 2:4] - x[..., :2], 0, None), -1)
    return inter / np.maximum(area(a) + area(b) - inter, 1e-9)


def _matched_share(ref_rows, got_rows) -> float:
    """Share of ``ref_rows``' valid detections matched by a ``got_rows``
    detection of the same label with IoU ≥ 0.9."""
    matched = total = 0
    for r, g in zip(ref_rows, got_rows):
        g = g[g[:, 6] > 0.5]
        for row in r[r[:, 6] > 0.5]:
            total += 1
            same = g[g[:, 5] == row[5]]
            matched += bool(len(same) and (_iou(row, same) >= 0.9).any())
    assert total > 0
    return matched / total


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fitted_weights_serve_alike_in_both_packages(fitted_dir, monkeypatch,
                                                     dtype):
    root, _ = fitted_dir
    if dtype == "int8":
        monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
        monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    jm = JaxRegistry(dtype=dtype, models_dir=str(root), **SMALL).get(KEY)
    tm = ModelRegistry(dtype=dtype, models_dir=root, device="cpu",
                       **SMALL).get(KEY)
    assert jm.weight_source == tm.weight_source == "msgpack"
    assert tm.module.quant == (dtype == "int8")
    scenes, wire = _holdout()
    kw = dict(max_detections=16, score_threshold=0.3, wire_format="i420")
    want = np.asarray(jax.jit(jax_detect_step(jm, **kw))(jm.params, wire))
    got = build_detect_step(tm, **kw)(torch.from_numpy(wire)).numpy()
    assert got.shape == want.shape == (8, 16, 7)
    report_ref = ref.evaluate_packed(want, scenes)
    report = acc.evaluate_packed(got, scenes)
    assert report_ref["detections"] > 0
    if dtype == "float32":
        np.testing.assert_array_equal(got[..., 5:], want[..., 5:])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert report == report_ref
        return
    assert _matched_share(want, got) >= 0.95
    assert _matched_share(got, want) >= 0.95
    assert report["gt"] == report_ref["gt"]
    tp = round(report["recall"] * report["gt"])
    tp_ref = round(report_ref["recall"] * report_ref["gt"])
    assert abs(tp - tp_ref) <= max(1, report["gt"] // 20), (report,
                                                            report_ref)


def test_fit_fits_a_copy_in_float32(models):
    """The fit trains a float32 copy of the served module: a bfloat16
    registry's model comes back with float32 weights, itself untouched."""
    _, tm32 = models
    tm = ModelRegistry(dtype="bfloat16", device="cpu",
                       allow_random_weights=True, **SMALL).get(KEY)
    before = copy.deepcopy(tm.module.state_dict())
    state, history = acc.fit_detector(tm, steps=2, n_scenes=2, batch=2,
                                      device="cpu")
    assert len(history) == 2 and all(np.isfinite(history))
    assert {v.dtype for v in state.values()} == {torch.float32}
    assert state.keys() == tm32.module.state_dict().keys()
    for k, v in tm.module.state_dict().items():
        assert v.dtype == torch.bfloat16
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


# ------------------------------------------------------ the classifier


def _cls_jax_model(**kw):
    return JaxRegistry(dtype="float32", allow_random_weights=True,
                       **CLS_SMALL, **kw).get(CLS)


@pytest.fixture(scope="module")
def cls_models():
    jm = _cls_jax_model()
    tm = ModelRegistry(dtype="float32", device="cpu",
                       allow_random_weights=True, **CLS_SMALL).get(CLS)
    tm.module.load_state_dict(_state(jm.params))
    return jm, tm


@pytest.fixture
def ports_wire(monkeypatch):
    """The reference's ``render_vehicle_crop`` on the port's wire encoder
    (it imports ``bgr_to_i420_host`` from ``evam_tpu.ops.color`` when
    called)."""
    monkeypatch.setattr(jcolor, "bgr_to_i420_host", bgr_to_i420_host)


def _crop_pairs(seed, out_hw):
    """(reference crop, port crop) for every attr, twice each, from two
    generators of one seed; asserts they are left in the same state."""
    rng_ref, rng = np.random.default_rng(seed), np.random.default_rng(seed)
    pairs = []
    for attr in range(len(acc.ATTR_COLORS_BGR)):
        for _ in range(2):
            want = ref.render_vehicle_crop(rng_ref, attr, out_hw)
            got = acc.render_vehicle_crop(rng, attr, out_hw)
            assert got.dtype == want.dtype == np.uint8
            assert got.shape == want.shape == out_hw + (3,)
            pairs.append((want, got))
    assert rng.integers(0, 2**62) == rng_ref.integers(0, 2**62)
    return pairs


@pytest.mark.parametrize("out_hw", [(32, 32), (72, 72)], ids=str)
@pytest.mark.parametrize("seed", [0, 4, 17])
def test_render_vehicle_crop_equals_reference(ports_wire, seed, out_hw):
    for want, got in _crop_pairs(seed, out_hw):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_hw", [(32, 32), (72, 72)], ids=str)
@pytest.mark.parametrize("seed", [0, 4, 17])
def test_render_vehicle_crop_against_the_cv2_wire(seed, out_hw):
    """The reference as it stands encodes its wire with cv2: bytes
    within 2, at most 12 % of them off (measured 9.6–9.8 %)."""
    pytest.importorskip("cv2")
    off = total = 0
    for want, got in _crop_pairs(seed, out_hw):
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 2
        off += int((diff > 0).sum())
        total += diff.size
    assert 0 < off <= 0.12 * total, off / total


@pytest.mark.parametrize("n,batch,steps", [(10, 4, 6), (7, 3, 5), (64, 32, 3)])
def test_fit_loop_draws_the_references_minibatches(monkeypatch, n, batch,
                                                   steps):
    seen = []
    monkeypatch.setattr(jax, "jit", _recording_jit(seen))
    ref._fit_loop(None, (np.arange(n),), init_params={}, steps=steps,
                  batch=batch, lr=LR, rng=np.random.default_rng(5),
                  name="order")
    monkeypatch.undo()
    want = [idx for (idx,) in seen]
    got = []

    def loss_fn(net, idx):
        got.append(idx.numpy())
        return (net(torch.ones(1, 1)) ** 2).sum()

    rng = np.random.default_rng(5)
    state, history = acc._fit_loop(
        loss_fn, (np.arange(n),), init_params=torch.nn.Linear(1, 1),
        steps=steps, batch=batch, lr=LR, rng=rng, name="order",
        device="cpu")
    assert len(got) == len(want) == steps
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        acc._replacement_batches(np.random.default_rng(5), n, steps, batch),
        np.stack(want))
    # the loss at step 0 and at the last; the generator used as the
    # reference's (its next draw equal)
    assert len(history) == min(steps, 2)
    rng_ref = np.random.default_rng(5)
    for _ in range(steps):
        rng_ref.integers(0, n, size=batch)
    assert rng.integers(0, 2**62) == rng_ref.integers(0, 2**62)
    assert state["weight"].dtype == torch.float32


@pytest.mark.parametrize("n_crops,batch,steps", [(12, 4, 5), (9, 5, 3)])
def test_classifier_data_and_order_equal_the_references(
        cls_models, ports_wire, monkeypatch, n_crops, batch, steps):
    """The batches the reference's ``fit_classifier`` hands its jitted
    step, in order, against the port's arrays indexed by the port's
    order (the reference on the port's wire encoder: equal crops)."""
    jm, tm = cls_models
    seen = []
    monkeypatch.setattr(jax, "jit", _recording_jit(seen))
    ref.fit_classifier(jm, seed=3, n_crops=n_crops, steps=steps, batch=batch)
    monkeypatch.undo()
    rng = np.random.default_rng(3)
    crops, attrs = acc._classifier_data(tm, rng, n_crops)
    order = acc._replacement_batches(rng, n_crops, steps, batch)
    assert crops.dtype == np.uint8 and crops.shape == (n_crops, 32, 32, 3)
    assert attrs.dtype == np.int64 and set(attrs) <= set(range(7))
    assert len(seen) == steps == len(order)
    for (w_crops, w_attrs), idx in zip(seen, order):
        np.testing.assert_array_equal(crops[idx], w_crops)
        np.testing.assert_array_equal(attrs[idx], w_attrs)


def _attr_rows(rng, scenes, k=16):
    """Fused rows [B, k, 7 + 7 + 4] around each scene's boxes: jittered,
    some with a wrong label, some invalid, most of a vehicle's with the
    right colour's argmax, some with their probability block zeroed
    (skipped by the ROI budget); then noise rows."""
    out = np.zeros((len(scenes), k, 18), np.float32)
    for i, s in enumerate(scenes):
        rows = []
        for box, label, attr in zip(s.boxes, s.labels, s.attrs):
            for _ in range(2):
                jit = box + rng.normal(0, 0.03, 4).astype(np.float32)
                lab = label if rng.uniform() < 0.85 else rng.integers(1, 4)
                probs = rng.dirichlet(np.ones(7))
                if attr >= 0 and rng.uniform() < 0.6:
                    probs[attr] += 1.0  # the right colour's argmax
                probs *= rng.uniform() < 0.85
                rows.append([*jit, rng.uniform(0.3, 1), lab,
                             float(rng.uniform() < 0.9), *probs,
                             *rng.dirichlet(np.ones(4))])
        while len(rows) < k:
            x0, y0 = rng.uniform(0, 0.8, 2)
            rows.append([x0, y0, x0 + 0.2, y0 + 0.2, rng.uniform(0, 1),
                         rng.integers(1, 4), float(rng.uniform() < 0.5),
                         *rng.dirichlet(np.ones(7)), *np.zeros(4)])
        out[i] = np.asarray(rows[:k], np.float32)
    return out


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_evaluate_attrs_equals_reference(seed):
    rng = np.random.default_rng(seed)
    scenes = [acc.render_scene(rng, hw=(64, 64), color_attr=True)
              for _ in range(12)]
    packed = _attr_rows(rng, scenes)
    reports = []
    for thresh in (0.5, 0.3):
        want = ref.evaluate_attrs(packed, scenes, iou_thresh=thresh)
        got = acc.evaluate_attrs(packed, scenes, iou_thresh=thresh)
        assert got == want
        reports.append(got)
    # not a trivial report: vehicles found and missed
    assert reports[0]["gt"] > 0
    assert 0 < reports[1]["attr_recall"] < 1, reports[1]
    # the colour argmax decides: the same rows with the blocks rolled
    rolled = packed.copy()
    rolled[..., 7:14] = np.roll(packed[..., 7:14], 1, axis=-1)
    assert (acc.evaluate_attrs(rolled, scenes)
            == ref.evaluate_attrs(rolled, scenes))


def _ref_classifier_data(model, rng, n_crops):
    """``_classifier_data`` as the reference's ``fit_classifier`` makes
    it, with the reference's own crops (its cv2 wire)."""
    h, w = model.spec.input_size
    attrs = rng.integers(0, len(acc.ATTR_COLORS_BGR), size=n_crops)
    return np.stack([ref.render_vehicle_crop(rng, int(a), (h, w))
                     for a in attrs]), attrs


#: the classifier's fit at the small size: 32 crops, batches of 8
CLS_FIT = dict(n_crops=32, batch=8)


@pytest.fixture(scope="module")
def cls_first_steps(cls_models):
    """One- and two-step classifier fits of both packages from the same
    initial weights and the reference's crops: {steps: (reference state,
    port state, reference history, port history)}."""
    jm, tm = cls_models
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(acc, "_classifier_data", _ref_classifier_data)
        for steps in (1, 2):
            rp, rh = ref.fit_classifier(jm, steps=steps, **CLS_FIT)
            tp, th = acc.fit_classifier(tm, steps=steps, device="cpu",
                                        **CLS_FIT)
            out[steps] = (_state(rp), tp, rh, th)
    return out


@pytest.mark.parametrize("steps", [1, 2])
def test_fit_classifier_loss_and_first_updates_match_reference(
        cls_models, cls_first_steps, steps):
    _assert_first_updates(*cls_models, cls_first_steps, steps)


def test_fit_classifier_runs_on_the_card_unless_asked(cls_models):
    _, tm = cls_models
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        acc.fit_classifier(tm, steps=1, n_crops=2, batch=2)


def test_fit_classifier_fits_a_copy_in_float32(cls_models):
    _, tm32 = cls_models
    tm = ModelRegistry(dtype="bfloat16", device="cpu",
                       allow_random_weights=True, **CLS_SMALL).get(CLS)
    before = copy.deepcopy(tm.module.state_dict())
    timings = {}
    state, history = acc.fit_classifier(tm, steps=2, n_crops=4, batch=2,
                                        device="cpu", timings=timings)
    assert len(history) == 2 and all(np.isfinite(history))
    assert timings.keys() == {"data_s", "steps_s"}
    assert {v.dtype for v in state.values()} == {torch.float32}
    assert state.keys() == tm32.module.state_dict().keys()
    for k, v in tm.module.state_dict().items():
        assert v.dtype == torch.bfloat16
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


# --------------------------------- detect+classify served in both packages

BOTH_SMALL = dict(input_overrides={KEY: (64, 64), CLS: (32, 32)},
                  width_overrides={KEY: 8, CLS: 8})


@pytest.fixture(scope="module")
def fitted_pair_dir(fitted_dir, tmp_path_factory):
    """The 40-step detector beside a 30-step port classifier fit, both
    written by ``save_fitted``."""
    _, det_state = fitted_dir
    tm = ModelRegistry(dtype="float32", device="cpu",
                       allow_random_weights=True, **CLS_SMALL).get(CLS)
    state, history = acc.fit_classifier(tm, steps=30, n_crops=64, batch=16,
                                        device="cpu")
    assert all(np.isfinite(history)) and history[-1] < history[0]
    root = tmp_path_factory.mktemp("fitted_pair")
    acc.save_fitted(det_state, KEY, root)
    acc.save_fitted(state, CLS, root)
    return root


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fitted_pair_serves_alike_in_both_packages(fitted_pair_dir,
                                                   monkeypatch, dtype):
    root = fitted_pair_dir
    if dtype == "int8":
        monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
        monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    jreg = JaxRegistry(dtype=dtype, models_dir=str(root), **BOTH_SMALL)
    treg = ModelRegistry(dtype=dtype, models_dir=root, device="cpu",
                         **BOTH_SMALL)
    (jd, jc), (td, tc) = ((r.get(KEY), r.get(CLS)) for r in (jreg, treg))
    for m in (jd, jc, td, tc):
        assert m.weight_source == "msgpack"
    assert tc.module.quant == (dtype == "int8")
    scenes, wire = _holdout(seed=123, color_attr=True)
    kw = dict(max_detections=16, roi_budget=8, score_threshold=0.3,
              wire_format="i420", allowed_label_ids=(2,))
    want = np.asarray(jax.jit(jax_detect_classify_step(jd, jc, **kw))(
        {"det": jd.params, "cls": jc.params}, wire))
    got = build_detect_classify_step(td, tc, **kw)(
        torch.from_numpy(wire)).numpy()
    assert got.shape == want.shape == (8, 16, 18)
    report_ref = ref.evaluate_attrs(want, scenes)
    report = acc.evaluate_attrs(got, scenes)
    got_cls, want_cls = got[..., 7:].sum(-1) > 0, want[..., 7:].sum(-1) > 0
    assert report_ref["gt"] > 0 and want_cls.any()
    assert (got[~got_cls][:, 7:] == 0).all()
    if dtype == "float32":
        np.testing.assert_array_equal(got[..., 5:7], want[..., 5:7])
        np.testing.assert_array_equal(got_cls, want_cls)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert report == report_ref
        return
    assert _matched_share(want, got) >= 0.95
    assert _matched_share(got, want) >= 0.95
    same = ((got[..., 6] == want[..., 6]) & (got[..., 5] == want[..., 5])
            & (np.abs(got[..., :4] - want[..., :4]).max(-1) <= 1e-3))
    np.testing.assert_array_equal(got_cls[same], want_cls[same])
    np.testing.assert_allclose(got[same][:, 7:], want[same][:, 7:], rtol=0,
                               atol=2e-2)
    assert report["gt"] == report_ref["gt"]
    tp = round(report["attr_recall"] * report["gt"])
    tp_ref = round(report_ref["attr_recall"] * report_ref["gt"])
    assert abs(tp - tp_ref) <= max(1, report["gt"] // 20), (report,
                                                            report_ref)
