"""Port ops (evam_tpu_torch.ops) against the reference ops (evam_tpu.ops).

Same inputs, made with seeded numpy, through both. Tolerances:

* resize: near-exact at float32 compute (atol 1e-3 on the 0-255
  scale) and atol 2.0 at bf16, the pin of the reference's own docstring
  (``evam_tpu/ops/resize.py::resize_planes``);
* i420 → model input: atol 1e-3 — both sides round the same float32
  values to bf16;
* the numpy I420 encoder: at most 2 levels from cv2;
* the host resize + wire encode of a detect stage: equal, byte for
  byte, to the reference's native kernels (its default host path);
* anchors equal; ``decode_boxes`` rtol 1e-6 (``exp`` may differ in the
  last bit);
* NMS: equal outputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evam_tpu import native
from evam_tpu.ops import boxes as jboxes
from evam_tpu.ops import color as jcolor
from evam_tpu.ops import nms as jnms
from evam_tpu.ops import preprocess as jprep
from evam_tpu.ops import resize as jresize
from evam_tpu_torch.ops import boxes as tboxes
from evam_tpu_torch.ops import color as tcolor
from evam_tpu_torch.ops import nms as tnms
from evam_tpu_torch.ops import preprocess as tprep
from evam_tpu_torch.ops import resize as tresize
from evam_tpu_torch.stages.infer import _wire_frame, resize_bgr_host

torch.set_num_threads(1)


@pytest.mark.parametrize("out_hw", [(41, 53), (128, 96)])
@pytest.mark.parametrize("dtypes,atol", [
    ((jnp.float32, torch.float32), 1e-3),
    ((jnp.bfloat16, torch.bfloat16), 2.0),
])
def test_resize_planes(out_hw, dtypes, atol):
    x = np.random.default_rng(0).integers(0, 256, (3, 90, 70), np.uint8)
    ref = np.asarray(jresize.resize_planes(jnp.asarray(x), out_hw, dtypes[0]))
    got = tresize.resize_planes(torch.from_numpy(x), out_hw, dtypes[1]).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_resize_matrix_is_the_reference_matrix():
    for n_in, n_out in [(90, 41), (41, 90), (512, 512)]:
        np.testing.assert_array_equal(tresize.resize_matrix(n_in, n_out),
                                      jresize.resize_matrix(n_in, n_out))


@pytest.mark.parametrize("hw", [(64, 64), (40, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("color", ["BGR", "RGB"])
def test_i420_to_model_input(hw, dtype, color):
    frames = np.random.default_rng(1).integers(0, 256, (2, 96, 64), np.uint8)
    kw = dict(color_space=color, dtype=dtype, wire_format="i420")
    ref = jprep.preprocess_wire(jnp.asarray(frames),
                                jprep.PreprocessSpec(*hw, **kw))
    got = tprep.preprocess_wire(torch.from_numpy(frames),
                                tprep.PreprocessSpec(*hw, **kw))
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=1e-3)


def test_bgr_wire_with_mean_std_and_stretch():
    frames = np.random.default_rng(2).integers(0, 256, (2, 50, 30, 3), np.uint8)
    kw = dict(color_space="RGB", dtype="float32", raw_range=False,
              mean=(0.5, 0.4, 0.3), std=(0.2, 0.25, 0.3), wire_format="bgr")
    ref = jprep.preprocess_wire(jnp.asarray(frames),
                                jprep.PreprocessSpec(32, 24, **kw))
    got = tprep.preprocess_wire(torch.from_numpy(frames),
                                tprep.PreprocessSpec(32, 24, **kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-2)


def test_wire_shapes_match_the_reference():
    for fmt, h, w in [("i420", 512, 512), ("i420", 432, 768), ("bgr", 30, 40)]:
        assert tcolor.wire_shape(fmt, h, w) == jcolor.wire_shape(fmt, h, w)
    with pytest.raises(ValueError):
        tcolor.i420_shape(430, 768)


def test_numpy_i420_encoder_matches_cv2():
    """The port's host encoder against the reference's cv2 call: the
    fixed-point matrices round differently, by at most 2 levels."""
    bgr = np.random.default_rng(3).integers(0, 256, (48, 64, 3), np.uint8)
    bgr[:16, :16] = (64, 160, 240)
    ref = jcolor.bgr_to_i420_host(bgr).astype(np.int32)
    got = tcolor.bgr_to_i420_host(bgr).astype(np.int32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 2


def test_host_resize_matches_cv2():
    import cv2

    bgr = np.random.default_rng(4).integers(0, 256, (48, 64, 3), np.uint8)
    for h, w in [(30, 50), (100, 130), (48, 64)]:
        ref = cv2.resize(bgr, (w, h), interpolation=cv2.INTER_LINEAR)
        got = resize_bgr_host(bgr, h, w)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("src_hw", [(80, 128), (96, 96), (33, 47), (480, 640)])
def test_host_wire_frames_equal_the_references_native_kernels(src_hw, monkeypatch):
    """The stage's host resize + encode equals the reference's
    ``native.resize_bgr_to_i420`` (i420 wire) and ``native.resize_bgr``
    (bgr wire) byte for byte, at square and non-square ingest sizes."""
    if not native.available():
        assert native.build(quiet=True), "native build failed"
    monkeypatch.setenv("EVAM_NATIVE", "1")  # the native path on any host
    bgr = np.random.default_rng(src_hw[0]).integers(
        0, 256, (*src_hw, 3), np.uint8)
    same = (src_hw[0] - src_hw[0] % 4, src_hw[1] - src_hw[1] % 2)  # I420-legal
    for h, w in [(64, 96), (64, 64), (320, 544), (12, 10), same]:
        np.testing.assert_array_equal(
            _wire_frame(bgr, (h, w), "i420"),
            native.resize_bgr_to_i420(bgr, h, w))
        if (h, w) != src_hw:  # the reference resizes only a frame that differs
            np.testing.assert_array_equal(
                _wire_frame(bgr, (h, w), "bgr"), native.resize_bgr(bgr, h, w))


def test_anchors_equal():
    shapes = [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4)]
    got = tboxes.generate_anchors(shapes)
    np.testing.assert_array_equal(got, jboxes.generate_anchors(shapes))
    assert got.shape == (21824, 4)  # the SSD-512 anchor table
    assert tboxes.anchors_per_cell() == jboxes.anchors_per_cell()


def test_decode_boxes():
    rng = np.random.default_rng(5)
    anchors = jboxes.generate_anchors([(4, 4), (2, 2)])
    deltas = rng.normal(size=(3, len(anchors), 4)).astype(np.float32) * 3
    ref = np.asarray(jboxes.decode_boxes(jnp.asarray(deltas),
                                         jnp.asarray(anchors)))
    got = tboxes.decode_boxes(torch.from_numpy(deltas),
                              torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_iou_matrix():
    rng = np.random.default_rng(6)
    a = np.sort(rng.uniform(size=(7, 2, 2)), axis=1).transpose(0, 2, 1).reshape(7, 4)
    b = np.sort(rng.uniform(size=(5, 2, 2)), axis=1).transpose(0, 2, 1).reshape(5, 4)
    a, b = a.astype(np.float32), b.astype(np.float32)
    ref = np.asarray(jboxes.iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tboxes.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- NMS


def _nms_both(boxes, scores, labels, k, score_threshold=0.0):
    ref = jnms.nms_single(jnp.asarray(boxes), jnp.asarray(scores),
                          jnp.asarray(labels), k, 0.45, score_threshold)
    got = tnms.nms_single(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(labels), k, 0.45, score_threshold)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_nms_equal(ref, got):
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def _disjoint_boxes(n):
    x = np.arange(n, dtype=np.float32) * 0.1
    return np.stack([x, x * 0, x + 0.05, x * 0 + 0.05], 1).astype(np.float32)


def test_nms_tied_scores_select_the_lower_index_first():
    boxes = _disjoint_boxes(5)
    scores = np.asarray([1, 3, 3, 2, 3], np.float32) / 4
    labels = np.ones(5, np.int32)
    ref, got = _nms_both(boxes, scores, labels, 3)
    _assert_nms_equal(ref, got)
    np.testing.assert_array_equal(got[0], boxes[[1, 2, 4]])


def _chain(n=12):
    """Boxes where each overlaps the next (IoU 0.54) but not the one
    after (IoU 0.25): sequential NMS keeps every other box, and settling
    needs n - 1 Jacobi steps."""
    x = np.arange(n, dtype=np.float32) * 0.03
    boxes = np.stack([x, np.zeros(n), x + 0.1, np.full(n, 0.1)], 1)
    scores = np.linspace(0.9, 0.5, n).astype(np.float32)
    return boxes.astype(np.float32), scores, np.ones(n, np.int32)


@pytest.mark.parametrize("mode", ["while", "unroll"])
def test_nms_deep_suppression_chain(monkeypatch, mode):
    monkeypatch.setattr(jnms, "SETTLE", mode)
    monkeypatch.setattr(tnms, "SETTLE", mode)
    assert tnms.UNROLL_ITERS == jnms.UNROLL_ITERS == 8
    ref, got = _nms_both(*_chain(), 12)
    _assert_nms_equal(ref, got)


def test_nms_modes_differ_on_a_deep_chain(monkeypatch):
    kept = {}
    for mode in ("while", "unroll"):
        monkeypatch.setattr(tnms, "SETTLE", mode)
        b, s, lb = _chain()
        kept[mode] = tnms.nms_single(torch.from_numpy(b), torch.from_numpy(s),
                                     torch.from_numpy(lb), 12)[3].sum().item()
    assert kept["while"] == 6 and kept["unroll"] != kept["while"]


def test_nms_all_scores_below_threshold():
    boxes = _disjoint_boxes(6)
    scores = np.full(6, 0.2, np.float32)
    ref, got = _nms_both(boxes, scores, np.ones(6, np.int32), 4,
                         score_threshold=0.3)
    _assert_nms_equal(ref, got)
    assert not got[3].any() and (got[2] == -1).all()


def test_nms_k_larger_than_n_pads():
    boxes = _disjoint_boxes(5)
    scores = np.asarray([0.5, 0.9, 0.7, 0.6, 0.8], np.float32)
    ref, got = _nms_both(boxes, scores, np.arange(5, dtype=np.int32), 8)
    _assert_nms_equal(ref, got)
    assert got[0].shape == (8, 4) and got[3].sum() == 5


def test_batched_nms_class_aware():
    rng = np.random.default_rng(7)
    b, a, c = 3, 60, 4
    centers = rng.uniform(0.1, 0.9, size=(b, a, 2))
    size = rng.uniform(0.05, 0.3, size=(b, a, 2))
    boxes = np.concatenate([centers - size / 2, centers + size / 2], -1)
    boxes = np.clip(boxes, 0, 1).astype(np.float32)
    scores = rng.dirichlet(np.ones(c), size=(b, a)).astype(np.float32)
    ref = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), 16, 0.45, 0.3)
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           16, 0.45, 0.3)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
