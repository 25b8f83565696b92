"""The serving chain's ground-truth helpers and paths
(``evam_tpu_torch/models/accuracy.py``'s ``render_crossing_frames``,
``holdout_scenes``, ``recovered``, ``LABEL_IDS``) against the reference
test's (``tests/test_accuracy.py``), on the CPU.

The chain is held to ground truth only on the card (``chip_smoke.py``'s
``accuracy`` phase, rows ``accuracy-track``, ``accuracy-zone`` and
``accuracy-eii``: the reference test's limits on a converged fit). Here:

* the crossing frames (``TestTrackingAccuracy._moving_vehicle_frames``)
  and the held-out scenes (``_holdout_scenes``, seeds 99, 123 and 321)
  equal the reference test's bit for bit; ``recovered`` and
  ``LABEL_IDS`` equal its ``_recovered`` and ``LABEL_IDS``;
* a 40-step port fit (SSD 64², width 8), written by ``save_fitted`` and
  loaded by both registries, served through both packages' chains
  (``PipelineLoader`` → ``resolve_parameters`` → ``build_stages`` →
  ``StreamRunner``, hubs of ``max_batch`` 16 and a 4 ms deadline, as the
  reference test's): ``object_tracking/object_line_crossing`` on the
  crossing frames (threshold 0.3, a midline at x = 0.5) and
  ``object_detection/object_zone_count`` on seed 321's scenes (a
  left-half zone) publish the same ids, the same event frames, the same
  zone counts, and boxes and confidences within 1e-5 (float32);
* the port's EII ``gva_meta`` rects of that model's detections on seed
  123's scenes equal the reference publisher's conversion
  (``evam_tpu/eii/manager.py::_gva_meta``) of the same normalized boxes,
  and read the same ground truth by the reference test's rule.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from evam_tpu.eii.manager import _gva_meta as jax_gva_meta
from evam_tpu.engine import EngineHub as JaxHub
from evam_tpu.graph import PipelineLoader as JaxLoader
from evam_tpu.graph import resolve_parameters as jresolve
from evam_tpu.media.source import FrameEvent as JaxFrameEvent
from evam_tpu.models.registry import ModelRegistry as JaxRegistry
from evam_tpu.stages import StreamRunner as JaxRunner
from evam_tpu.stages import build_stages as jbuild
from evam_tpu.stages import context as jctx
from evam_tpu_torch.eii.manager import _gva_meta
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.graph import PipelineLoader, resolve_parameters
from evam_tpu_torch.media.source import FrameEvent
from evam_tpu_torch.models import accuracy as acc
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.stages.build import build_stages
from evam_tpu_torch.stages.runner import StreamRunner
import test_accuracy as ref_tests  # the reference test's helpers
from test_torch_server import REPO, native_reference  # noqa: F401 — fixture

torch.set_num_threads(1)
KEY = "object_detection/person_vehicle_bike"
SMALL = dict(input_overrides={KEY: (64, 64)}, width_overrides={KEY: 8})
ATOL = 1e-5
#: the reference test's chain parameters (tests/test_accuracy.py:600-605,
#: :843-849)
LINE = {"threshold": 0.3, "object-line-crossing-config": {"lines": [{
    "name": "midline", "line": [[0.5, 0.0], [0.5, 1.0]]}]}}
ZONE = {"threshold": 0.3, "object-zone-count-config": {"zones": [{
    "name": "left-half",
    "polygon": [[0.0, 0.0], [0.5, 0.0], [0.5, 1.0], [0.0, 1.0]]}]}}


# ------------------------------------------------------------ helpers


@pytest.mark.parametrize("n,hw", [(14, (1080, 1920)), (6, (96, 160))],
                         ids=str)
def test_crossing_frames_equal_the_reference_tests(n, hw):
    frames, boxes = acc.render_crossing_frames(n, hw)
    want_f, want_b = ref_tests.TestTrackingAccuracy._moving_vehicle_frames(
        n, hw)
    assert len(frames) == len(want_f) == n
    for a, b in zip(frames, want_f):
        assert a.dtype == b.dtype == np.uint8 and a.shape == hw + (3,)
        np.testing.assert_array_equal(a, b)
    assert boxes == want_b
    # the footfall anchor crosses the midline once, mid-sequence
    anchors = [(b[0] + b[2]) / 2.0 for b in boxes]
    assert sum(a < 0.5 <= b for a, b in zip(anchors, anchors[1:])) == 1


@pytest.mark.parametrize("n,seed", [(8, 99), (6, 123), (8, 321)])
def test_holdout_scenes_equal_the_reference_tests(n, seed):
    got = acc.holdout_scenes(n, seed=seed)
    want = ref_tests._holdout_scenes(n, seed=seed)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        for field in ("frame", "boxes", "labels", "attrs"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("seed", [0, 4, 9])
def test_recovered_equals_the_reference_tests(seed):
    assert acc.LABEL_IDS == ref_tests.LABEL_IDS
    rng = np.random.default_rng(seed)
    scenes = acc.holdout_scenes(6, hw=(64, 96), seed=seed)
    counts = []
    for scene in scenes:
        dets = []
        for box, label in zip(scene.boxes, scene.labels):
            for _ in range(2):
                x0, y0, x1, y1 = box + rng.normal(0, 0.05, 4)
                lid = int(label) if rng.uniform() < 0.8 else -1
                dets.append((x0, y0, x1, y1, lid))
        for iou in (0.5, 0.3):
            got = acc.recovered(dets, scene, iou=iou)
            assert got == ref_tests._recovered(dets, scene, iou=iou)
            counts.append(got)
    # not a trivial rule here: boxes found and boxes missed
    assert sum(h for h, _ in counts) > 0
    assert any(h < n for h, n in counts)


# ------------------------------------------- fitted, served by both chains


@pytest.fixture(scope="module")
def fitted_dir(tmp_path_factory):
    """A 40-step port fit at 64², width 8, written by ``save_fitted``."""
    tm = ModelRegistry(dtype="float32", device="cpu",
                       allow_random_weights=True, **SMALL).get(KEY)
    state, history = acc.fit_detector(tm, steps=40, n_scenes=16,
                                      device="cpu")
    assert all(np.isfinite(history)) and history[-1] < history[0]
    root = tmp_path_factory.mktemp("chain_fitted")
    acc.save_fitted(state, KEY, root)
    return root


def _chain(loader, resolve, build, runner_cls, hub, pipeline, params,
           events, keep=lambda ctx: ctx.metadata) -> list:
    spec = loader(REPO / "pipelines").get(*pipeline)
    stages, _ = resolve(spec, params)
    outputs = []
    runner = runner_cls("acc", build(stages, hub, source_uri="synthetic://acc",
                                     publish_fn=lambda c: outputs.append(
                                         keep(c))),
                        source_uri="synthetic://acc")
    runner.run(events)
    assert runner.errors == 0
    return outputs


def _serve_both(root, pipeline, params, frames):
    """``frames`` through the pipeline in both packages, on hubs of
    max_batch 16 and a 4 ms deadline over ``root``'s fitted weights →
    (reference lines, port lines)."""
    jreg = JaxRegistry(dtype="float32", models_dir=str(root), **SMALL)
    treg = ModelRegistry(dtype="float32", models_dir=root, device="cpu",
                         **SMALL)
    assert jreg.get(KEY).weight_source == "msgpack"
    assert treg.get(KEY).weight_source == "msgpack"
    jhub = JaxHub(jreg, max_batch=16, deadline_ms=4.0)
    thub = EngineHub(treg, device="cpu", max_batch=16, deadline_ms=4.0)

    def events(cls):
        return (cls(frame=f, pts_ns=i * 33_000_000, seq=i)
                for i, f in enumerate(frames))
    try:
        want = _chain(JaxLoader, jresolve, jbuild, JaxRunner, jhub, pipeline,
                      params, events(JaxFrameEvent))
        got = _chain(PipelineLoader, resolve_parameters, build_stages,
                     StreamRunner, thub, pipeline, params, events(FrameEvent))
    finally:
        jhub.stop()
        thub.stop()
    assert len(got) == len(want) == len(frames)
    return want, got


def _assert_same(want, got, path="$") -> None:
    """Equal JSON, numbers within ATOL (ints, strings, keys, list
    lengths exactly)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_same(w, g, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (float, int)) and abs(got - want) <= ATOL, (
            path, got, want)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def _events(lines, kind: str) -> list[tuple[int, dict]]:
    return [(i, e) for i, m in enumerate(lines) for e in m.get("events", [])
            if e["event-type"] == kind]


@pytest.mark.usefixtures("native_reference")
def test_line_crossing_serves_alike_in_both_packages(fitted_dir):
    frames, _ = acc.render_crossing_frames()
    want, got = _serve_both(fitted_dir, ("object_tracking",
                                         "object_line_crossing"), LINE,
                            frames)
    _assert_same(want, got)
    ids = [[o.get("id") for o in m.get("objects", [])] for m in got]
    # a fit this short still finds objects, and the tracker names them
    assert sum(map(len, ids)) > 0 and any(i is not None for f in ids
                                          for i in f)
    assert ([i for i, _ in _events(got, "object-line-crossing")]
            == [i for i, _ in _events(want, "object-line-crossing")])


@pytest.mark.usefixtures("native_reference")
def test_zone_count_serves_alike_in_both_packages(fitted_dir):
    scenes = acc.holdout_scenes(8, seed=321)
    want, got = _serve_both(fitted_dir, ("object_detection",
                                         "object_zone_count"), ZONE,
                            [s.frame for s in scenes])
    _assert_same(want, got)
    counts = [[e["zone-count"] for _, e in _events([m], "zone-count")]
              for m in got]
    assert counts == [[e["zone-count"] for _, e in _events([m], "zone-count")]
                      for m in want]
    assert any(counts)


def _reference_ctx(ctx):
    """The reference's FrameContext of ``ctx``'s frame and regions."""
    def copy(obj, cls, **kw):
        return cls(**{**{f.name: getattr(obj, f.name)
                         for f in dataclasses.fields(cls)}, **kw})
    regions = [copy(r, jctx.Region, tensors=[copy(t, jctx.Tensor)
                                             for t in r.tensors])
               for r in ctx.regions]
    return jctx.FrameContext(frame=ctx.frame, pts_ns=ctx.pts_ns, seq=ctx.seq,
                             stream_id=ctx.stream_id, regions=regions)


@pytest.mark.usefixtures("native_reference")
def test_eii_gva_meta_equals_the_reference_publishers(fitted_dir):
    scenes = acc.holdout_scenes(6, seed=123)
    treg = ModelRegistry(dtype="float32", models_dir=fitted_dir,
                         device="cpu", **SMALL)
    hub = EngineHub(treg, device="cpu", max_batch=8, deadline_ms=4.0)
    try:
        ctxs = _chain(PipelineLoader, resolve_parameters, build_stages,
                      StreamRunner, hub,
                      ("object_detection", "person_vehicle_bike"),
                      {"threshold": 0.3},
                      (FrameEvent(frame=s.frame, pts_ns=i * 33_000_000,
                                  seq=i) for i, s in enumerate(scenes)),
                      keep=lambda ctx: ctx)
    finally:
        hub.stop()
    assert len(ctxs) == len(scenes)
    n_regions = 0
    for ctx, scene in zip(ctxs, scenes):
        got, want = _gva_meta(ctx), jax_gva_meta(_reference_ctx(ctx))
        assert got == want
        n_regions += len(got)
        # the reference test's reading of the rects
        dets = [(g["x"] / 1920.0, g["y"] / 1080.0,
                 (g["x"] + g["width"]) / 1920.0,
                 (g["y"] + g["height"]) / 1080.0,
                 acc.LABEL_IDS.get(g["tensor"][0]["label"], -1))
                for g in got]
        assert acc.recovered(dets, scene) == ref_tests._recovered(dets, scene)
    assert n_regions > 0
