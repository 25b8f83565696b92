"""The slice end to end: the detect step against
``evam_tpu.engine.steps.build_detect_step``, and the served path on the
CPU (StreamRunner → DetectStage → shared BatchEngine → metaconvert →
publish).

Tolerances:

* float32, ``quant=False``: valid masks equal, boxes and scores within
  1e-4;
* INT8 / bf16 with ``EVAM_QGEMM=pallas``: at least 95 % of the
  reference's detections are matched by a port detection of the same
  label with IoU ≥ 0.9 (top-k and NMS are discrete: a bf16 rounding at
  another place can reorder near-ties).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from evam_tpu.engine.steps import build_detect_step as jax_detect_step
from evam_tpu.models.registry import ModelRegistry as JaxRegistry
from evam_tpu.ops import qlinear as jql
from evam_tpu_torch.engine import batcher
from evam_tpu_torch.engine.batcher import BatchEngine
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.engine.steps import DETECT_FIELDS, build_detect_step
from evam_tpu_torch.media.source import SyntheticSource
from evam_tpu_torch.models.convert import params_from_jax
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.models.zoo.layers import quantize_model
from evam_tpu_torch.ops import qgemm as tqg
from evam_tpu_torch.ops import qlinear as tql
from evam_tpu_torch.ops.color import bgr_to_i420_host
from evam_tpu_torch.stages.infer import DetectStage
from evam_tpu_torch.stages.meta import MetaconvertStage, PublishStage
from evam_tpu_torch.stages.runner import StreamRunner

torch.set_num_threads(1)
KEY = "object_detection/person_vehicle_bike"
SMALL = dict(input_overrides={KEY: (64, 64)}, width_overrides={KEY: 8},
             allow_random_weights=True)
GOLDEN = Path(__file__).parent / "golden" / "message_eva_metadata.json"


def _i420_frames(n=4, seed=0):
    rng = np.random.default_rng(seed)
    bgr = rng.integers(0, 256, (n, 64, 64, 3), np.uint8)
    return np.stack([bgr_to_i420_host(f) for f in bgr])


def _models(dtype, precision):
    jm = JaxRegistry(dtype=dtype, precision=precision, **SMALL).get(KEY)
    tm = ModelRegistry(dtype=dtype, precision=precision, device="cpu",
                       **SMALL).get(KEY)
    tm.module.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jm.params)))
    quantize_model(tm.module)
    return jm, tm


def _both_steps(jm, tm, frames, **kw):
    ref = np.asarray(jax.jit(jax_detect_step(jm, wire_format="i420", **kw))(
        jm.params, frames))
    got = build_detect_step(tm, wire_format="i420", **kw)(
        torch.from_numpy(frames)).numpy()
    return ref, got


def _iou(a, b):
    lt = np.maximum(a[:2], b[:, :2])
    rb = np.minimum(a[2:4], b[:, 2:4])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
    area = lambda x: np.prod(np.clip(x[..., 2:4] - x[..., :2], 0, None), -1)
    return inter / np.maximum(area(a) + area(b) - inter, 1e-9)


def test_detect_step_float_matches_reference():
    jm, tm = _models("float32", "FP32")
    ref, got = _both_steps(jm, tm, _i420_frames(), score_threshold=0.1)
    assert got.shape == ref.shape == (4, 32, DETECT_FIELDS)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 6], ref[..., 6])
    assert ref[..., 6].sum() > 0
    np.testing.assert_allclose(got[..., :5], ref[..., :5], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[..., 5], ref[..., 5])


def test_detect_step_int8_pallas_matches_reference(monkeypatch):
    monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
    monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    jm, tm = _models("int8", "BF16")
    ref, got = _both_steps(jm, tm, _i420_frames(seed=1), score_threshold=0.1)
    matched = total = 0
    for r, g in zip(ref, got):
        g = g[g[:, 6] > 0.5]
        for row in r[r[:, 6] > 0.5]:
            total += 1
            same = g[g[:, 5] == row[5]]
            matched += bool(len(same) and (_iou(row, same) >= 0.9).any())
    assert total > 0
    assert matched / total >= 0.95, (matched, total)


def _serve(hub, streams=4, frames=12, publish=None):
    runners = []
    for s in range(streams):
        uri = f"synthetic://64x64@30?count={frames}&seed={s}"
        stages = [DetectStage("detect", KEY, {"threshold": 0.2}, hub),
                  MetaconvertStage("meta", source_uri=uri),
                  PublishStage("publish", publish)]
        runners.append((StreamRunner(f"s{s}", stages, uri),
                        SyntheticSource.from_uri(uri)))
    threads = [threading.Thread(target=r.run, args=(src.frames(),))
               for r, src in runners]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return [r for r, _ in runners]


@pytest.fixture
def hub(monkeypatch):
    monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    reg = ModelRegistry(dtype="int8", device="cpu", **SMALL)
    h = EngineHub(reg, device="cpu", max_batch=8, deadline_ms=30.0)
    yield h
    h.stop()


def test_served_path_publishes_every_frame_in_order(hub):
    published: dict[str, list] = {}
    lock = threading.Lock()

    def publish(ctx):
        with lock:
            published.setdefault(ctx.stream_id, []).append(
                (ctx.seq, ctx.metadata))

    runners = _serve(hub, publish=publish)
    assert all(r.errors == 0 for r in runners)
    for s in range(4):
        assert [seq for seq, _ in published[f"s{s}"]] == list(range(12))
    stats = hub.stats()[f"detect:{KEY}"]
    assert stats["items"] == 48
    assert max(int(b) for b in stats["bucket_batches"]) > 1
    assert stats["mean_occupancy"] > 0
    assert all(len(r.latencies) == 12 for r in runners)

    golden = json.loads(GOLDEN.read_text())
    metas = [m for v in published.values() for _, m in v]
    assert set(metas[0]) == set(golden)
    objects = [o for m in metas for o in m["objects"]]
    assert objects, "random weights at threshold 0.2 should detect something"
    for obj in objects:
        assert set(obj) == set(golden["objects"][0])
        assert set(obj["detection"]) == set(golden["objects"][0]["detection"])
        assert (set(obj["detection"]["bounding_box"])
                == set(golden["objects"][0]["detection"]["bounding_box"]))


def test_engine_results_equal_a_direct_step(hub):
    """Batched, padded and resolved through the engine, each frame's
    rows equal the step run on that frame alone (a frame's quantization
    never depends on what it was batched with)."""
    engine = hub.engine("detect", KEY, score_threshold=0.1)
    frames = _i420_frames(n=6, seed=3)
    futures = [engine.submit(frames=f) for f in frames]
    got = [f.result(timeout=60) for f in futures]
    step = engine.step_fn
    for f, g in zip(frames, got):
        direct = step(torch.from_numpy(f[None])).numpy()[0]
        np.testing.assert_array_equal(g, direct)
    assert tqg.launches == 0  # the CPU path never launches the kernel


def test_engine_counts_a_batch_before_its_futures_resolve(monkeypatch):
    """A caller that has every result also sees every batch counted, so
    launches per forward can be read right after the streams finish.
    (The completer is slowed after each resolution to widen the window a
    late count would leave open.)"""
    resolve = batcher._safe_set_result

    def slow_resolve(fut, value):
        resolve(fut, value)
        time.sleep(0.01)

    monkeypatch.setattr(batcher, "_safe_set_result", slow_resolve)
    engine = BatchEngine("double", lambda x: x * 2, device="cpu",
                         max_batch=4, deadline_ms=0.0)
    try:
        for i in range(20):
            row = engine.submit(frames=np.full((3,), i, np.int32)).result(timeout=10)
            np.testing.assert_array_equal(row, np.full((3,), 2 * i))
            stats = engine.stats_row()
            assert (stats["batches"], stats["items"]) == (i + 1, i + 1)
    finally:
        engine.stop()


def test_engine_rejects_unknown_inputs_and_fails_after_stop(hub):
    engine = hub.engine("detect", KEY)
    with pytest.raises(ValueError):
        engine.submit(pixels=np.zeros((96, 64), np.uint8))
    hub.stop()
    with pytest.raises(RuntimeError):
        engine.submit(frames=np.zeros((96, 64), np.uint8))


def test_step_errors_reach_every_future(hub):
    engine = hub.engine("detect", KEY)
    bad = [engine.submit(frames=np.zeros((10, 64), np.uint8)) for _ in range(2)]
    for f in bad:
        with pytest.raises(Exception):
            f.result(timeout=60)


def test_hub_shares_engines_and_refuses_later_kinds(hub):
    a = hub.engine("detect", KEY)
    assert hub.engine("detect", KEY) is a
    assert hub.engine("detect", KEY, instance_id="other") is not a
    with pytest.raises(NotImplementedError, match="slice 5"):
        hub.engine("action_encode", KEY)


def test_interval_skip_reuses_last_regions(hub):
    stage = DetectStage("detect", KEY, {"threshold": 0.2,
                                        "inference-interval": 2}, hub)
    seen = []
    runner = StreamRunner("s", [stage, MetaconvertStage("m"),
                                PublishStage("p", seen.append)])
    runner.run(SyntheticSource(64, 64, count=4).frames())
    assert [c.seq for c in seen] == [0, 1, 2, 3]
    assert seen[0].regions and seen[1].metadata["objects"] == \
        seen[0].metadata["objects"]
    assert hub.stats()[f"detect:{KEY}"]["items"] == 2
