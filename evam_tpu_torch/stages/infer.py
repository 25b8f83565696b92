"""Engine-backed inference stages (counterpart of ``evam_tpu/stages/infer.py``).

``DetectStage`` is the gvadetect counterpart: it encodes each frame to
the engine's wire format on the stream's thread, submits it to the
shared detect engine, and turns the packed result rows into regions.
``ClassifyStage`` (gvaclassify) submits the frame with the boxes of its
eligible regions (on a packed engine, ``EVAM_RAGGED=packed``, exactly
those rows; otherwise padded to the ROI budget) and appends one
attribute tensor per head to each;
``FusedDetectClassifyStage`` does both in one engine round trip.
``ActionStage`` (gvaactionrecognitionbin) chains a per-frame encoder
engine and a 16-frame-clip decoder engine; ``AudioDetectStage``
(gvaaudiodetect) classifies one-second windows of the audio stream.
Thresholds are applied here, on the host, so one engine (whose NMS uses
the permissive ``ENGINE_SCORE_FLOOR``) serves pipelines with different
``threshold`` parameters. Every submit carries the frame's
``priority`` (the stream's QoS class).

A frame skipped by a static ``inference-interval`` gets fresh copies of
the last inferred regions (``stages/track.py`` ``RegionCoaster``), so a
later stage that appends to a region touches only that frame's. With
``inference-interval=adaptive`` or ``EVAM_GATE=on`` a detect stage (or
a fused one) owns a motion gate (``stages/gate.py``) in place of the
static interval: the gate scores the host frame at submit time, a
skipped frame never reaches the engine, and its ``complete`` coasts the
last detections forward by the number of skips the gate had counted at
that frame's submit (kept in ``ctx.scratch["gate_coast"]``: frames in
flight would read a later count off the gate). The gate's decision is a
``gate.decide`` span on the frame's trace, and every submit carries the
frame's trace handle (the batch it lands in links back to it). With
EVAM_CKPT on, the detect-class stages' ``snapshot``/``restore`` carry
the interval counter, the coaster's regions and velocities and the
gate's state through a stream checkpoint.

On a hub with ``device_synth`` the video stages submit wire ``"seed"``:
one distinct uint32 a frame (``_SYNTH_SEQ``), from which the engine
makes the wire frame on the device; the gate still reads the host
frame.
"""

from __future__ import annotations

import itertools
import logging
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from evam_tpu_torch import native
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.models.zoo.action import CLIP_LEN
from evam_tpu_torch.ops.color import (  # noqa: F401 — re-exported
    resize_bgr_host,
    wire_shape,
)
from evam_tpu_torch.stages.base import AsyncStage
from evam_tpu_torch.stages.context import FrameContext, Region, Tensor
from evam_tpu_torch.stages.gate import maybe_gate
from evam_tpu_torch.stages.track import RegionCoaster

log = logging.getLogger("evam_tpu_torch.stages.infer")

#: floor baked into the shared engine's NMS; per-stage thresholds
#: filter above this
ENGINE_SCORE_FLOOR = 0.1


def _wire_safe_size(size: tuple[int, int]) -> tuple[int, int]:
    """Round an ingest (H, W) up to the I420 constraint (height%4, width%2)."""
    h, w = int(size[0]), int(size[1])
    return (-(-h // 4) * 4, -(-w // 2) * 2)


#: the process's frame-seed sequence for device_synth (the interpreter
#: lock makes itertools.count().__next__ atomic: every seed distinct
#: until it wraps at 2³²)
_SYNTH_SEQ = itertools.count()


def _wire_frame(frame: np.ndarray, size: tuple[int, int],
                wire_format: str) -> np.ndarray:
    """Resize to the engine's ingest size and encode to its wire format:
    one fused pass in the native library, or the numpy copies of its
    arithmetic, as ``native.py``'s policy says (the same bytes). Wire
    ``"seed"`` (``EngineHub.device_synth``): the engine makes the pixels
    on the device, so the stage submits only the frame's uint32 seed."""
    if wire_format == "seed":
        return np.uint32(next(_SYNTH_SEQ) & 0xFFFFFFFF)
    if wire_format == "i420":
        return native.resize_bgr_to_i420(frame, size[0], size[1])
    if frame.shape[:2] != tuple(size):
        frame = native.resize_bgr(frame, size[0], size[1])
    return np.ascontiguousarray(frame)


def _warm(hub: EngineHub, engine, **example: np.ndarray) -> None:
    """Warm the engine's buckets in the background when the hub serves
    with warmup on; record the example on the engine either way, so a
    supervisor rebuild re-warms the replacement from it."""
    if hub.warmup:
        engine.warm_async(**example)
    else:
        engine.set_example(**example)


def _warm_engine(hub: EngineHub, engine, ingest_size, wire_format,
                 **extra_example) -> None:
    """``_warm`` with a zero frame of the engine's wire shape (seed 0
    for wire ``"seed"``)."""
    if wire_format == "seed":
        frame = np.uint32(0)
    else:
        frame = np.zeros(wire_shape(wire_format, *ingest_size), np.uint8)
    _warm(hub, engine, frames=frame, **extra_example)


def _parse_interval(properties: dict) -> int:
    """``inference-interval``: a positive int, or ``"adaptive"`` — the
    gate's schedule, under which the static interval collapses to 1."""
    iv = properties.get("inference-interval", 1)
    if isinstance(iv, str) and iv.strip().lower() == "adaptive":
        return 1
    return max(1, int(iv))


def _timed_gate_decide(gate, ctx: FrameContext) -> bool:
    """The motion gate's decision, as a ``gate.decide`` span on the
    frame's trace (the verdict rides as an attr, so a skipped frame's
    tree explains itself)."""
    if ctx.trace is None:
        return gate.decide(ctx.frame)
    t_g = time.perf_counter()
    go = gate.decide(ctx.frame)
    ctx.trace.add_span("gate.decide", t_g, time.perf_counter() - t_g,
                       {"go": bool(go)})
    return go


def _detect_state_snapshot(stage) -> dict | None:
    """``snapshot()`` of the detect-class stages (DetectStage,
    FusedDetectClassifyStage): the interval counter, the coaster's
    regions and velocities and the gate's state. None with EVAM_CKPT
    off (the base class's answer)."""
    from evam_tpu_torch import state as stream_state

    if stream_state.active() is None:
        return None
    out: dict = {
        "count": int(stage._count),
        "coaster": stage._coaster.state_dict(),
    }
    if stage.gate is not None:
        out["gate"] = stage.gate.state_dict()
    return out


def _detect_state_restore(stage, state: dict) -> None:
    """Re-apply a ``_detect_state_snapshot`` on a fresh stage. A
    ``stale`` marker (``StreamInstance.restore_checkpoint`` prunes a
    checkpoint older than the gate's max-skip bound to it) drops the
    detections and the gate's anchor and forces a refresh; the track
    stage's identities survive regardless."""
    stage._count = int(state.get("count", 0))
    if state.get("stale"):
        if stage.gate is not None:
            stage.gate.force_refresh()
        return
    if state.get("coaster"):
        stage._coaster.load_state(state["coaster"])
    if stage.gate is not None and state.get("gate"):
        stage.gate.load_state(state["gate"])


def _skip(stage, ctx: FrameContext) -> bool:
    """The detect stages' skip rule at submit: the motion gate where
    the stage has one (recording how far a skipped frame coasts), else
    the static interval."""
    stage._count += 1
    if stage.gate is not None:
        if ctx.frame is not None and not _timed_gate_decide(stage.gate, ctx):
            ctx.scratch["gate_coast"] = stage.gate.consecutive_skips
            return True
        return False
    return bool((stage._count - 1) % stage.interval)


def _skipped_regions(stage, ctx: FrameContext) -> list[FrameContext]:
    """Complete a skipped frame: copies of the last detections, coasted
    by the gate's count at this frame's submit (0 for an interval
    skip)."""
    ctx.regions.extend(stage._coaster.coast(ctx.scratch.pop("gate_coast", 0)))
    return [ctx]


class DetectStage(AsyncStage):
    """gvadetect counterpart. Properties: threshold, inference-interval,
    model-instance-id, and the gate's (``stages/gate.py``)."""

    def __init__(self, name: str, model_key: str, properties: dict,
                 hub: EngineHub):
        self.name = name
        self.model_key = model_key
        self.threshold = float(properties.get("threshold", 0.5))
        if self.threshold < ENGINE_SCORE_FLOOR:
            log.warning(
                "detect stage %s threshold %.3f below shared-engine floor "
                "%.2f; effective threshold is %.2f",
                name, self.threshold, ENGINE_SCORE_FLOOR, ENGINE_SCORE_FLOOR)
        self.interval = _parse_interval(properties)
        self.model = hub.model(model_key)
        self.wire = "seed" if hub.device_synth else hub.wire_format
        self.ingest_size = _wire_safe_size(
            (self.model.preprocess.height, self.model.preprocess.width))
        self.engine = hub.engine(
            "detect", model_key, properties.get("model-instance-id"),
            score_threshold=ENGINE_SCORE_FLOOR,
            synth_wire_hw=self.ingest_size)
        _warm_engine(hub, self.engine, self.ingest_size, self.wire)
        #: None unless inference-interval=adaptive or EVAM_GATE=on
        self.gate = maybe_gate(properties, engine_name=self.engine.name)
        self._coaster = RegionCoaster()
        self._count = 0

    def submit(self, ctx: FrameContext) -> Future | None:
        if _skip(self, ctx):
            return None
        return self.engine.submit(
            priority=ctx.priority,
            stream=ctx.stream_id,
            trace=ctx.trace,
            frames=_wire_frame(ctx.frame, self.ingest_size, self.wire))

    def complete(self, ctx: FrameContext,
                 result: np.ndarray | None) -> list[FrameContext]:
        if result is None:
            return _skipped_regions(self, ctx)
        regions = [_region(row, self.model.labels) for row in result
                   if row[6] >= 0.5 and row[4] >= self.threshold]
        self._coaster.observe(regions)
        ctx.regions.extend(regions)
        return [ctx]

    def snapshot(self) -> dict | None:
        return _detect_state_snapshot(self)

    def restore(self, state: dict) -> None:
        _detect_state_restore(self, state)


def _region(row: np.ndarray, labels: list[str]) -> Region:
    """A packed detection row [x0, y0, x1, y1, score, label, valid, ...]
    → a Region carrying its detection tensor."""
    x0, y0, x1, y1, score, label_id = row[:6]
    lid = int(label_id)
    label = labels[lid] if 0 <= lid < len(labels) else str(lid)
    region = Region(
        x0=float(x0), y0=float(y0), x1=float(x1), y1=float(y1),
        confidence=float(score), label_id=lid, label=label,
    )
    region.tensors.append(Tensor(
        name="detection", confidence=float(score), label_id=lid,
        label=label, is_detection=True))
    return region


def _head_slices(model, offset: int = 0) -> list[tuple[str, int, int]]:
    """(head, start, end) of each head's block in a packed result row
    whose probability blocks start at ``offset``."""
    out = []
    for head_name, n in model.spec.heads:
        out.append((head_name, offset, offset + n))
        offset += n
    return out


def _append_attributes(region: Region, row: np.ndarray, heads, model,
                       threshold: float) -> None:
    """One tensor per head (argmax label, its probability) onto the
    region, where that probability reaches ``threshold``."""
    for head_name, a, b in heads:
        probs = row[a:b]
        hid = int(np.argmax(probs))
        conf = float(probs[hid])
        if conf < threshold:
            continue
        label_list = model.head_labels.get(head_name, [])
        region.tensors.append(Tensor(
            name=head_name, confidence=conf, label_id=hid,
            label=label_list[hid] if hid < len(label_list) else str(hid)))


class ClassifyStage(AsyncStage):
    """gvaclassify counterpart. Properties: object-class,
    reclassify-interval, threshold, model-instance-id, ingest-size."""

    ROI_BUDGET = 8

    def __init__(self, name: str, model_key: str, properties: dict,
                 hub: EngineHub):
        self.name = name
        self.model_key = model_key
        self.object_class = properties.get("object-class")
        self.interval = max(1, int(properties.get("reclassify-interval", 1)))
        self.threshold = float(properties.get("threshold", 0.0))
        self.wire = "seed" if hub.device_synth else hub.wire_format
        self.model = hub.model(model_key)
        # crops are taken on the device from the submitted frame: one
        # ingest size keeps cross-stream batches stackable while
        # keeping enough pixels for small ROIs
        self.ingest_size = _wire_safe_size(
            tuple(properties.get("ingest-size", (432, 768))))
        self.engine = hub.engine(
            "classify", model_key, properties.get("model-instance-id"),
            roi_budget=self.ROI_BUDGET, synth_wire_hw=self.ingest_size)
        #: a packed engine takes each frame's real region rows, shape
        #: (k, 4), and packs them across the batch
        self._packed = self.engine.ragged == "packed"
        _warm_engine(hub, self.engine, self.ingest_size, self.wire,
                     boxes=np.zeros((self.ROI_BUDGET, 4), np.float32))
        self._heads = _head_slices(self.model)
        self._count = 0

    def _eligible(self, ctx: FrameContext) -> list[Region]:
        return [r for r in ctx.regions
                if self.object_class in (None, "", r.label)][:self.ROI_BUDGET]

    def submit(self, ctx: FrameContext) -> Future | None:
        self._count += 1
        if (self._count - 1) % self.interval:
            return None
        regions = self._eligible(ctx)
        if not regions:
            return None
        # packed: the frame's region rows; dense: the ROI-budget block
        rows = len(regions) if self._packed else self.ROI_BUDGET
        boxes = np.zeros((rows, 4), np.float32)
        for i, r in enumerate(regions):
            boxes[i] = [r.x0, r.y0, r.x1, r.y1]
        return self.engine.submit(
            priority=ctx.priority,
            units=len(regions),
            stream=ctx.stream_id,
            trace=ctx.trace,
            frames=_wire_frame(ctx.frame, self.ingest_size, self.wire),
            boxes=boxes)

    def complete(self, ctx: FrameContext,
                 result: np.ndarray | None) -> list[FrameContext]:
        if result is None:
            return [ctx]
        for i, region in enumerate(self._eligible(ctx)):
            _append_attributes(region, result[i], self._heads, self.model,
                               self.threshold)
        return [ctx]


class FusedDetectClassifyStage(AsyncStage):
    """Detect + classify in one engine round trip: one frame upload and
    one packed readback replace two of each. Built by the stage
    builder's fusion pass (``stages/build.py`` ``_fusable``) for a
    classify stage that follows detect; ``reclassify-interval`` > 1
    disables fusion. The ``object-class`` filter runs inside the step
    (rows of other classes are not eligible for the ROI budget); a row
    whose probability block is all zero was not classified. ROI crops
    come from the frame at the detector's ingest size, not the classify
    stage's."""

    ROI_BUDGET = 8

    def __init__(self, name: str, det_key: str, cls_key: str,
                 det_props: dict, cls_props: dict, hub: EngineHub):
        self.name = name
        self.det_threshold = float(det_props.get("threshold", 0.5))
        self.cls_threshold = float(cls_props.get("threshold", 0.0))
        self.object_class = cls_props.get("object-class")
        self.interval = _parse_interval(det_props)
        self.det_model = hub.model(det_key)
        allowed = None
        if self.object_class:
            allowed = tuple(i for i, lbl in enumerate(self.det_model.labels)
                            if lbl == self.object_class)
        self.wire = "seed" if hub.device_synth else hub.wire_format
        self.ingest_size = _wire_safe_size(
            (self.det_model.preprocess.height, self.det_model.preprocess.width))
        self.engine = hub.fused_engine(
            det_key, cls_key, det_props.get("model-instance-id"),
            roi_budget=self.ROI_BUDGET,
            score_threshold=ENGINE_SCORE_FLOOR,
            allowed_label_ids=allowed,
            synth_wire_hw=self.ingest_size)
        _warm_engine(hub, self.engine, self.ingest_size, self.wire)
        self.cls_model = hub.model(cls_key)
        self._heads = _head_slices(self.cls_model, offset=7)
        #: the detect properties drive the gate, as in DetectStage; a
        #: coasted region keeps its attribute tensors (shared payloads)
        self.gate = maybe_gate(det_props, engine_name=self.engine.name)
        self._coaster = RegionCoaster()
        self._count = 0

    def submit(self, ctx: FrameContext) -> Future | None:
        if _skip(self, ctx):
            return None
        return self.engine.submit(
            priority=ctx.priority,
            stream=ctx.stream_id,
            trace=ctx.trace,
            frames=_wire_frame(ctx.frame, self.ingest_size, self.wire))

    def complete(self, ctx: FrameContext,
                 result: np.ndarray | None) -> list[FrameContext]:
        if result is None:
            return _skipped_regions(self, ctx)
        regions = []
        for row in result:
            if row[6] < 0.5 or row[4] < self.det_threshold:
                continue
            region = _region(row, self.det_model.labels)
            # an all-zero block marks an unclassified row (a classified
            # block sums to the number of heads)
            if row[7:].sum() > 0.5:
                _append_attributes(region, row, self._heads, self.cls_model,
                                   self.cls_threshold)
            regions.append(region)
        self._coaster.observe(regions)
        ctx.regions.extend(regions)
        return [ctx]

    def snapshot(self) -> dict | None:
        return _detect_state_snapshot(self)

    def restore(self, state: dict) -> None:
        _detect_state_restore(self, state)


def _frame_tensor(name: str, probs: np.ndarray, labels: list[str],
                  threshold: float, data: bool = False) -> Tensor | None:
    """The argmax of a frame-level probability vector as a Tensor, or
    None below ``threshold``; ``data`` inlines the whole vector."""
    lid = int(np.argmax(probs))
    conf = float(probs[lid])
    if conf < threshold:
        return None
    return Tensor(name=name, confidence=conf, label_id=lid,
                  label=labels[lid] if lid < len(labels) else str(lid),
                  data=[float(x) for x in probs] if data else None)


class ActionStage(AsyncStage):
    """gvaactionrecognitionbin counterpart: per-frame encoder + 16-frame
    sliding-clip decoder (pipelines/action_recognition/general/
    pipeline.json). Properties: enc-model, dec-model, threshold,
    model-instance-id (the encoder's)."""

    def __init__(self, name: str, properties: dict, hub: EngineHub):
        self.name = name
        enc_key = properties.get("enc-model", "action_recognition/encoder")
        dec_key = properties.get("dec-model", "action_recognition/decoder")
        self.dec_model = hub.model(dec_key)
        self.enc_model = hub.model(enc_key)
        self.ingest_size = _wire_safe_size(
            (self.enc_model.preprocess.height, self.enc_model.preprocess.width))
        # two engines: the decoder submit runs on the encoder engine's
        # completer thread, never on the engine it waits for
        self.enc_engine = hub.engine("action_encode", enc_key,
                                     properties.get("model-instance-id"),
                                     synth_wire_hw=self.ingest_size)
        self.dec_engine = hub.engine("action_decode", dec_key)
        self.clip: deque[np.ndarray] = deque(maxlen=CLIP_LEN)
        self.threshold = float(properties.get("threshold", 0.0))
        self.wire = "seed" if hub.device_synth else hub.wire_format
        _warm_engine(hub, self.enc_engine, self.ingest_size, self.wire)
        embed_dim = getattr(self.enc_model.module, "embed_dim", 512)
        _warm(hub, self.dec_engine,
              clips=np.zeros((CLIP_LEN, embed_dim), np.float32))

    def submit(self, ctx: FrameContext) -> Future | None:
        """Chain encoder → decoder without ever blocking the runner.

        The returned future resolves to the decoder's class
        probabilities, or None while the clip fills. The decoder submit
        happens inside the encoder future's callback (on the encoder
        engine's completer thread), so frames keep flowing while a
        decoder batch is pending."""
        prio = ctx.priority
        stream_id = ctx.stream_id
        tr = ctx.trace
        enc_fut = self.enc_engine.submit(
            priority=prio,
            stream=stream_id,
            trace=tr,
            frames=_wire_frame(ctx.frame, self.ingest_size, self.wire))
        outer: Future = Future()

        def _on_encoded(f: Future) -> None:
            # an exception raised inside a done-callback is swallowed:
            # every failure must land on `outer`, or the runner would
            # wait on it forever
            try:
                # encoder futures resolve in submission order (FIFO
                # batches), so the clip keeps frame order
                self.clip.append(f.result())
                if len(self.clip) < CLIP_LEN:
                    outer.set_result(None)  # the clip is still filling
                    return
                # raises RuntimeError when the engine is stopping
                dec_fut = self.dec_engine.submit(priority=prio,
                                                 stream=stream_id,
                                                 trace=tr,
                                                 clips=np.stack(self.clip))
            except Exception as exc:  # noqa: BLE001 — propagate to the runner
                outer.set_exception(exc)
                return

            def _on_decoded(g: Future) -> None:
                try:
                    outer.set_result(g.result())
                except Exception as exc:  # noqa: BLE001
                    outer.set_exception(exc)

            dec_fut.add_done_callback(_on_decoded)

        enc_fut.add_done_callback(_on_encoded)
        return outer

    def complete(self, ctx: FrameContext,
                 result: np.ndarray | None) -> list[FrameContext]:
        if result is None:
            return [ctx]  # the clip is still filling
        tensor = _frame_tensor("action", result, self.dec_model.labels,
                               self.threshold, data=True)
        if tensor is not None:
            ctx.tensors.append(tensor)
        return [ctx]


class AudioDetectStage(AsyncStage):
    """gvaaudiodetect counterpart: classify one-second 16 kHz windows
    (pipelines/audio_detection/environment/pipeline.json). Properties:
    threshold, sliding-window (the stride as a fraction of the window),
    model-instance-id."""

    WINDOW = 16000  # 1 s at 16 kHz, whatever the model's input size

    def __init__(self, name: str, model_key: str, properties: dict,
                 hub: EngineHub):
        self.name = name
        self.threshold = float(properties.get("threshold", 0.0))
        self.stride = max(1, int(
            self.WINDOW * float(properties.get("sliding-window", 0.2))))
        self.engine = hub.engine("audio", model_key,
                                 properties.get("model-instance-id"))
        self.model = hub.model(model_key)
        _warm(hub, self.engine, windows=np.zeros(self.WINDOW, np.int16))
        self._buffer = np.zeros(0, np.int16)
        self._since_last = 0

    def submit(self, ctx: FrameContext) -> Future | None:
        if ctx.audio is None:
            return None
        self._buffer = np.concatenate([self._buffer, ctx.audio])[-self.WINDOW:]
        self._since_last += len(ctx.audio)
        if len(self._buffer) < self.WINDOW or self._since_last < self.stride:
            return None
        self._since_last = 0
        return self.engine.submit(priority=ctx.priority,
                                  stream=ctx.stream_id,
                                  trace=ctx.trace,
                                  windows=self._buffer.copy())

    def complete(self, ctx: FrameContext,
                 result: np.ndarray | None) -> list[FrameContext]:
        if result is None:
            return [ctx]
        tensor = _frame_tensor("detection", result, self.model.labels,
                               self.threshold)
        if tensor is not None:
            ctx.tensors.append(tensor)
        return [ctx]
