"""Engine-backed inference stages (counterpart of ``evam_tpu/stages/infer.py``).

``DetectStage`` is the gvadetect counterpart: it encodes each frame to
the engine's wire format on the stream's thread, submits it to the
shared detect engine, and turns the packed result rows into regions.
``ClassifyStage`` (gvaclassify) submits the frame with the boxes of its
eligible regions and appends one attribute tensor per head to each;
``FusedDetectClassifyStage`` does both in one engine round trip.
Thresholds are applied here, on the host, so one engine (whose NMS uses
the permissive ``ENGINE_SCORE_FLOOR``) serves pipelines with different
``threshold`` parameters.

A frame skipped by a static ``inference-interval`` gets fresh copies of
the last inferred regions (``stages/track.py`` ``RegionCoaster``), so a
later stage that appends to a region touches only that frame's. The
motion gate comes with a later slice: where the reference would gate a
detect stage (``inference-interval=adaptive`` or ``EVAM_GATE=on``,
``evam_tpu/stages/gate.py`` ``GateConfig``), the port's stages raise
instead of serving ungated frames.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import Future

import numpy as np

from evam_tpu_torch import slices
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.ops.color import bgr_to_i420_host
from evam_tpu_torch.stages.base import AsyncStage
from evam_tpu_torch.stages.context import FrameContext, Region, Tensor
from evam_tpu_torch.stages.track import RegionCoaster

log = logging.getLogger("evam_tpu_torch.stages.infer")

#: floor baked into the shared engine's NMS; per-stage thresholds
#: filter above this
ENGINE_SCORE_FLOOR = 0.1


def _wire_safe_size(size: tuple[int, int]) -> tuple[int, int]:
    """Round an ingest (H, W) up to the I420 constraint (height%4, width%2)."""
    h, w = int(size[0]), int(size[1])
    return (-(-h // 4) * 4, -(-w // 2) * 2)


def resize_bgr_host(frame: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear BGR uint8 resize on the host, in the float32 arithmetic
    of the reference's native ``resize_bgr`` (``native/evam_media.cpp``:
    half-pixel centers, edge clamped, truncation after adding 0.5), so
    frames from streams of other sizes stack into one batch."""
    sh, sw = frame.shape[:2]
    if (sh, sw) == (h, w):
        return frame
    f32 = np.float32

    def taps(n_out, n_in):
        pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * (f32(n_in) / f32(n_out)) \
            - f32(0.5)
        i0 = np.maximum(pos.astype(np.int64), 0)  # C's truncation, then the clamp
        wt = np.maximum(pos - i0.astype(f32), f32(0))
        return i0, np.minimum(i0 + 1, n_in - 1), wt

    y0, y1, wy = taps(h, sh)
    x0, x1, wx = taps(w, sw)
    wy, wx = wy[:, None, None], wx[None, :, None]
    one = f32(1)
    r0, r1 = frame[y0], frame[y1]  # gather the rows before widening
    out = ((one - wy) * (one - wx) * r0[:, x0].astype(f32)
           + (one - wy) * wx * r0[:, x1].astype(f32)
           + wy * (one - wx) * r1[:, x0].astype(f32)
           + wy * wx * r1[:, x1].astype(f32) + f32(0.5))
    return out.astype(np.uint8)


def resize_bgr_to_i420_host(frame: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize and I420 encode on the host, in the 8-bit fixed
    point of the reference's native fused ``resize_bgr_to_i420``
    (``native/evam_media.cpp``), so the port's wire bytes equal the
    reference's on its default path (a host of 4 or more cores with the
    native library; its cv2 fallback rounds differently)."""
    sh, sw = frame.shape[:2]
    if (sh, sw) == (h, w):
        return bgr_to_i420_host(frame)  # the kernel's taps are the identity

    def taps(n_out, n_in):
        step = (n_in << 16) // n_out
        pos = np.maximum(np.arange(n_out, dtype=np.int64) * step
                         + (step >> 1) - (1 << 15), 0)
        i0 = pos >> 16
        return i0, np.minimum(i0 + 1, n_in - 1), (pos >> 8) & 0xFF

    def lerp(a, b, wt):
        return a + (((b - a) * wt) >> 8)

    y0, y1, wy = taps(h, sh)
    x0, x1, wx = taps(w, sw)
    wx = wx[None, :, None]
    i32 = np.int32
    r0, r1 = frame[y0], frame[y1]  # gather the rows before widening
    top = lerp(r0[:, x0].astype(i32), r0[:, x1].astype(i32), wx)
    bottom = lerp(r1[:, x0].astype(i32), r1[:, x1].astype(i32), wx)
    return bgr_to_i420_host(lerp(top, bottom, wy[:, None, None]))


def _wire_frame(frame: np.ndarray, size: tuple[int, int],
                wire_format: str) -> np.ndarray:
    """Resize to the engine's ingest size and encode to its wire format."""
    if wire_format == "i420":
        return resize_bgr_to_i420_host(frame, size[0], size[1])
    return np.ascontiguousarray(resize_bgr_host(frame, size[0], size[1]))


def _is_adaptive(properties: dict) -> bool:
    iv = properties.get("inference-interval", 1)
    return isinstance(iv, str) and iv.strip().lower() == "adaptive"


def _gate_enabled(properties: dict) -> bool:
    """The reference's rule for gating a detect stage
    (``GateConfig.from_properties``): ``EVAM_GATE=off`` beats
    everything; ``inference-interval=adaptive`` or ``EVAM_GATE=on``
    turns the gate on."""
    env_gate = os.environ.get("EVAM_GATE", "").strip().lower()
    if env_gate in ("off", "0", "false"):
        return False
    return _is_adaptive(properties) or env_gate in ("on", "1", "true")


def _refuse_gate(name: str, properties: dict) -> None:
    if _gate_enabled(properties):
        raise NotImplementedError(
            f"detect stage {name}: the motion gate "
            "(inference-interval=adaptive or EVAM_GATE=on) comes with "
            f"{slices.TRACK_GATE_RAGGED}")


def _parse_interval(properties: dict) -> int:
    """``inference-interval``: a positive int, or ``"adaptive"`` — the
    gate's schedule, under which the static interval collapses to 1."""
    if _is_adaptive(properties):
        return 1
    return max(1, int(properties.get("inference-interval", 1)))


class DetectStage(AsyncStage):
    """gvadetect counterpart. Properties: threshold, inference-interval,
    model-instance-id."""

    def __init__(self, name: str, model_key: str, properties: dict,
                 hub: EngineHub):
        _refuse_gate(name, properties)
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
        self.wire = hub.wire_format
        self.ingest_size = _wire_safe_size(
            (self.model.preprocess.height, self.model.preprocess.width))
        self.engine = hub.engine(
            "detect", model_key, properties.get("model-instance-id"),
            score_threshold=ENGINE_SCORE_FLOOR)
        self._coaster = RegionCoaster()
        self._count = 0

    def submit(self, ctx: FrameContext) -> Future | None:
        self._count += 1
        if (self._count - 1) % self.interval:
            return None  # inference-interval skip: reuse last regions
        return self.engine.submit(
            frames=_wire_frame(ctx.frame, self.ingest_size, self.wire))

    def complete(self, ctx: FrameContext,
                 result: np.ndarray | None) -> list[FrameContext]:
        if result is None:
            # interval skip: fresh copies of the last detections
            ctx.regions.extend(self._coaster.reuse())
            return [ctx]
        regions = [_region(row, self.model.labels) for row in result
                   if row[6] >= 0.5 and row[4] >= self.threshold]
        self._coaster.observe(regions)
        ctx.regions.extend(regions)
        return [ctx]


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
        self.wire = hub.wire_format
        self.model = hub.model(model_key)
        # crops are taken on the device from the submitted frame: one
        # ingest size keeps cross-stream batches stackable while
        # keeping enough pixels for small ROIs
        self.ingest_size = _wire_safe_size(
            tuple(properties.get("ingest-size", (432, 768))))
        self.engine = hub.engine(
            "classify", model_key, properties.get("model-instance-id"),
            roi_budget=self.ROI_BUDGET)
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
        boxes = np.zeros((self.ROI_BUDGET, 4), np.float32)
        for i, r in enumerate(regions):
            boxes[i] = [r.x0, r.y0, r.x1, r.y1]
        return self.engine.submit(
            units=len(regions),
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
        _refuse_gate(name, det_props)
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
        self.wire = hub.wire_format
        self.ingest_size = _wire_safe_size(
            (self.det_model.preprocess.height, self.det_model.preprocess.width))
        self.engine = hub.fused_engine(
            det_key, cls_key, det_props.get("model-instance-id"),
            roi_budget=self.ROI_BUDGET,
            score_threshold=ENGINE_SCORE_FLOOR,
            allowed_label_ids=allowed)
        self.cls_model = hub.model(cls_key)
        self._heads = _head_slices(self.cls_model, offset=7)
        self._coaster = RegionCoaster()
        self._count = 0

    def submit(self, ctx: FrameContext) -> Future | None:
        self._count += 1
        if (self._count - 1) % self.interval:
            return None
        return self.engine.submit(
            frames=_wire_frame(ctx.frame, self.ingest_size, self.wire))

    def complete(self, ctx: FrameContext,
                 result: np.ndarray | None) -> list[FrameContext]:
        if result is None:
            ctx.regions.extend(self._coaster.reuse())
            return [ctx]
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
