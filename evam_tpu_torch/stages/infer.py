"""Engine-backed inference stages (counterpart of ``evam_tpu/stages/infer.py``).

``DetectStage`` is the gvadetect counterpart: it encodes each frame to
the engine's wire format on the stream's thread, submits it to the
shared detect engine, and turns the packed result rows into regions.
Thresholds are applied here, on the host, so one engine (whose NMS uses
the permissive ``ENGINE_SCORE_FLOOR``) serves pipelines with different
``threshold`` parameters.

The motion gate and the region coaster come with a later slice: where
the reference would gate a detect stage (``inference-interval=adaptive``
or ``EVAM_GATE=on``, ``evam_tpu/stages/gate.py`` ``GateConfig``), the
port's stage raises instead of serving ungated frames. A frame skipped
by a static interval reuses the last inferred regions.
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
        if _gate_enabled(properties):
            raise NotImplementedError(
                f"detect stage {name}: the motion gate "
                "(inference-interval=adaptive or EVAM_GATE=on) comes with "
                f"{slices.TRACK_GATE_RAGGED}")
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
        self._count = 0
        self._last_regions: list[Region] = []

    def submit(self, ctx: FrameContext) -> Future | None:
        self._count += 1
        if (self._count - 1) % self.interval:
            return None  # inference-interval skip: reuse last regions
        return self.engine.submit(
            frames=_wire_frame(ctx.frame, self.ingest_size, self.wire))

    def complete(self, ctx: FrameContext,
                 result: np.ndarray | None) -> list[FrameContext]:
        if result is None:
            ctx.regions.extend(self._last_regions)
            return [ctx]
        labels = self.model.labels
        regions = []
        for row in result:
            x0, y0, x1, y1, score, label_id, valid = row
            if valid < 0.5 or score < self.threshold:
                continue
            lid = int(label_id)
            label = labels[lid] if 0 <= lid < len(labels) else str(lid)
            region = Region(
                x0=float(x0), y0=float(y0), x1=float(x1), y1=float(y1),
                confidence=float(score), label_id=lid, label=label,
            )
            region.tensors.append(Tensor(
                name="detection", confidence=float(score), label_id=lid,
                label=label, is_detection=True))
            regions.append(region)
        self._last_regions = regions
        ctx.regions.extend(regions)
        return [ctx]
