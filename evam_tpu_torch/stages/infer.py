"""Engine-backed inference stages (counterpart of ``evam_tpu/stages/infer.py``).

``DetectStage`` is the gvadetect counterpart: it encodes each frame to
the engine's wire format on the stream's thread, submits it to the
shared detect engine, and turns the packed result rows into regions.
Thresholds are applied here, on the host, so one engine (whose NMS uses
the permissive ``ENGINE_SCORE_FLOOR``) serves pipelines with different
``threshold`` parameters.

The motion gate (``inference-interval=adaptive`` / ``EVAM_GATE``) and
the region coaster come with a later slice: a skipped frame reuses the
last inferred regions.
"""

from __future__ import annotations

import logging
from concurrent.futures import Future

import numpy as np

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
    """Bilinear BGR uint8 resize on the host (half-pixel centers, edge
    clamped — cv2 ``INTER_LINEAR``'s sampling), so frames from streams of
    other sizes stack into one batch."""
    sh, sw = frame.shape[:2]
    if (sh, sw) == (h, w):
        return frame

    def taps(n_out, n_in):
        src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5,
                      0, n_in - 1)
        i0 = np.floor(src).astype(np.int64)
        return i0, np.minimum(i0 + 1, n_in - 1), (src - i0).astype(np.float32)

    y0, y1, wy = taps(h, sh)
    x0, x1, wx = taps(w, sw)
    f = frame.astype(np.float32)
    rows = f[y0] * (1 - wy)[:, None, None] + f[y1] * wy[:, None, None]
    out = rows[:, x0] * (1 - wx)[None, :, None] + rows[:, x1] * wx[None, :, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _wire_frame(frame: np.ndarray, size: tuple[int, int],
                wire_format: str) -> np.ndarray:
    """Resize to the engine's ingest size and encode to its wire format."""
    frame = resize_bgr_host(frame, size[0], size[1])
    if wire_format == "i420":
        return bgr_to_i420_host(frame)
    return np.ascontiguousarray(frame)


def _parse_interval(properties: dict) -> int:
    """``inference-interval``: a positive int (``adaptive`` needs the
    motion gate, which comes with a later slice)."""
    iv = properties.get("inference-interval", 1)
    if isinstance(iv, str) and iv.strip().lower() == "adaptive":
        raise NotImplementedError(
            "inference-interval=adaptive needs the motion gate, which "
            "comes with port slice 4 (tracking and gating)")
    return max(1, int(iv))


class DetectStage(AsyncStage):
    """gvadetect counterpart. Properties: threshold, inference-interval,
    model-instance-id."""

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
