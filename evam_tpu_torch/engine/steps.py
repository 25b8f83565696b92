"""Step builders (counterpart of ``evam_tpu/engine/steps.py``).

A builder returns ``step(frames)``, mapping a wire-encoded uint8 batch
already on the model's device to ONE packed float32 tensor — the
reference's single-readback contract. Where the reference jits the
step, the port runs it eagerly under ``torch.inference_mode()``: the
whole chain — preprocess, net, decode, NMS — stays on the device and
never syncs with the host.

This slice ports the detect step (SSD branch).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from evam_tpu_torch.models.registry import LoadedModel
from evam_tpu_torch.ops.boxes import decode_boxes
from evam_tpu_torch.ops.nms import batched_nms
from evam_tpu_torch.ops.preprocess import preprocess_wire

#: Packed detection row layout: [x0, y0, x1, y1, score, label, valid]
DETECT_FIELDS = 7


def _wire_spec(model: LoadedModel, wire_format: str):
    """Model preprocess spec bound to the step's wire format."""
    return dataclasses.replace(model.preprocess, wire_format=wire_format)


def _detect_packed(x, model, anchors, max_detections, iou_threshold,
                   score_threshold):
    """Preprocessed input → (packed [B,K,7], boxes). See DETECT_FIELDS."""
    if model.detector_kind != "ssd":
        raise NotImplementedError(
            f"detector kind {model.detector_kind!r} comes with a later "
            "port slice (OpenVINO IR import)")
    out = model.forward(x)
    boxes = decode_boxes(out["loc"].float(), anchors,
                         variances=model.variances)
    conf = out["conf"].float()
    scores = conf if model.conf_is_prob else torch.softmax(conf, dim=-1)
    bx, sc, lb, valid = batched_nms(
        boxes, scores,
        max_outputs=max_detections,
        iou_threshold=iou_threshold,
        score_threshold=score_threshold,
    )
    packed = torch.cat(
        [bx, sc[..., None], lb[..., None].float(), valid[..., None].float()],
        dim=-1,
    )
    return packed, bx


def build_detect_step(
    model: LoadedModel,
    max_detections: int = 32,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.3,
    wire_format: str = "bgr",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wire-encoded uint8 frames → packed detections [B,K,7] float32."""
    anchors = torch.from_numpy(model.anchors).to(model.device)
    spec = _wire_spec(model, wire_format)

    def step(frames: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = preprocess_wire(frames, spec)
            packed, _ = _detect_packed(x, model, anchors, max_detections,
                                       iou_threshold, score_threshold)
            return packed

    return step
