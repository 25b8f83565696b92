"""Step builders (counterpart of ``evam_tpu/engine/steps.py``).

A builder returns ``step(frames)`` (or ``step(frames, boxes)`` for
classify), mapping a wire-encoded uint8 batch already on the model's
device to ONE packed float32 tensor — the reference's single-readback
contract. Where the reference jits the step, the port runs it eagerly
under ``torch.inference_mode()``: the whole chain — preprocess, net,
decode, NMS, ROI crop, classifier — stays on the device and never syncs
with the host.

Ported: the detect step (SSD branch), the classify step and the fused
detect+classify step. The packed-ragged classify step comes with a
later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from evam_tpu_torch.models.registry import LoadedModel
from evam_tpu_torch.ops.boxes import decode_boxes
from evam_tpu_torch.ops.color import crop_rois_i420
from evam_tpu_torch.ops.nms import batched_nms
from evam_tpu_torch.ops.preprocess import (
    crop_rois,
    decode_wire,
    preprocess_bgr,
    preprocess_wire,
)

#: Packed detection row layout: [x0, y0, x1, y1, score, label, valid]
DETECT_FIELDS = 7


def _head_probs(model: LoadedModel, name: str, out) -> torch.Tensor:
    """Per-head probabilities in float32 (a head that already emits
    probabilities, ``head_is_prob``, is not softmaxed again)."""
    x = out[name].float()
    if model.head_is_prob.get(name, False):
        return x
    return torch.softmax(x, dim=-1)


def _classify_crops(model: LoadedModel, frames: torch.Tensor,
                    boxes: torch.Tensor, wire_format: str) -> torch.Tensor:
    """Wire frames [B, ...] + boxes [B, R, 4] → per-head probabilities
    [B, R, Σ classes], heads in ``model.spec.heads`` order."""
    pre = model.preprocess
    b, r = boxes.shape[:2]
    if wire_format == "i420":
        # crop straight from the wire planes: the full-resolution BGR
        # batch never materializes
        crops = crop_rois_i420(frames, boxes, (pre.height, pre.width))
    else:
        crops = crop_rois(decode_wire(frames, wire_format), boxes,
                          (pre.height, pre.width))
    crops = crops.reshape((b * r,) + crops.shape[2:])
    out = model.forward(preprocess_bgr(crops, pre))
    probs = torch.cat([_head_probs(model, name, out)
                       for name, _ in model.spec.heads], dim=-1)
    return probs.reshape(b, r, -1)


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


def build_classify_step(
    model: LoadedModel, roi_budget: int = 8, wire_format: str = "bgr"
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Frames + ROI boxes → packed per-ROI head probabilities.

    ``frames`` wire-encoded uint8 [B, ...]; ``boxes`` float32 [B, R, 4]
    normalized corners (R = roi_budget, unused rows zero). Output
    [B, R, Σ classes]: the heads' probability vectors, concatenated in
    ``model.spec.heads`` order.
    """

    def step(frames: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return _classify_crops(model, frames, boxes, wire_format)

    return step


def build_detect_classify_step(
    det_model: LoadedModel,
    cls_model: LoadedModel,
    max_detections: int = 32,
    roi_budget: int = 8,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.3,
    wire_format: str = "bgr",
    allowed_label_ids: tuple[int, ...] | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fused detect + classify: ONE frame upload, ONE readback.

    Preprocess → SSD → NMS → crop of the first ``roi_budget`` eligible
    detections (valid, and of an ``allowed_label_ids`` class when
    given; NMS score order kept) from the wire frames → classifier.
    Output [B, K, 7 + Σ classes]: the packed detections, then each
    row's probability block, all zero exactly where the row was not
    classified (a classified block sums to the number of heads).
    """
    anchors = torch.from_numpy(det_model.anchors).to(det_model.device)
    det_spec = _wire_spec(det_model, wire_format)
    allowed = (None if allowed_label_ids is None else torch.tensor(
        [float(lid) for lid in allowed_label_ids], dtype=torch.float32,
        device=det_model.device))

    def step(frames: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = preprocess_wire(frames, det_spec)
            packed, bx = _detect_packed(x, det_model, anchors, max_detections,
                                        iou_threshold, score_threshold)
            eligible = packed[..., 6] > 0.5
            if allowed is not None:
                eligible = eligible & torch.isin(packed[..., 5], allowed)
            # stable: eligible rows first, NMS order kept within each group
            order = torch.argsort((~eligible).to(torch.int32), dim=1,
                                  stable=True)
            roi_idx = order[:, :roi_budget]
            roi_boxes = torch.gather(
                bx, 1, roi_idx[..., None].expand(-1, -1, bx.shape[-1]))
            roi_ok = torch.gather(eligible, 1, roi_idx)
            probs = _classify_crops(cls_model, frames, roi_boxes, wire_format)
            probs = probs * roi_ok[..., None]
            # each ROI's block back onto its detection row
            full = torch.zeros(packed.shape[:2] + probs.shape[2:],
                               dtype=torch.float32, device=packed.device)
            full.scatter_(1, roi_idx[..., None].expand_as(probs), probs)
            return torch.cat([packed, full], dim=-1)

    return step
