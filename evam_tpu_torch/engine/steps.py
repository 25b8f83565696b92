"""Step builders (counterpart of ``evam_tpu/engine/steps.py``).

A builder returns ``step(frames)`` (or ``step(frames, boxes)`` for
classify), mapping a wire-encoded uint8 batch already on the model's
device to ONE packed float32 tensor — the reference's single-readback
contract. Where the reference jits the step, the port runs it under
``torch.inference_mode()``: the whole chain — preprocess, net, decode,
NMS, ROI crop, classifier — stays on the device and never syncs with
the host, so the engine can capture it into one CUDA graph per batch
bucket (``engine/graphs.py``) and replay it. Nothing a step runs may
copy from the host or wait for the device: every constant is built on
the device when the step is built.

Ported: the detect step (SSD and YOLO detectors), the classify step
and its packed-ragged form (``EVAM_RAGGED=packed``), the fused
detect+classify step, the action encode and decode steps and the audio
step. A model that already emits probabilities (an IR's in-graph
SoftMax: ``conf_is_prob``, ``head_is_prob``, ``out_is_prob``) is not
softmaxed again. Each step names the hand kernels' libraries it
launches (``step.libraries``), so an engine loads them before its
first warm run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from evam_tpu_torch.models.registry import LoadedModel
from evam_tpu_torch.ops.boxes import decode_boxes, yolo_gather
from evam_tpu_torch.ops.color import crop_rois_i420
from evam_tpu_torch.ops.nms import batched_nms
from evam_tpu_torch.ops.preprocess import (
    crop_rois,
    decode_wire,
    prepare_constants,
    preprocess_bgr,
    preprocess_wire,
)

#: Packed detection row layout: [x0, y0, x1, y1, score, label, valid]
DETECT_FIELDS = 7


def step_libraries(*models: LoadedModel) -> tuple[str, ...]:
    """The hand kernels' libraries (``ops/kernels.py``) a step over
    ``models`` launches on the card: the int8 GEMM's where a model has
    int8 convolutions and ``EVAM_QGEMM=pallas`` sends its pointwise
    convolutions to the kernel; none otherwise."""
    from evam_tpu_torch.models.zoo.layers import QuantConv
    from evam_tpu_torch.ops import qlinear

    if qlinear.QGEMM_BACKEND == "pallas" and any(
            isinstance(m, QuantConv) for model in models
            for m in model.module.modules()):
        return ("qgemm",)
    return ()


def _declare_libraries(step: Callable, *models: LoadedModel) -> Callable:
    """``step.libraries``: what the engine loads before its first warm
    run, outside the device lock (``engine/batcher.py`` ``warmup``)."""
    step.libraries = step_libraries(*models)
    return step


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
    b, r = boxes.shape[:2]
    return _crop_probs(model, frames, boxes, wire_format).reshape(b, r, -1)


def _crop_probs(model: LoadedModel, frames: torch.Tensor,
                boxes: torch.Tensor, wire_format: str) -> torch.Tensor:
    """Wire frames [B, ...] + boxes [B, R, 4] → per-head probabilities
    [B·R, Σ classes], heads in ``model.spec.heads`` order."""
    pre = model.preprocess
    if wire_format == "i420":
        # crop straight from the wire planes: the full-resolution BGR
        # batch never materializes
        crops = crop_rois_i420(frames, boxes, (pre.height, pre.width))
    else:
        crops = crop_rois(decode_wire(frames, wire_format), boxes,
                          (pre.height, pre.width))
    crops = crops.reshape((-1,) + crops.shape[2:])
    out = model.forward(preprocess_bgr(crops, pre))
    return torch.cat([_head_probs(model, name, out)
                      for name, _ in model.spec.heads], dim=-1)


def _wire_spec(model: LoadedModel, wire_format: str):
    """Model preprocess spec bound to the step's wire format, its
    constants built on the device."""
    prepare_constants(model.preprocess, model.device)
    return dataclasses.replace(model.preprocess, wire_format=wire_format)


def _detector_constants(model: LoadedModel):
    """The detect step's box constants on the model's device, built once:
    the SSD anchors, or each YOLO head's spec with its anchors as a
    tensor."""
    if model.detector_kind == "yolo":
        return [{"anchors": torch.tensor(spec["anchors"], dtype=torch.float32,
                                         device=model.device)}
                for spec in model.yolo_specs]
    return torch.from_numpy(model.anchors).to(model.device)


def _detect_packed(x, model, anchors, max_detections, iou_threshold,
                   score_threshold):
    """Preprocessed input → (packed [B,K,7], boxes). See DETECT_FIELDS.
    ``anchors``: :func:`_detector_constants`."""
    out = model.forward(x)
    if model.detector_kind == "yolo":
        # RegionYolo-cut IR: raw grid maps, decoded here — scores come
        # out as probabilities with a background column. Numeric sort:
        # a lexicographic one would pair yolo_10 with head 2's anchors.
        keys = sorted(out, key=lambda k: int(k.rsplit("_", 1)[1]))
        if len(keys) != len(anchors):
            raise ValueError(
                f"{len(keys)} yolo outputs vs {len(anchors)} anchor specs "
                "— importer/model mismatch")
        boxes, scores = yolo_gather(
            [out[k].float() for k in keys], anchors,
            (model.preprocess.height, model.preprocess.width),
            model.spec.num_classes)
    else:
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
    anchors = _detector_constants(model)
    spec = _wire_spec(model, wire_format)

    def step(frames: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = preprocess_wire(frames, spec)
            packed, _ = _detect_packed(x, model, anchors, max_detections,
                                       iou_threshold, score_threshold)
            return packed

    return _declare_libraries(step, model)


def build_classify_step(
    model: LoadedModel, roi_budget: int = 8, wire_format: str = "bgr"
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Frames + ROI boxes → packed per-ROI head probabilities.

    ``frames`` wire-encoded uint8 [B, ...]; ``boxes`` float32 [B, R, 4]
    normalized corners (R = roi_budget, unused rows zero). Output
    [B, R, Σ classes]: the heads' probability vectors, concatenated in
    ``model.spec.heads`` order.
    """
    prepare_constants(model.preprocess, model.device)

    def step(frames: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return _classify_crops(model, frames, boxes, wire_format)

    return _declare_libraries(step, model)


def build_classify_step_ragged(
    model: LoadedModel, roi_budget: int = 8, wire_format: str = "bgr"
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Packed-ragged classify (``EVAM_RAGGED=packed``,
    ``engine/ragged.py``): frames + a packed box block + segment ids →
    per-unit head probabilities.

    ``frames`` wire-encoded uint8 [B, ...]; ``boxes`` float32 [U, 4],
    every frame's real boxes end to end; ``seg`` int32 [U], the batch
    row that owns each unit (−1 on the pad tail). Pad units gather a
    clamped, valid frame so the step has no branch, and their rows are
    zeroed by the validity mask. Output [U, Σ classes]; the completer
    hands each item its rows through the sealed batch's
    ``row_len``/``row_offset``. ``roi_budget`` is the dense step's
    signature kept; the packed block's size comes from the ring.
    """
    prepare_constants(model.preprocess, model.device)

    def step(frames: torch.Tensor, boxes: torch.Tensor,
             seg: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            src = torch.clamp(seg, 0, frames.shape[0] - 1).long()
            f = torch.index_select(frames, 0, src)  # [U, wire...]
            probs = _crop_probs(model, f, boxes[:, None, :], wire_format)
            valid = (seg >= 0).to(probs.dtype)
            return probs * valid[:, None]

    return _declare_libraries(step, model)


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
    anchors = _detector_constants(det_model)
    det_spec = _wire_spec(det_model, wire_format)
    prepare_constants(cls_model.preprocess, cls_model.device)
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
                # torch.isin may sort and sync with the host; a
                # comparison against each allowed label never does
                eligible = eligible & (packed[..., 5:6] == allowed).any(-1)
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

    return _declare_libraries(step, det_model, cls_model)


def build_action_encode_step(
    model: LoadedModel, wire_format: str = "bgr"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wire-encoded uint8 frames → embeddings [B, D] float32."""
    spec = _wire_spec(model, wire_format)

    def step(frames: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model.forward(preprocess_wire(frames, spec)).float()

    return _declare_libraries(step, model)


def build_action_decode_step(
        model: LoadedModel) -> Callable[[torch.Tensor], torch.Tensor]:
    """Embedding clips [B, T, D] float32 → class probabilities [B, C]
    (the registry serves the decoder in float32 arithmetic, as flax
    promotes its params against float32 clips)."""
    is_prob = model.out_is_prob  # an IR may softmax in-graph

    def step(clips: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            out = model.forward(clips.float()).float()
            return out if is_prob else torch.softmax(out, dim=-1)

    return _declare_libraries(step, model)


def build_audio_step(
        model: LoadedModel) -> Callable[[torch.Tensor], torch.Tensor]:
    """int16 audio windows [B, S] → class probabilities [B, C].

    S16LE is normalized to [-1, 1] on the device (the reference's
    gvaaudiodetect consumes S16LE directly,
    pipelines/audio_detection/environment/pipeline.json:5); AclNet runs
    in float32 arithmetic, as the decoder does."""
    is_prob = model.out_is_prob  # an IR may softmax in-graph

    def step(windows: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = windows.float() / 32768.0
            out = model.forward(x).float()
            return out if is_prob else torch.softmax(out, dim=-1)

    return _declare_libraries(step, model)
