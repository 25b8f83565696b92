"""Box utilities: anchors, decoding, IoU (counterpart of ``evam_tpu/ops/boxes.py``).

Anchors are numpy, computed once per model build (copied from the
reference). Decode (SSD and YOLO) and IoU are elementwise torch ops
that run on the device inside the detect step; ``encode_boxes``, the
SSD decode's inverse, makes the accuracy harness's training targets.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch


def generate_anchors(
    feature_shapes: list[tuple[int, int]],
    image_size: tuple[int, int] = (1, 1),
    min_scale: float = 0.1,
    max_scale: float = 0.9,
    aspect_ratios: tuple[float, ...] = (1.0, 2.0, 0.5),
) -> np.ndarray:
    """SSD-style multi-scale anchors, normalized cxcywh, shape [A, 4]."""
    del image_size
    anchors = []
    k = len(feature_shapes)
    scales = [min_scale + (max_scale - min_scale) * i / max(k - 1, 1) for i in range(k)]
    scales.append(1.0)
    for idx, (fh, fw) in enumerate(feature_shapes):
        s = scales[idx]
        s_next = scales[idx + 1]
        boxes_per_cell = [(s, ar) for ar in aspect_ratios]
        boxes_per_cell.append((math.sqrt(s * s_next), 1.0))  # interpolated scale
        for y, x in itertools.product(range(fh), range(fw)):
            cy = (y + 0.5) / fh
            cx = (x + 0.5) / fw
            for scale, ar in boxes_per_cell:
                anchors.append([cx, cy, scale * math.sqrt(ar), scale / math.sqrt(ar)])
    return np.asarray(anchors, dtype=np.float32)


def anchors_per_cell(aspect_ratios: tuple[float, ...] = (1.0, 2.0, 0.5)) -> int:
    return len(aspect_ratios) + 1


def decode_boxes(
    deltas: torch.Tensor,
    anchors: torch.Tensor,
    variances: tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2),
) -> torch.Tensor:
    """SSD center-offset decode: deltas [..., A, 4] + anchors [A, 4]
    (cxcywh) → corner boxes [..., A, 4] (x0, y0, x1, y1), clipped to the
    unit square."""
    acx, acy, aw, ah = anchors.unbind(-1)
    dx, dy, dw, dh = deltas.unbind(-1)
    cx = acx + dx * variances[0] * aw
    cy = acy + dy * variances[1] * ah
    w = aw * torch.exp(torch.clamp(dw * variances[2], -10.0, 10.0))
    h = ah * torch.exp(torch.clamp(dh * variances[3], -10.0, 10.0))
    boxes = torch.stack(
        [cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], dim=-1
    )
    return torch.clamp(boxes, 0.0, 1.0)


def encode_boxes(
    boxes: torch.Tensor,
    anchors: torch.Tensor,
    variances: tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2),
) -> torch.Tensor:
    """Inverse of :func:`decode_boxes` (training targets): corner boxes
    [..., A, 4] + anchors [A, 4] (cxcywh) → offsets [..., A, 4]. Widths
    and heights are floored at 1e-6, so an empty box (an unmatched
    anchor's zero target) encodes to finite offsets."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    acx, acy, aw, ah = anchors.unbind(-1)
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    w = torch.clamp(x1 - x0, min=1e-6)
    h = torch.clamp(y1 - y0, min=1e-6)
    dx = (cx - acx) / (aw * variances[0])
    dy = (cy - acy) / (ah * variances[1])
    dw = torch.log(w / aw) / variances[2]
    dh = torch.log(h / ah) / variances[3]
    return torch.stack([dx, dy, dw, dh], dim=-1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between corner boxes a [..., N, 4] and b [..., M, 4]
    → [..., N, M]."""
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def yolo_decode(
    feature_map: torch.Tensor,
    anchors: torch.Tensor,
    num_classes: int,
    input_hw: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode one YOLO (v3-style) head into normalized boxes and scores.

    ``feature_map``: [B, A*(5+C), H, W] raw conv output (NCHW: the IR
    importer cuts the graph at RegionYolo). ``anchors``: [A, 2] (w, h)
    in input pixels. Returns (boxes [B, A*H*W, 4] normalized corners,
    scores [B, A*H*W, C]) with score = sigmoid(obj) * sigmoid(class),
    the v3 multi-label convention.
    """
    b, chan, h, w = feature_map.shape
    a = anchors.shape[0]
    per = 5 + num_classes
    if chan != a * per:
        raise ValueError(
            f"RegionYolo map has {chan} channels, expected "
            f"{a}*(5+{num_classes})={a * per}"
        )
    ih, iw = input_hw
    x = feature_map.reshape(b, a, per, h, w)
    tx, ty = x[:, :, 0], x[:, :, 1]
    tw, th = x[:, :, 2], x[:, :, 3]
    obj = x[:, :, 4]
    cls = x[:, :, 5:]  # [B, A, C, H, W]

    dev = feature_map.device
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    cx = (torch.sigmoid(tx) + gx) / w
    cy = (torch.sigmoid(ty) + gy) / h
    aw = anchors[:, 0].float()[None, :, None, None]
    ah = anchors[:, 1].float()[None, :, None, None]
    # cap the size logit (standard yolo guard): keeps inf/NaN out of
    # the shared NMS when the net emits garbage (warmup, random init)
    bw = aw * torch.exp(torch.clamp(tw, max=10.0)) / iw
    bh = ah * torch.exp(torch.clamp(th, max=10.0)) / ih

    boxes = torch.stack(
        [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=2
    )  # [B, A, 4, H, W]
    scores = torch.sigmoid(obj)[:, :, None] * torch.sigmoid(cls)

    boxes = boxes.permute(0, 1, 3, 4, 2).reshape(b, a * h * w, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(
        b, a * h * w, num_classes)
    return boxes, scores


def yolo_gather(
    maps: list[torch.Tensor],
    specs: list[dict],
    input_hw: tuple[int, int],
    num_classes: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode and concatenate multi-scale YOLO heads; prepend the
    background column so the result feeds ``batched_nms``'s
    SSD-convention scores [B, A_total, 1+C]. A spec's ``anchors`` is a
    list of (w, h) pairs or an [A, 2] tensor already on the maps'
    device (the detect step builds those once, so it never copies from
    the host)."""
    all_boxes, all_scores = [], []
    for m, spec in zip(maps, specs):
        bx, sc = yolo_decode(
            m, torch.as_tensor(spec["anchors"], dtype=torch.float32,
                               device=m.device),
            num_classes, input_hw,
        )
        all_boxes.append(bx)
        all_scores.append(sc)
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    bg = torch.zeros(scores.shape[:-1] + (1,), dtype=scores.dtype,
                     device=scores.device)
    return boxes, torch.cat([bg, scores], dim=-1)
