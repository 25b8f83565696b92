"""Box utilities: anchors, decoding, IoU (counterpart of ``evam_tpu/ops/boxes.py``).

Anchors are numpy, computed once per model build (copied from the
reference). Decode and IoU are elementwise torch ops that run on the
device inside the detect step.
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
