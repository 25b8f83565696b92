"""SSD-family detector (counterpart of ``evam_tpu/models/zoo/ssd.py``).

Input is the reference's NHWC model input ``[B, H, W, 3]``; it is viewed
as NCHW in channels_last memory (no copy). Each head's NCHW output is
permuted to NHWC before ``reshape(b, -1, 4)``, which keeps the
reference's (y, x, anchor) order — the order of ``generate_anchors``.
The heads stay float, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from evam_tpu_torch.models.zoo.layers import Backbone, Conv
from evam_tpu_torch.ops.boxes import anchors_per_cell, generate_anchors


class SSDHead(nn.Module):
    def __init__(self, in_ch: int, num_anchors: int, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.Conv_0 = Conv(in_ch, num_anchors * 4, 3)
        self.Conv_1 = Conv(in_ch, num_anchors * num_classes, 3)

    def forward(self, feat: torch.Tensor):
        b = feat.shape[0]
        loc = self.Conv_0(feat).permute(0, 2, 3, 1).reshape(b, -1, 4)
        conf = self.Conv_1(feat).permute(0, 2, 3, 1).reshape(
            b, -1, self.num_classes)
        return loc, conf


class SSDDetector(nn.Module):
    """Multi-scale single-shot detector; ``num_classes`` includes the
    background at index 0."""

    def __init__(self, num_classes: int = 4, width: int = 32,
                 extra_levels: int = 2,
                 aspect_ratios: tuple[float, ...] = (1.0, 2.0, 0.5),
                 quant: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.width = width
        self.extra_levels = extra_levels
        self.aspect_ratios = aspect_ratios
        self.quant = quant
        self.Backbone_0 = Backbone(width, extra_levels, quant=quant)
        num_anchors = anchors_per_cell(aspect_ratios)
        for i, ch in enumerate(Backbone.feature_channels(width, extra_levels)):
            self.add_module(f"SSDHead_{i}",
                            SSDHead(ch, num_anchors, num_classes))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        # NHWC contiguous → NCHW view with channels_last strides
        feats = self.Backbone_0(x.permute(0, 3, 1, 2))
        locs, confs = [], []
        for i, feat in enumerate(feats):
            loc, conf = getattr(self, f"SSDHead_{i}")(feat)
            locs.append(loc)
            confs.append(conf)
        return {"loc": torch.cat(locs, dim=1), "conf": torch.cat(confs, dim=1)}

    @staticmethod
    def feature_shapes(input_size: tuple[int, int], extra_levels: int = 2):
        # SAME-padded stride-2 convs round up: ceil-divisions
        h, w = input_size
        return [(-(-h // (8 * 2**i)), -(-w // (8 * 2**i)))
                for i in range(3 + extra_levels)]

    def anchors(self, input_size: tuple[int, int]) -> np.ndarray:
        return generate_anchors(
            self.feature_shapes(input_size, self.extra_levels),
            aspect_ratios=self.aspect_ratios,
        )
