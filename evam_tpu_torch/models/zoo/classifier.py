"""Attribute / category classifiers (counterpart of ``evam_tpu/models/zoo/classifier.py``).

The secondary-classification models (vehicle-attributes-recognition-
barrier-0039: color + type heads; emotions-recognition-retail-0003)
run on ROI crops taken on the device by the classify step. Input is
the reference's NHWC model input ``[B, H, W, 3]``, viewed as NCHW in
channels_last memory like the SSD's. Submodules carry flax's
auto-names (``ConvBlock_0``, ``SeparableConv_0..2``, ``Dense_0..``) so
a reference checkpoint maps key for key (``models/convert.py``). The
heads stay float, as in the reference (its ``nn.Dense`` is not
quantized); under ``quant`` the stem conv and the three pointwise
convs take the int8 path.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from evam_tpu_torch.models.zoo.layers import ConvBlock, SeparableConv


class MultiHeadClassifier(nn.Module):
    """Small convnet with one logits head per attribute; ``heads`` is
    ``((name, classes), ...)``, e.g. ``(("color", 7), ("type", 4))``."""

    def __init__(self, heads: tuple[tuple[str, int], ...], width: int = 32,
                 quant: bool = False):
        super().__init__()
        w, q = width, quant
        self.heads = tuple(heads)
        self.quant = quant
        self.ConvBlock_0 = ConvBlock(3, w, stride=2, quant=q)
        self.SeparableConv_0 = SeparableConv(w, w * 2, 2, quant=q)
        self.SeparableConv_1 = SeparableConv(w * 2, w * 4, 2, quant=q)
        self.SeparableConv_2 = SeparableConv(w * 4, w * 8, 2, quant=q)
        for i, (_, n) in enumerate(self.heads):
            self.add_module(f"Dense_{i}", nn.Linear(w * 8, n))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        # NHWC contiguous → NCHW view with channels_last strides
        x = self.ConvBlock_0(x.permute(0, 3, 1, 2))
        x = self.SeparableConv_0(x)
        x = self.SeparableConv_1(x)
        x = self.SeparableConv_2(x)
        x = x.mean(dim=(2, 3))  # global average pool
        return {name: getattr(self, f"Dense_{i}")(x)
                for i, (name, _) in enumerate(self.heads)}
