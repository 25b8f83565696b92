"""Shared conv building blocks (counterpart of ``evam_tpu/models/zoo/layers.py``).

Conv + bias + activation blocks, BatchNorm folded as in the reference.
Submodules carry flax's auto-generated names (``ConvBlock_0``,
``SeparableConv_3``, ``Conv_1``) so a reference checkpoint maps onto
the port's ``state_dict`` key for key (``models/convert.py``).

Port notes:

* flax ``"SAME"`` padding is explicit ``F.pad`` (asymmetric at stride
  2, ``ops/padding.py``), never ``padding=1``;
* ``relu6`` is ``hardtanh(0, 6)``;
* activations run NCHW-shaped in ``torch.channels_last`` memory, so a
  1×1 conv's input is a contiguous ``[B·H·W, C]`` matrix for the int8
  kernel;
* the depthwise conv is the reference's default ``EVAM_DWCONV=lax``
  grouped conv; the shift-and-add variant comes in a later slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from evam_tpu_torch.ops.padding import pad_same
from evam_tpu_torch.ops.qlinear import qconv_nchw, quantize_weight


def relu6(x: torch.Tensor) -> torch.Tensor:
    return F.hardtanh(x, 0.0, 6.0)


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel, strides, padding="SAME",
    feature_group_count=groups)``: weight OIHW, bias [O]."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(features, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_same(x, self.weight.shape[2:], self.stride)
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        groups=self.groups)


class QuantConv(Conv):
    """Drop-in :class:`Conv` on the int8 path (same parameters).

    :meth:`quantize_` turns the served float weight into int8 codes and
    per-output-channel scales (buffers, not part of the ``state_dict``);
    the registry calls it once after loading and casting the weights.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("wq", None, persistent=False)
        self.register_buffer("w_scale", None, persistent=False)

    @torch.no_grad()
    def quantize_(self) -> None:
        wq, w_scale = quantize_weight(self.weight, out_axis=0)
        self.wq = wq.contiguous()
        self.w_scale = w_scale.contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.wq is None:
            raise RuntimeError(
                "QuantConv weights are not quantized: call quantize_model() "
                "after loading or changing the weights")
        out = qconv_nchw(x, self.wq, self.w_scale, self.bias, self.stride,
                         self.groups)
        return out.to(x.dtype if x.is_floating_point() else torch.float32)


def quantize_model(module: nn.Module) -> nn.Module:
    """Quantize every :class:`QuantConv` of ``module`` from its current weights."""
    for m in module.modules():
        if isinstance(m, QuantConv):
            m.quantize_()
    return module


def _conv(quant: bool, in_ch: int, features: int, kernel: int,
          stride: int = 1, groups: int = 1) -> Conv:
    cls = QuantConv if quant else Conv
    return cls(in_ch, features, kernel, stride, groups)


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, quant: bool = False):
        super().__init__()
        self.Conv_0 = _conv(quant, in_ch, features, kernel, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu6(self.Conv_0(x))


class SeparableConv(nn.Module):
    """Depthwise separable conv (MobileNet-style). The depthwise conv
    stays float; the pointwise conv takes the int8 path under quant."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 quant: bool = False):
        super().__init__()
        self.Conv_0 = Conv(in_ch, in_ch, 3, stride, groups=in_ch)
        self.Conv_1 = _conv(quant, in_ch, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu6(self.Conv_1(relu6(self.Conv_0(x))))


class Backbone(nn.Module):
    """Strided separable-conv backbone emitting multi-scale features at
    strides /8, /16, /32 (+ ``extra_levels`` /64, /128 levels).
    ``quant=True`` runs the pointwise and plain convs on the int8 path."""

    def __init__(self, width: int = 32, extra_levels: int = 2,
                 quant: bool = False):
        super().__init__()
        w, q = width, quant
        self.extra_levels = extra_levels
        self.ConvBlock_0 = ConvBlock(3, w, stride=2, quant=q)          # /2
        plan = [(w, w * 2, 2), (w * 2, w * 2, 1),                      # /4
                (w * 2, w * 4, 2), (w * 4, w * 4, 1),                  # /8
                (w * 4, w * 8, 2), (w * 8, w * 8, 1),                  # /16
                (w * 8, w * 16, 2), (w * 16, w * 16, 1)]               # /32
        for i, (cin, cout, s) in enumerate(plan):
            self.add_module(f"SeparableConv_{i}",
                            SeparableConv(cin, cout, s, quant=q))
        for lvl in range(extra_levels):
            self.add_module(f"ConvBlock_{1 + 2 * lvl}",
                            ConvBlock(w * 16, w * 8, kernel=1, quant=q))
            self.add_module(f"ConvBlock_{2 + 2 * lvl}",
                            ConvBlock(w * 8, w * 16, stride=2, quant=q))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.ConvBlock_0(x)
        feats = []
        for i in range(8):
            x = getattr(self, f"SeparableConv_{i}")(x)
            if i in (3, 5, 7):
                feats.append(x)   # c3, c4, c5
        for lvl in range(self.extra_levels):
            x = getattr(self, f"ConvBlock_{1 + 2 * lvl}")(feats[-1])
            x = getattr(self, f"ConvBlock_{2 + 2 * lvl}")(x)
            feats.append(x)
        return feats

    @staticmethod
    def feature_channels(width: int, extra_levels: int) -> list[int]:
        return [width * 4, width * 8, width * 16] + [width * 16] * extra_levels
