"""XLA/flax ``"SAME"`` padding for torch convolutions.

Counterpart of ``evam_tpu/ops/depthwise.py::_same_pads``. flax pads a
stride-2 ``"SAME"`` conv asymmetrically (low = total // 2, the extra
row/column goes high), which ``torch.nn.functional.conv2d(padding=1)``
does not reproduce — so the port pads explicitly with ``F.pad``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads(in_size: int, k: int, stride: int) -> tuple[int, int, int]:
    """(pad_lo, pad_hi, out_size) matching XLA SAME-padding semantics."""
    out = -(-in_size // stride)
    pad_total = max((out - 1) * stride + k - in_size, 0)
    lo = pad_total // 2
    return lo, pad_total - lo, out


def pad_same(x: torch.Tensor, kernel_hw: tuple[int, int],
             stride: int) -> torch.Tensor:
    """Zero-pad an NCHW tensor so a VALID conv gives flax's SAME output."""
    lo_h, hi_h, _ = same_pads(x.shape[2], kernel_hw[0], stride)
    lo_w, hi_w, _ = same_pads(x.shape[3], kernel_hw[1], stride)
    if lo_h == hi_h == lo_w == hi_w == 0:
        return x
    return F.pad(x, (lo_w, hi_w, lo_h, hi_h))
