"""Shift-and-add depthwise convolution (counterpart of ``evam_tpu/ops/depthwise.py``).

A k×k depthwise conv is k² shifted elementwise multiply-adds:

    out[b, c, i, j] = sum_{dy,dx} x_pad[b, c, s*i+dy, s*j+dx] * k[c, dy, dx]

Each tap is a strided slice of the padded input scaled by a
per-channel weight and accumulated in float32; the result is cast back
to the input's dtype, as in the reference. Tensors are NCHW-shaped
(in ``torch.channels_last`` memory on the serving path); the kernel is
``[C, kh, kw]``, the IR GroupConvolution weight ``[G, 1, 1, kh, kw]``
or a zoo ``Conv`` weight ``[C, 1, kh, kw]`` squeezed.

``EVAM_DWCONV=shift`` selects it (read when a module is built, as the
reference reads it when it traces); anything else keeps the grouped
convolution (``lax``, the default). It is an A/B variant on the card:
the default stays the grouped convolution.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from evam_tpu_torch.ops.padding import same_pads


def depthwise_shift_nchw(
    x: torch.Tensor,
    kernel: torch.Tensor,
    strides: tuple[int, int],
    padding: tuple[tuple[int, int], tuple[int, int]],
) -> torch.Tensor:
    """Shift-and-add depthwise conv, explicit padding.

    ``x``: [B, C, H, W]; ``kernel``: [C, kh, kw]. Float32 accumulation.
    """
    c = x.shape[1]
    kc, kh, kw = kernel.shape
    if kc != c:
        raise ValueError(
            f"kernel {tuple(kernel.shape)} is not depthwise for {c} channels")
    sh, sw = strides
    (lo_h, hi_h), (lo_w, hi_w) = padding
    xp = F.pad(x, (lo_w, hi_w, lo_h, hi_h))
    out_h = (xp.shape[2] - kh) // sh + 1
    out_w = (xp.shape[3] - kw) // sw + 1
    k = kernel.float()
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            tap = xp[:, :, dy:dy + sh * (out_h - 1) + 1:sh,
                     dx:dx + sw * (out_w - 1) + 1:sw]
            term = tap.float() * k[:, dy, dx][:, None, None]
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def depthwise_conv_shift(x: torch.Tensor, kernel: torch.Tensor,
                         strides: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """flax-SAME-padded depthwise conv via shift-and-add: ``x`` [B, C, H,
    W], ``kernel`` [C, kh, kw]."""
    _, kh, kw = kernel.shape
    lo_h, hi_h, _ = same_pads(x.shape[2], kh, strides[0])
    lo_w, hi_w, _ = same_pads(x.shape[3], kw, strides[1])
    return depthwise_shift_nchw(x, kernel, strides,
                                ((lo_h, hi_h), (lo_w, hi_w)))


def use_shift_depthwise() -> bool:
    """The A/B switch, with the reference's parse: EVAM_DWCONV=lax
    (default) | shift, case-insensitive."""
    return os.environ.get("EVAM_DWCONV", "lax").lower() == "shift"
