"""Separable-matmul bilinear resize (counterpart of ``evam_tpu/ops/resize.py``).

Bilinear resize is a linear operator per axis, so a stack of planes
``[..., H, W]`` is resized by two matrix products against precomputed
interpolation matrices (rows, then columns). ``resize_matrix`` is the
reference's numpy statement of ``jax.image.resize(method="linear")``'s
per-axis weights (antialiased when downscaling), copied here so the port
needs nothing of ``evam_tpu``.

Numerics follow the reference: operands are rounded to ``compute_dtype``
(bf16 by default), each product accumulates in float32, and the
intermediate is rounded back to ``compute_dtype`` between the two
products. A bf16 × bf16 product is exact in float32, so running the
products in float32 over bf16-rounded operands is the same arithmetic
as a bf16 matmul with float32 accumulation (up to summation order).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] bilinear (antialiased) interpolation matrix, float32.

    Triangle kernel at half-pixel centers, widened by 1/scale when
    downscaling, rows normalized.
    """
    scale = out_size / in_size
    kernel_scale = min(scale, 1.0)  # antialias when downscaling
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    x = (sample[:, None] - np.arange(in_size, dtype=np.float64)[None, :])
    w = np.clip(1.0 - np.abs(x * kernel_scale), 0.0, 1.0)
    total = w.sum(axis=1, keepdims=True)
    return (w / np.where(total == 0.0, 1.0, total)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _matrix(in_size: int, out_size: int, compute_dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """``resize_matrix`` rounded to ``compute_dtype``, as float32 on ``device``."""
    m = torch.from_numpy(resize_matrix(in_size, out_size))
    return m.to(compute_dtype).float().to(device)


def resize_planes(
    x: torch.Tensor,
    out_hw: tuple[int, int],
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Bilinear-resize a stack of planes [..., H, W] → [..., th, tw] float32.

    Pass ``compute_dtype=torch.float32`` for the near-exact path.
    """
    th, tw = out_hw
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (th, tw):
        return x.float()
    my = _matrix(h, th, compute_dtype, x.device)  # [th, h]
    mx = _matrix(w, tw, compute_dtype, x.device)  # [tw, w]
    xc = x.to(compute_dtype).float()
    y = torch.matmul(my, xc).to(compute_dtype).float()  # [..., th, w]
    return torch.matmul(y, mx.T)                        # [..., th, tw]


def resize_nhwc(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] → [B, th, tw, C] float32, planes via channel-major."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x.float()
    z = resize_planes(x.permute(0, 3, 1, 2), out_hw)
    return z.permute(0, 2, 3, 1)
