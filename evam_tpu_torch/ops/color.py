"""I420 (YUV420 planar) wire format and BT.601 colour conversion.

Counterpart of ``evam_tpu/ops/color.py``. Frames travel host→device as
I420 — ``[H*3/2, W]`` uint8 with the Y plane on top, then U (H/4 rows)
and V (H/4 rows), each an H/2 × W/2 plane — half the bytes of BGR. The
device resizes each plane and applies the studio-swing BT.601 inverse
at target resolution.

The host encoder is numpy, so the port needs no cv2 (the reference
calls cv2). It is the fixed-point BT.601 matrix of
the reference's native kernel (``native/evam_media.cpp::bgr_to_yuv``),
with chroma taken from the top-left pixel of each 2×2 block;
``tests/test_torch_ops.py`` holds it against cv2.
"""

from __future__ import annotations

import numpy as np
import torch

from evam_tpu_torch.ops.resize import resize_planes


def wire_shape(wire_format: str, height: int, width: int) -> tuple[int, ...]:
    """Per-frame host/device array shape for a wire format."""
    if wire_format == "i420":
        return i420_shape(height, width)
    if wire_format == "bgr":
        return (height, width, 3)
    raise ValueError(f"unknown wire format {wire_format!r}")


def i420_shape(height: int, width: int) -> tuple[int, int]:
    # The planar layout packs the h/2 x w/2 U and V planes as h/4
    # full-width rows each, so height must divide by 4; width by 2.
    if height % 4 or width % 2:
        raise ValueError(
            f"I420 wire layout needs height%4==0 and width%2==0, got "
            f"{height}x{width}"
        )
    return (height * 3 // 2, width)


def bgr_to_i420_host(frame: np.ndarray) -> np.ndarray:
    """Host-side BGR uint8 [H, W, 3] → I420 uint8 [H*3/2, W] (numpy)."""
    h, w = frame.shape[:2]
    i420_shape(h, w)
    px = frame.astype(np.int32)
    b, g, r = px[..., 0], px[..., 1], px[..., 2]
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    b0, g0, r0 = b[::2, ::2], g[::2, ::2], r[::2, ::2]
    u = ((-38 * r0 - 74 * g0 + 112 * b0 + 128) >> 8) + 128
    v = ((112 * r0 - 94 * g0 - 18 * b0 + 128) >> 8) + 128
    out = np.empty((h * 3 // 2, w), np.uint8)
    out[:h] = np.clip(y, 0, 255)
    quarter = h // 4
    out[h:h + quarter] = np.clip(u, 0, 255).reshape(quarter, w)
    out[h + quarter:] = np.clip(v, 0, 255).reshape(quarter, w)
    return out


def _split_planes(i420: torch.Tensor):
    """[B, H*3/2, W] uint8 → (y [B,H,W], u, v [B,H/2,W/2])."""
    b, h32, w = i420.shape
    h = (h32 * 2) // 3
    quarter = h // 4
    y = i420[:, :h, :]
    u = i420[:, h:h + quarter, :].reshape(b, h // 2, w // 2)
    v = i420[:, h + quarter:, :].reshape(b, h // 2, w // 2)
    return y, u, v


def _bt601(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Studio-swing BT.601 inverse on float planes → BGR stack [..., 3]."""
    yy = 1.164 * (y - 16.0)
    uu = u - 128.0
    vv = v - 128.0
    r = yy + 1.596 * vv
    g = yy - 0.813 * vv - 0.391 * uu
    bl = yy + 2.018 * uu
    return torch.clamp(torch.stack([bl, g, r], dim=-1), 0.0, 255.0)


def i420_to_bgr(i420: torch.Tensor) -> torch.Tensor:
    """[B, H*3/2, W] uint8 → [B, H, W, 3] float32 BGR (0..255)."""
    y, u, v = _split_planes(i420)
    u = u.float().repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.float().repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return _bt601(y.float(), u, v)


def i420_resize_to_bgr(
    i420: torch.Tensor, out_hw: tuple[int, int]
) -> torch.Tensor:
    """[B, H*3/2, W] uint8 → resized [B, th, tw, 3] float32 BGR.

    Resizes each plane directly (Y at full res, U/V from half res) and
    converts colour at target resolution; linear resize and the affine
    BT.601 transform commute.
    """
    y, u, v = _split_planes(i420)
    return _bt601(resize_planes(y, out_hw), resize_planes(u, out_hw),
                  resize_planes(v, out_hw))


def crop_rois_i420(
    i420: torch.Tensor,
    boxes: torch.Tensor,
    out_size: tuple[int, int],
) -> torch.Tensor:
    """ROI crop + nearest resize straight from the i420 wire batch.

    ``i420`` [B, H*3/2, W] uint8; ``boxes`` [B, R, 4] normalized
    corners. Returns [B, R, oh, ow, 3] float32 BGR — the contract of
    ``ops/preprocess.py::crop_rois`` on a decoded frame, without
    decoding the full frame. Y is sampled at the grid; U and V at
    ``(yi // 2, xi // 2)`` of their half-resolution planes.
    """
    from evam_tpu_torch.ops.preprocess import gather_grid, roi_grid_indices

    y, u, v = _split_planes(i420)
    yi, xi = roi_grid_indices(boxes, y.shape[1:3], out_size)
    yc = gather_grid(y, yi, xi).float()
    uc = gather_grid(u, yi // 2, xi // 2).float()
    vc = gather_grid(v, yi // 2, xi // 2).float()
    return _bt601(yc, uc, vc)
