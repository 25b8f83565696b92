"""I420 (YUV420 planar) wire format and BT.601 colour conversion.

Counterpart of ``evam_tpu/ops/color.py``. Frames travel host→device as
I420 — ``[H*3/2, W]`` uint8 with the Y plane on top, then U (H/4 rows)
and V (H/4 rows), each an H/2 × W/2 plane — half the bytes of BGR. The
device resizes each plane and applies the studio-swing BT.601 inverse
at target resolution.

The host encoders here (``bgr_to_i420_host``, ``resize_bgr_host``,
``resize_bgr_to_i420_host``) are numpy copies of the native library's
arithmetic (``csrc/evam_media.cpp``, a copy of the reference's
``native/evam_media.cpp``): the fixed-point BT.601 matrix of its
``bgr_to_yuv``, with chroma taken from the top-left pixel of each 2×2
block. They give its bytes exactly, so the port needs no cv2; they are
``native.py``'s path when its policy turns the library off, and the
plain reference the tests and ``chip_smoke.py`` hold the library to.
``resize_area_host`` is OpenCV's ``INTER_AREA`` downscale in numpy,
byte for byte: the accuracy harness shrinks its 1080p training scenes
with it, where the reference calls ``cv2.resize``.
"""

from __future__ import annotations

import math

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


def resize_bgr_host(frame: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear BGR uint8 resize on the host, in the float32 arithmetic
    of the reference's native ``resize_bgr`` (``native/evam_media.cpp``:
    half-pixel centers, edge clamped, truncation after adding 0.5), so
    frames from streams of other sizes stack into one batch."""
    sh, sw = frame.shape[:2]
    if (sh, sw) == (h, w):
        return frame
    f32 = np.float32

    def taps(n_out, n_in):
        pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * (f32(n_in) / f32(n_out)) \
            - f32(0.5)
        i0 = np.maximum(pos.astype(np.int64), 0)  # C's truncation, then the clamp
        wt = np.maximum(pos - i0.astype(f32), f32(0))
        return i0, np.minimum(i0 + 1, n_in - 1), wt

    y0, y1, wy = taps(h, sh)
    x0, x1, wx = taps(w, sw)
    wy, wx = wy[:, None, None], wx[None, :, None]
    one = f32(1)
    r0, r1 = frame[y0], frame[y1]  # gather the rows before widening
    out = ((one - wy) * (one - wx) * r0[:, x0].astype(f32)
           + (one - wy) * wx * r0[:, x1].astype(f32)
           + wy * (one - wx) * r1[:, x0].astype(f32)
           + wy * wx * r1[:, x1].astype(f32) + f32(0.5))
    return out.astype(np.uint8)


def _area_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``computeResizeAreaTab`` for one axis, as dense tables
    (source index [L, n_out], float32 weight [L, n_out]): column ``d``
    lists the source pixels that cover output pixel ``d`` in the order
    OpenCV adds them (a partial pixel first, the whole ones, a partial
    one last); shorter runs pad with weight 0, which adds an exact 0."""
    scale = 1.0 / (n_out / n_in)  # OpenCV's scale, as it computes it
    runs = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(math.floor(f2), n_in - 1)
        s1 = min(math.ceil(f1), s2)
        run = []
        if s1 - f1 > 1e-3:
            run.append((s1 - 1, (s1 - f1) / cell))
        run += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            run.append((s2, min(f2 - s2, 1.0, cell) / cell))
        runs.append(run)
    src = np.zeros((max(map(len, runs)), n_out), np.int64)
    wt = np.zeros(src.shape, np.float32)  # each weight rounded once
    for d, run in enumerate(runs):
        for j, (s, a) in enumerate(run):
            src[j, d], wt[j, d] = s, a
    return src, wt


def resize_area_host(frame: np.ndarray, h: int, w: int) -> np.ndarray:
    """Area-average uint8 downscale on the host: ``cv2.resize(frame,
    (w, h), interpolation=cv2.INTER_AREA)``, byte for byte, for
    ``frame`` [H, W] or [H, W, C] with h ≤ H and w ≤ W.

    Integer ratios take OpenCV's fast path: block sums, then ``(sum +
    2) >> 2`` for 2×2 blocks of 1, 3 or 4 channels, else the sum times
    the float32 reciprocal of the block's area, rounded half to even.
    Other ratios take its general path in its float32 arithmetic: each
    source row's weighted sum over the columns (one rounding per
    product and per add, in OpenCV's order), then each output row's
    weighted sum of those rows, rounded half to even and clipped."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8 or frame.ndim not in (2, 3):
        raise ValueError(f"resize_area_host takes uint8 [H, W(, C)], got "
                         f"{frame.dtype} {frame.shape}")
    sh, sw = frame.shape[:2]
    if not (0 < h <= sh and 0 < w <= sw):
        raise ValueError(f"resize_area_host only shrinks: {sh}x{sw} → {h}x{w}")
    if (sh, sw) == (h, w):
        return frame.copy()
    x = frame if frame.ndim == 3 else frame[..., None]
    sx, sy = 1.0 / (w / sw), 1.0 / (h / sh)
    if sx == round(sx) and sy == round(sy):
        ky, kx = int(sy), int(sx)
        sums = x.reshape(h, ky, w, kx, -1).sum((1, 3), dtype=np.int32)
        if ky == kx == 2 and x.shape[2] in (1, 3, 4):
            out = (sums + 2) >> 2
        else:
            out = np.rint(sums.astype(np.float32)
                          * np.float32(1.0 / (ky * kx)))
    else:
        src, wt = _area_taps(sw, w)
        cols = np.ascontiguousarray(x.swapaxes(0, 1))  # [W, H, C]
        rows = np.zeros((w,) + cols.shape[1:], np.float32)
        for s, a in zip(src, wt):
            rows += cols[s] * a[:, None, None]
        rows = np.ascontiguousarray(rows.swapaxes(0, 1))  # [H, w, C]
        src, wt = _area_taps(sh, h)
        out = np.zeros((h,) + rows.shape[1:], np.float32)
        for s, a in zip(src, wt):
            out += rows[s] * a[:, None, None]
        out = np.rint(out)
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out if frame.ndim == 3 else out[..., 0]


def resize_bgr_to_i420_host(frame: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize and I420 encode on the host, in the 8-bit fixed
    point of the reference's native fused ``resize_bgr_to_i420``
    (``native/evam_media.cpp``), so the port's wire bytes equal the
    reference's on its default path (a host of 4 or more cores with the
    native library; its cv2 fallback rounds differently)."""
    sh, sw = frame.shape[:2]
    if (sh, sw) == (h, w):
        return bgr_to_i420_host(frame)  # the kernel's taps are the identity

    def taps(n_out, n_in):
        step = (n_in << 16) // n_out
        pos = np.maximum(np.arange(n_out, dtype=np.int64) * step
                         + (step >> 1) - (1 << 15), 0)
        i0 = pos >> 16
        return i0, np.minimum(i0 + 1, n_in - 1), (pos >> 8) & 0xFF

    def lerp(a, b, wt):
        return a + (((b - a) * wt) >> 8)

    y0, y1, wy = taps(h, sh)
    x0, x1, wx = taps(w, sw)
    wx = wx[None, :, None]
    i32 = np.int32
    r0, r1 = frame[y0], frame[y1]  # gather the rows before widening
    top = lerp(r0[:, x0].astype(i32), r0[:, x1].astype(i32), wx)
    bottom = lerp(r1[:, x0].astype(i32), r1[:, x1].astype(i32), wx)
    return bgr_to_i420_host(lerp(top, bottom, wy[:, None, None]))


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
