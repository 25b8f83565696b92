"""Batched image preprocessing (counterpart of ``evam_tpu/ops/preprocess.py``).

Wire-encoded uint8 frames → model input, on the device, in one pass of
torch ops: the i420 + stretch fast path resizes planes before colour
conversion (``ops/color.py``). ROI crops for secondary classification
(``crop_rois``, and ``ops/color.py::crop_rois_i420`` on the wire
planes) sample the grid of :func:`roi_grid_indices`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from evam_tpu_torch.device import torch_dtype
from evam_tpu_torch.ops.color import i420_resize_to_bgr, i420_to_bgr
from evam_tpu_torch.ops.resize import resize_nhwc, resize_planes


@dataclasses.dataclass(frozen=True)
class PreprocessSpec:
    """Static preprocessing description."""

    height: int
    width: int
    #: "RGB" or "BGR" — channel order the model expects (sources
    #: decode to BGR)
    color_space: str = "RGB"
    #: "stretch" | "aspect-ratio" (letterbox) | "central-crop"
    resize: str = "stretch"
    #: per-channel scale/shift applied as (x - mean) / std
    mean: tuple[float, float, float] = (0.0, 0.0, 0.0)
    std: tuple[float, float, float] = (1.0, 1.0, 1.0)
    #: if True keep 0..255 range instead of 0..1
    raw_range: bool = True
    dtype: str = "bfloat16"
    #: host→device wire format: "bgr" ([B,H,W,3]) or "i420" ([B,H*3/2,W])
    wire_format: str = "bgr"


def preprocess_wire(frames: torch.Tensor, spec: PreprocessSpec) -> torch.Tensor:
    """Wire-encoded uint8 batch → model input [B, h, w, 3] in ``spec.dtype``."""
    if spec.wire_format == "i420" and spec.resize == "stretch":
        x = i420_resize_to_bgr(frames, (spec.height, spec.width))
        return _finalize(x, spec)
    return preprocess_bgr(decode_wire(frames, spec.wire_format), spec)


def decode_wire(frames: torch.Tensor, wire_format: str) -> torch.Tensor:
    """Wire-encoded uint8 batch → float32 BGR [B, H, W, 3]."""
    if wire_format == "i420":
        return i420_to_bgr(frames)
    return frames.float()


def _resize_linear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (b, *out_hw, c), method="linear")``: the
    same antialiased weights (``resize_matrix``), in float32."""
    z = resize_planes(x.permute(0, 3, 1, 2), out_hw, torch.float32)
    return z.permute(0, 2, 3, 1)


def preprocess_bgr(x: torch.Tensor, spec: PreprocessSpec) -> torch.Tensor:
    """float32 BGR [B, H, W, 3] → model input per *spec*: ``stretch``
    (bf16 plane resize), ``aspect-ratio`` (letterbox: scale to fit,
    zero-pad centred) or ``central-crop`` (scale to cover, crop the
    centre), the last two in float32 as the reference's
    ``jax.image.resize``."""
    h, w = x.shape[1], x.shape[2]
    th, tw = spec.height, spec.width
    if spec.resize == "stretch" or (h, w) == (th, tw):
        if (h, w) != (th, tw):
            x = resize_nhwc(x, (th, tw))
    elif spec.resize == "aspect-ratio":
        scale = min(th / h, tw / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        x = _resize_linear(x, (nh, nw))
        pad_h, pad_w = th - nh, tw - nw
        x = F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                      pad_h // 2, pad_h - pad_h // 2))
    elif spec.resize == "central-crop":
        scale = max(th / h, tw / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        x = _resize_linear(x, (nh, nw))
        y0, x0 = (nh - th) // 2, (nw - tw) // 2
        x = x[:, y0:y0 + th, x0:x0 + tw]
    else:
        raise ValueError(f"unknown resize mode {spec.resize!r}")
    return _finalize(x, spec)


@functools.lru_cache(maxsize=64)
def _channel_constant(values: tuple[float, float, float], dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """A per-channel mean or std as a tensor on ``device``, built once:
    building it per call would be a host→device copy, which a stream
    being captured into a CUDA graph refuses."""
    return torch.tensor(values, dtype=dtype, device=device)


def prepare_constants(spec: PreprocessSpec, device: torch.device) -> None:
    """Build ``spec``'s constants on ``device`` ahead of the first step
    (the step builders call it)."""
    for values in (spec.mean, spec.std):
        _channel_constant(tuple(values), torch.float32, torch.device(device))


def _finalize(x: torch.Tensor, spec: PreprocessSpec) -> torch.Tensor:
    """Channel flip + range/mean/std + dtype — everything after resize."""
    if spec.color_space.upper() == "RGB":
        x = x.flip(-1)  # BGR (decode convention) → RGB
    if not spec.raw_range:
        x = x / 255.0
    if spec.mean != (0.0, 0.0, 0.0):
        x = x - _channel_constant(tuple(spec.mean), x.dtype, x.device)
    if spec.std != (1.0, 1.0, 1.0):
        x = x / _channel_constant(tuple(spec.std), x.dtype, x.device)
    return x.to(torch_dtype(spec.dtype))


def _unit_grid(n: int, device: torch.device) -> torch.Tensor:
    """``jnp.linspace(0.0, 1.0, n)`` bit for bit: XLA computes
    ``iota / (n - 1)`` as a product with the float32 reciprocal and
    appends the endpoint; ``torch.linspace`` rounds otherwise (one ulp
    at some entries, enough to flip a ``round`` at .5)."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    recip = float(np.float32(1.0) / np.float32(n - 1))
    lin = torch.arange(n - 1, dtype=torch.float32, device=device) * recip
    return torch.cat([lin, torch.ones(1, dtype=torch.float32, device=device)])


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The product of two float32 values is exact in float64; the float64
    sum carries its rounding error ``e`` exactly (Knuth's two-sum).
    Rounding the float64 sum to float32 is then the single rounding of
    the exact value, except where the sum falls on a float32 midpoint
    and ``e`` is not 0: there the exact value lies on ``e``'s side.
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    t = s - p
    e = (p - (s - t)) + (cd - t)
    r = s.float()
    toward = torch.nextafter(r, torch.where(s > r.double(), r + 1, r - 1)
                             .to(torch.float32))
    mid = (r.double() + toward.double()) * 0.5 == s
    up = torch.where(toward > r, toward, r)
    down = torch.where(toward > r, r, toward)
    fixed = torch.where(e > 0, up, down)
    return torch.where(mid & (e != 0), fixed, r)


def roi_grid_indices(
    boxes: torch.Tensor,
    frame_hw: tuple[int, int],
    out_size: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-sample row/column indices of an oh × ow grid inside
    normalized (x0, y0, x1, y1) boxes [..., 4] → (yi [..., oh],
    xi [..., ow]) int64 — the box → pixel contract shared by
    :func:`crop_rois` and ``ops/color.py::crop_rois_i420``.

    Positions are ``y0·(h−1) + (y1−y0)·(h−1)·lin`` in float32, rounded
    half to even. The reference's jitted steps compute the last
    multiply and add as one fused multiply-add (XLA on the CPU
    contracts them); so does this function, exactly, on every device:
    one rounding there can move a position across .5.
    """
    h, w = frame_hw
    oh, ow = out_size
    boxes = boxes.float()
    x0, y0, x1, y1 = (boxes[..., i:i + 1] for i in range(4))
    ys = _fma32((y1 - y0) * (h - 1), _unit_grid(oh, boxes.device), y0 * (h - 1))
    xs = _fma32((x1 - x0) * (w - 1), _unit_grid(ow, boxes.device), x0 * (w - 1))
    # float → int32 truncates (exact after the round), then the clip
    yi = torch.clamp(torch.round(ys).to(torch.int32), 0, h - 1)
    xi = torch.clamp(torch.round(xs).to(torch.int32), 0, w - 1)
    return yi.long(), xi.long()


def gather_grid(planes: torch.Tensor, yi: torch.Tensor,
                xi: torch.Tensor) -> torch.Tensor:
    """planes [B, H, W, ...] sampled at the grids yi [B, R, oh], xi
    [B, R, ow] → [B, R, oh, ow, ...]."""
    b = torch.arange(planes.shape[0], device=planes.device)[:, None, None, None]
    return planes[b, yi[..., :, None], xi[..., None, :]]


def crop_rois(
    frames: torch.Tensor,
    boxes: torch.Tensor,
    out_size: tuple[int, int],
) -> torch.Tensor:
    """Batched ROI crop + nearest resize for secondary classification.

    ``frames`` uint8/float [B, H, W, 3]; ``boxes`` [B, R, 4] normalized
    (x0, y0, x1, y1). Returns [B, R, oh, ow, 3] float32.
    """
    yi, xi = roi_grid_indices(boxes, frames.shape[1:3], out_size)
    return gather_grid(frames, yi, xi).float()
