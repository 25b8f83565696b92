"""Batched image preprocessing (counterpart of ``evam_tpu/ops/preprocess.py``).

Wire-encoded uint8 frames → model input, on the device, in one pass of
torch ops: the i420 + stretch fast path resizes planes before colour
conversion (``ops/color.py``). The letterbox (``aspect-ratio``) and
``central-crop`` resize modes come in a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from evam_tpu_torch.device import torch_dtype
from evam_tpu_torch.ops.color import i420_resize_to_bgr, i420_to_bgr
from evam_tpu_torch.ops.resize import resize_nhwc


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


def preprocess_bgr(x: torch.Tensor, spec: PreprocessSpec) -> torch.Tensor:
    """float32 BGR [B, H, W, 3] → model input per *spec* (stretch only)."""
    h, w = x.shape[1], x.shape[2]
    th, tw = spec.height, spec.width
    if spec.resize == "stretch" or (h, w) == (th, tw):
        if (h, w) != (th, tw):
            x = resize_nhwc(x, (th, tw))
        return _finalize(x, spec)
    if spec.resize in ("aspect-ratio", "central-crop"):
        raise NotImplementedError(
            f"resize mode {spec.resize!r} comes with a later port slice "
            "(ROADMAP.md, slice 3: detect+classify)")
    raise ValueError(f"unknown resize mode {spec.resize!r}")


def _finalize(x: torch.Tensor, spec: PreprocessSpec) -> torch.Tensor:
    """Channel flip + range/mean/std + dtype — everything after resize."""
    if spec.color_space.upper() == "RGB":
        x = x.flip(-1)  # BGR (decode convention) → RGB
    if not spec.raw_range:
        x = x / 255.0
    if spec.mean != (0.0, 0.0, 0.0):
        x = x - torch.tensor(spec.mean, dtype=x.dtype, device=x.device)
    if spec.std != (1.0, 1.0, 1.0):
        x = x / torch.tensor(spec.std, dtype=x.dtype, device=x.device)
    return x.to(torch_dtype(spec.dtype))
