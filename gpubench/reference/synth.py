"""The device-synth wire recipe, restated in plain int64 torch.

A served frame is one uint32 seed; its I420 wire bytes are, for byte
``j`` of the flattened ``[H*3/2, W]`` frame::

    mix  = seed · 0x9E3779B9                       mod 2³²
    byte = (((j · 2654435761) mod 2³² + mix) mod 2³²) >> 13   mod 256

(the Weyl sequence the serving engine's generator documents). Every
product stays under 2⁶³: 32-bit constants are split in 16-bit halves.
"""

from __future__ import annotations

import math

import torch

WEYL = 2654435761
MIX = 0x9E3779B9
M32 = 0xFFFFFFFF


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a · c mod 2³² for int64 ``a`` in [0, 2³²) and a 32-bit ``c``."""
    lo = (a * (c & 0xFFFF)) & M32
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def wire_bytes(seeds: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """int64 seeds [B] in [0, 2³²) → uint8 wire frames [B, *shape]."""
    n = math.prod(shape)
    mix = mul32(seeds.to(torch.int64) & M32, MIX)
    j = torch.arange(n, dtype=torch.int64, device=seeds.device)
    bits = ((j * WEYL) & M32)[None, :] + mix[:, None]
    out = ((bits & M32) >> 13) & 0xFF
    return out.to(torch.uint8).reshape((seeds.shape[0],) + tuple(shape))
