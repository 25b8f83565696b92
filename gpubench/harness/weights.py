"""Float weights from the run's seed, made on the device.

One ``torch.Generator`` on the device draws every value of a model in a
single call; each leaf is a slice of it: a weight scaled to flax's
lecun-normal standard deviation (clipped at two of them), a bias to a
small spread. They are cast to the type they are served in, and the
same tensors go to the program (through its weights file) and, in
float32, to the reference.
"""

from __future__ import annotations

import math

import torch

#: a bias's standard deviation (weights: lecun-normal)
BIAS_STD = 0.1
#: flax's truncated-normal correction for the ±2σ cut
_TRUNC = 0.87962566103423978


def mix_seed(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed and a per-model salt
    (splitmix64's finaliser)."""
    z = (seed * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return (z ^ (z >> 31)) & (2**63 - 1)


def make(shapes: list[tuple[str, tuple[int, ...], int]], seed: int,
         salt: int, device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """``shapes``: (key, shape, fan-in) of every leaf, weights as
    ``*.weight`` and biases as ``*.bias``."""
    sizes = [math.prod(shape) for _, shape, _ in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(mix_seed(seed, salt))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for (key, shape, fan_in), n in zip(shapes, sizes):
        std = (BIAS_STD if key.endswith(".bias")
               else math.sqrt(1.0 / fan_in) / _TRUNC)
        out[key] = (flat[at:at + n] * std).reshape(shape).to(dtype)
        at += n
    return out
