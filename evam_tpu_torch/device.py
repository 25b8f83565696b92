"""Device resolution for the port's entry points.

``evam_tpu`` picks its backend through JAX's platform list; the port
takes an explicit ``device`` argument instead. The default is the card:
a caller that wants the CPU says so (the tests pass ``device="cpu"``),
and a missing card is an error, never a silent fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``. Raises when ``cuda`` is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Serving-precision name (``PreprocessSpec.dtype``) → torch dtype."""
    table = {
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float16": torch.float16,
    }
    if name not in table:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(table)}")
    return table[name]
