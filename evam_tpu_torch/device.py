"""Device resolution for the port's entry points.

``evam_tpu`` picks its backend through JAX's platform list; the port
takes an explicit ``device`` argument instead. The default is the card:
a caller that wants the CPU says so (the tests pass ``device="cpu"``),
and a missing card is an error, never a silent fallback.
"""

from __future__ import annotations

import math

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


def same_device(a: str | torch.device, b: str | torch.device) -> bool:
    """Whether two names mean one device (``cuda`` is ``cuda:0``, the
    default device)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def mesh_devices(device: str | torch.device, shape=(-1,),
                 axes=("data",), count: int | None = None
                 ) -> list[torch.device]:
    """The hub's device list from the reference's ``tpu.mesh_shape`` and
    ``tpu.mesh_axes``, sized and checked as ``evam_tpu/parallel/mesh.py::
    build_mesh`` sizes and checks them over ``count`` devices (default:
    the visible CUDA devices; the CPU is one device). One shape entry may
    be -1. The batch splits over ``data`` only: one entry per data
    shard, the first device of its row; a ``model`` axis replicates the
    models over the rest of the row (the serving zoo has no tensor
    parallelism to use it)."""
    shape, axes = list(shape), list(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if set(axes) - {"data", "model"}:
        raise ValueError(f"mesh axes {axes}: serving shards the data axis "
                         "and replicates over the model axis only")
    dev = resolve_device(device)
    n = count if count is not None else (
        torch.cuda.device_count() if dev.type == "cuda" else 1)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1) if len(shape) > 1 \
            else 1
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        shape[shape.index(-1)] = n // known
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    sizes = dict(zip(axes, shape))
    data, model = sizes.get("data", 1), sizes.get("model", 1)
    if dev.type == "cpu":
        return [dev] * data
    return [torch.device("cuda", i * model) for i in range(data)]
