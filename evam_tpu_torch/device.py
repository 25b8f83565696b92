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


def same_device(a: str | torch.device, b: str | torch.device) -> bool:
    """Whether two names mean one device (``cuda`` is ``cuda:0``, the
    default device)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def mesh_devices(device: str | torch.device, shape=(-1,),
                 axes=("data",)) -> list[torch.device]:
    """The hub's device list from the reference's ``tpu.mesh_shape`` and
    ``tpu.mesh_axes`` (``evam_tpu/parallel/mesh.py::build_mesh``): a
    data mesh over the visible devices of ``device``'s type, one entry
    per device. ``[-1]`` takes every visible CUDA device (the CPU counts
    as one device); ``[n]`` the first n (on the CPU, n entries of one
    device). A ``model`` axis wider than 1 is tensor parallelism, which
    comes with a later slice."""
    from evam_tpu_torch import slices

    shape, axes = list(shape), list(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if shape.count(-1) > 1:
        raise ValueError(f"mesh shape {shape} has more than one -1")
    sizes = dict(zip(axes, shape))
    if sizes.pop("model", 1) not in (1, -1) or set(sizes) - {"data"}:
        raise NotImplementedError(
            f"mesh axes {dict(zip(axes, shape))}: a model axis comes with "
            f"{slices.PARALLEL}; the port shards the data axis only")
    dev = resolve_device(device)
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = sizes.get("data", 1)
    if n == -1:
        n = visible
    if dev.type == "cuda":
        if n > visible:
            raise ValueError(f"mesh shape {shape} needs {n} CUDA devices, "
                             f"{visible} visible")
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n
