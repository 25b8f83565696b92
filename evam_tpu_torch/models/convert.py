"""Reference (flax) parameters → the port's ``state_dict``.

The reference keeps params as a nested dict keyed by flax's module
names (``Backbone_0/SeparableConv_3/Conv_1/kernel``); the port's modules
carry the same names, so each leaf maps to one ``state_dict`` entry:

* conv kernels HWIO → OIHW (a depthwise ``[3, 3, 1, C]`` kernel becomes
  ``[C, 1, 3, 3]`` by the same transpose);
* Dense kernels ``[in, out]`` → ``[out, in]``;
* ``kernel`` → ``weight``; ``bias`` unchanged.

``params_from_msgpack`` decodes the reference's ``weights.msgpack``
(``flax.serialization.to_bytes``) with plain ``msgpack``, imported when
called: ext type 1 is ``(shape, dtype name, buffer)``, and bf16 arrives
as raw 16-bit words.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_EXT_NDARRAY = 1


def _to_tensor(arr: Any) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        # ml_dtypes / flax bf16: reinterpret the 16-bit words
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _walk(tree: dict, prefix: tuple[str, ...] = ()):
    for key, val in tree.items():
        if isinstance(val, dict):
            if "__msgpack_chunked_array__" in val:
                raise ValueError("chunked msgpack arrays are not supported")
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Nested dict of arrays (flax params) → port ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _walk(tree):
        t = _to_tensor(leaf)
        name = path[-1]
        if name == "kernel":
            if t.dim() == 4:
                t = t.permute(3, 2, 0, 1)
            elif t.dim() == 2:
                t = t.T
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
            name = "weight"
        elif name != "bias":
            raise ValueError(f"unexpected leaf {'/'.join(path)}")
        out[".".join(path[:-1] + (name,))] = t.contiguous()
    return out


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code != _EXT_NDARRAY:
        raise ValueError(f"unexpected msgpack ext type {code} in a params tree")
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        words = np.frombuffer(buf, np.int16).reshape(shape).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


def params_from_msgpack(data: bytes) -> dict[str, torch.Tensor]:
    """flax ``serialization.to_bytes(params)`` bytes → port ``state_dict``."""
    import msgpack

    return params_from_jax(
        msgpack.unpackb(data, ext_hook=_ext_hook, raw=False))
