"""Reference (flax) parameters ↔ the port's ``state_dict``.

The reference keeps params as a nested dict keyed by flax's module
names (``Backbone_0/SeparableConv_3/Conv_1/kernel``); the port's modules
carry the same names, so each leaf maps to one ``state_dict`` entry:

* conv kernels HWIO → OIHW (a depthwise ``[3, 3, 1, C]`` kernel becomes
  ``[C, 1, 3, 3]``, AclNet's ``[1, 9, I, O]`` becomes ``[O, I, 1, 9]``,
  by the same transpose);
* Dense kernels ``[in, out]`` → ``[out, in]``;
* attention projections keep flax's ``DenseGeneral`` layout: query, key
  and value kernels ``[D, H, hd]`` with biases ``[H, hd]``, the output
  kernel ``[H, hd, D]`` (the port's attention contracts them with
  einsum, ``models/zoo/action.py``);
* ``kernel`` → ``weight``, LayerNorm ``scale`` → ``weight``; ``bias``
  and the decoder's ``pos_embed`` unchanged;
* a MoE MLP's expert tensors (``experts_up`` ``[E, D, H]``,
  ``experts_up_bias``, ``experts_down``, ``experts_down_bias``) keep
  their names and shapes (``parallel/moe.py``); its ``router`` is a
  Dense.

:func:`params_to_jax` is the inverse (a rank-1 ``weight`` is a
LayerNorm scale; ranks 2, 3 and 4 are Dense, attention and conv
kernels).

An imported OpenVINO IR keeps the reference's flat ``{layer name:
array}`` dict instead (``models/ir.py``): :func:`flat_from_msgpack`
reads it and :func:`flat_to_msgpack` writes it, as is, no renaming, no
transposes, in the dict's order (a fit's weights come sorted by name,
as ``jax.tree.map`` leaves the reference's dict), so the bytes are the
ones flax's ``to_bytes`` writes for the same dict.

``weights.msgpack`` is flax's ``serialization.to_bytes`` of that tree.
:func:`unpackb` and :func:`packb` read and write the subset of msgpack
it uses with the standard library alone (the card's machine has no
``msgpack``): maps, str, bin, ints, floats, nil, bool, arrays, and
ext type 1 — an ndarray packed as ``(shape, dtype name, C-order
bytes)``, bfloat16 as raw 16-bit words. Anything else raises.
:func:`packb` chooses each encoding as ``msgpack.packb`` does, so
:func:`params_to_msgpack` writes the bytes flax writes for the same
tree.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY = 1

#: torch dtypes a weights file may hold, by numpy dtype name
_TORCH_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


# ---------------------------------------------------------- msgpack


def _array_from_ext(shape: list[int], name: str, buf: bytes):
    """Ext type 1 payload → numpy array (torch tensor for bfloat16,
    which numpy lacks without ml_dtypes)."""
    if name == "bfloat16":
        words = np.frombuffer(buf, np.int16).reshape(shape).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unexpected array dtype {name!r} in a params tree")
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return self.take(self.unpack(sized[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.take(self.unpack(strs[b])).decode()
        containers = {0xDC: (">H", self.array), 0xDD: (">I", self.array),
                      0xDE: (">H", self.map), 0xDF: (">I", self.map)}
        if b in containers:
            fmt, read = containers[b]
            return read(self.unpack(fmt))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self.ext(self.unpack(ext[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(
                f"unexpected msgpack ext type {code} in a params tree")
        inner = _Reader(data)
        shape, name, buf = inner.obj()
        if inner.pos != len(data):
            raise ValueError("trailing bytes in an ndarray ext payload")
        return _array_from_ext(shape, name, buf)


def unpackb(data: bytes) -> Any:
    """msgpack bytes (the subset flax writes) → Python objects; ext
    type 1 arrays → numpy arrays (torch tensors for bfloat16)."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _head(n: int, fix: tuple[int, int] | None, codes: tuple[int, ...]) -> bytes:
    """Type byte(s) and length of a container, str, bin or ext of
    length ``n``: the fix form below its limit, else the smallest of
    the 8-, 16- and 32-bit forms ``codes`` offers (None: no 8-bit)."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xD0, ">b", 0x80), (0xD1, ">h", 0x8000),
                                 (0xD2, ">i", 0x80000000),
                                 (0xD3, ">q", 0x8000000000000000)):
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _leaf_payload(x) -> bytes:
    """An array leaf → the ext type 1 payload flax writes:
    ``packb((shape, dtype name, C-order bytes))``."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = _DTYPE_NAMES[t.dtype]
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        shape, buf = tuple(t.shape), raw.numpy().tobytes()
    else:
        a = np.asarray(x)
        shape, name, buf = a.shape, a.dtype.name, a.tobytes("C")
    return packb([list(shape), name, buf])


def packb(obj: Any) -> bytes:
    """Python objects (dict, list/tuple, str, bytes, int, float, bool,
    None) and array leaves (numpy arrays, torch tensors) → msgpack
    bytes, each encoding chosen as ``msgpack.packb`` chooses it; an
    array is ext type 1, as flax packs it."""
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return _int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode()
        return _head(len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(obj, bytes):
        return _head(len(obj), None, (0xC4, 0xC5, 0xC6)) + obj
    if isinstance(obj, dict):
        return _head(len(obj), (0x80, 16), (None, 0xDE, 0xDF)) + b"".join(
            packb(k) + packb(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return _head(len(obj), (0x90, 16), (None, 0xDC, 0xDD)) + b"".join(
            packb(v) for v in obj)
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        data = _leaf_payload(obj)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        head = (bytes([fixext[len(data)]]) if len(data) in fixext
                else _head(len(data), None, (0xC7, 0xC8, 0xC9)))
        return head + struct.pack(">b", _EXT_NDARRAY) + data
    raise TypeError(f"cannot pack {type(obj).__name__} into a params tree")


# ------------------------------------------------------- the mapping

#: leaves that keep their flax name and layout (the MoE experts)
AS_IS = ("pos_embed", "experts_up", "experts_up_bias", "experts_down",
         "experts_down_bias")


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
        where = "/".join(path)
        if not isinstance(leaf, (np.ndarray, torch.Tensor)) and \
                not hasattr(leaf, "__array__"):
            raise ValueError(f"unexpected leaf {where}: "
                             f"{type(leaf).__name__}")
        t = _to_tensor(leaf)
        name = path[-1]
        if name == "kernel":
            if t.dim() == 4:
                t = t.permute(3, 2, 0, 1)
            elif t.dim() == 2:
                t = t.T
            elif t.dim() != 3:  # attention DenseGeneral: flax layout
                raise ValueError(f"unexpected kernel rank at {where}")
            name = "weight"
        elif name == "scale":
            if t.dim() != 1:
                raise ValueError(f"unexpected scale rank at {where}")
            name = "weight"
        elif name != "bias" and name not in AS_IS:
            raise ValueError(f"unexpected leaf {where}")
        out[".".join(path[:-1] + (name,))] = t.contiguous()
    return out


def params_to_jax(state: dict[str, torch.Tensor]) -> dict:
    """Port ``state_dict`` → nested dict of flax params, keys sorted at
    every level (as ``jax.tree.map`` leaves the reference's tree); leaves
    stay torch tensors on the CPU."""
    tree: dict = {}
    for key, t in state.items():
        *parents, name = key.split(".")
        t = t.detach().cpu()
        if name == "weight":
            if t.dim() == 1:
                name = "scale"
            else:
                name = "kernel"
                if t.dim() == 4:
                    t = t.permute(2, 3, 1, 0)
                elif t.dim() == 2:
                    t = t.T
                elif t.dim() != 3:
                    raise ValueError(f"unexpected weight rank at {key}")
        elif name != "bias" and name not in AS_IS:
            raise ValueError(f"unexpected state_dict entry {key}")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = t.contiguous()

    def ordered(node):
        return {k: ordered(v) if isinstance(v, dict) else v
                for k, v in sorted(node.items())}

    return ordered(tree)


def params_from_msgpack(data: bytes) -> dict[str, torch.Tensor]:
    """flax ``serialization.to_bytes(params)`` bytes → port ``state_dict``."""
    tree = unpackb(data)
    if not isinstance(tree, dict):
        raise ValueError("a weights file holds a map of parameters")
    return params_from_jax(tree)


def params_to_msgpack(state: dict[str, torch.Tensor]) -> bytes:
    """Port ``state_dict`` → the bytes flax's ``to_bytes`` writes for the
    same params tree."""
    return packb(params_to_jax(state))


def flat_from_msgpack(data: bytes) -> dict[str, torch.Tensor]:
    """A flat ``{name: array}`` weights file (an IR model's, as flax's
    ``to_bytes`` writes it) → tensors, in the file's order. Anything
    else — a nested zoo tree, a non-array leaf — raises ValueError."""
    tree = unpackb(data)
    if not isinstance(tree, dict):
        raise ValueError("a weights file holds a map of parameters")
    out = {}
    for key, leaf in tree.items():
        if not isinstance(leaf, (np.ndarray, torch.Tensor)):
            raise ValueError(f"not a flat weight dict: {key!r} holds a "
                             f"{type(leaf).__name__}")
        out[key] = _to_tensor(leaf).contiguous()
    return out


def flat_to_msgpack(flat: dict[str, torch.Tensor]) -> bytes:
    """A flat ``{name: tensor}`` weight dict (an IR model's) → the bytes
    flax's ``to_bytes`` writes for the same dict: one map, the entries in
    the dict's order, each an ndarray ext of its C-order bytes. A key
    that is not a string or a leaf that is not an array raises
    ValueError."""
    for key, leaf in flat.items():
        if not isinstance(key, str) or not isinstance(
                leaf, (np.ndarray, torch.Tensor)):
            raise ValueError(f"not a flat weight dict: {key!r} holds a "
                             f"{type(leaf).__name__}")
    return packb(dict(flat))
