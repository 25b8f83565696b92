"""OpenVINO IR importer: ``model.xml`` + ``model.bin`` → a torch module.

Counterpart of ``evam_tpu/models/ir.py``. The parser, the constant
folder and the padding rules are the reference's numpy code, copied
(the port imports nothing of the JAX package): the same ``consts``, the
same folded anchors and variances, the same layer order. The executor
is rebuilt in torch: each runtime layer becomes a plain tensor function
(``_torch_op``), and :class:`ImportedIRModel` runs them in the graph's
topological order.

* The graph is **cut at DetectionOutput** (its PriorBox branch folds to
  an anchor table at import; loc and conf become the outputs) or at
  **RegionYolo** (the raw grid maps become the outputs, with
  ``yolo_specs``); decode and NMS run in the engine step.
* Weights are the reference's flat ``{sanitized layer name: array}``
  dict: every floating constant, held as a buffer of the module
  (:attr:`ImportedIRModel.params`) so the registry casts them to the
  serving dtype, a ``weights.msgpack`` overrides them and
  ``save_weights`` writes them. Integer constants (shapes, axes,
  indices) are read at build time; where one is also data (a Gather's
  indices) it is a non-persistent buffer too. A TensorIterator body's
  constants stay the body's own, as in the reference.
* The forward is capturable into a CUDA graph: every constant is built
  once and moved with the module, shapes and static arguments are
  Python values resolved at build time, a TensorIterator is a Python
  loop over its static trip count, and nothing reads a tensor back to
  the host.
* ``EVAM_IR_LAYOUT`` keeps the reference's parse (``nhwc``, the
  default, or anything else for NCHW). The reference's NHWC pass is a
  TPU layout rewrite with equal numerics; here the logical shapes stay
  NCHW and ``nhwc`` runs the convolutions and pools whose weights are
  constants in ``torch.channels_last`` memory (their weights stored so),
  while ``nchw`` runs every one of them on contiguous tensors. Both give
  the same outputs to float rounding.
* ``EVAM_DWCONV=shift`` reaches a depthwise GroupConvolution where the
  reference's does: on the NCHW plan (``EVAM_IR_LAYOUT=nchw``, or a
  graph the NHWC pass leaves alone); the NHWC plan runs every
  convolution as a convolution.

Dtypes follow the reference's arithmetic (JAX without 64-bit types):
weights are cast to the activation's dtype where the reference casts
them, a float64 constant computes in float32, and a matrix product of
two dtypes runs in their promoted type, as ``jnp.matmul`` promotes.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from evam_tpu_torch.ops.depthwise import (
    depthwise_shift_nchw,
    use_shift_depthwise,
)

log = logging.getLogger("evam_tpu_torch.models.ir")

_ELEMENT_DTYPES = {
    "f64": np.float64,
    "f32": np.float32,
    "f16": np.float16,
    "bf16": None,  # handled specially (numpy lacks bfloat16)
    "i64": np.int64,
    "i32": np.int32,
    "i16": np.int16,
    "i8": np.int8,
    "u64": np.uint64,
    "u32": np.uint32,
    "u16": np.uint16,
    "u8": np.uint8,
    "boolean": np.bool_,
}

#: the torch dtype a Convert layer produces (JAX without 64-bit types
#: computes float64 as float32; wide unsigned types widen to int64)
_CONVERT_DTYPES = {
    "f64": torch.float32, "f32": torch.float32, "f16": torch.float16,
    "bf16": torch.bfloat16, "i64": torch.int64, "i32": torch.int32,
    "i16": torch.int16, "i8": torch.int8, "u64": torch.int64,
    "u32": torch.int64, "u16": torch.int32, "u8": torch.uint8,
    "boolean": torch.bool,
}


@dataclasses.dataclass
class IRPort:
    id: int
    shape: tuple[int, ...]


@dataclasses.dataclass
class IRLayer:
    id: int
    name: str
    type: str
    attrs: dict[str, str]
    inputs: list[IRPort]
    outputs: list[IRPort]
    #: op-specific payload (TensorIterator: body graph + port maps)
    extra: Any = None


@dataclasses.dataclass
class IRGraph:
    """Parsed topology. ``edges`` maps (to_layer, to_port) →
    (from_layer, from_port)."""

    name: str
    layers: dict[int, IRLayer]
    edges: dict[tuple[int, int], tuple[int, int]]
    consts: dict[int, np.ndarray]  # layer id → value (Const layers)

    def topo_order(self) -> list[IRLayer]:
        """Topological order via DFS from Result/output layers."""
        order: list[IRLayer] = []
        seen: set[int] = set()

        def visit(lid: int) -> None:
            if lid in seen:
                return
            seen.add(lid)
            layer = self.layers[lid]
            for port in layer.inputs:
                src = self.edges.get((lid, port.id))
                if src is not None:
                    visit(src[0])
            order.append(layer)

        for layer in self.layers.values():
            visit(layer.id)
        return order


def _parse_shape(port_el) -> tuple[int, ...]:
    return tuple(int(d.text) for d in port_el.findall("dim"))


def parse_ir(xml_path: str | Path, bin_path: str | Path | None = None) -> IRGraph:
    """Parse IR v10/v11 ``.xml`` (+ sibling ``.bin`` weights)."""
    xml_path = Path(xml_path)
    if bin_path is None:
        bin_path = xml_path.with_suffix(".bin")
    root = ET.parse(xml_path).getroot()
    version = int(root.get("version", "10"))
    if version < 10:
        raise ValueError(
            f"IR version {version} (pre-2020 opset) is not supported; "
            "re-export with a 2021+ Model Optimizer (IR v10/v11)"
        )
    blob = Path(bin_path).read_bytes() if Path(bin_path).exists() else b""

    return _parse_graph_el(root, root.get("name", xml_path.stem), blob)


def _parse_graph_el(root, name: str, blob: bytes) -> IRGraph:
    """Parse a <layers>+<edges> scope (the net, or a TI <body>)."""
    layers: dict[int, IRLayer] = {}
    consts: dict[int, np.ndarray] = {}
    for layer_el in root.find("layers").findall("layer"):
        lid = int(layer_el.get("id"))
        ltype = layer_el.get("type")
        data_el = layer_el.find("data")
        attrs = dict(data_el.attrib) if data_el is not None else {}
        inputs = []
        in_el = layer_el.find("input")
        if in_el is not None:
            for p in in_el.findall("port"):
                inputs.append(IRPort(int(p.get("id")), _parse_shape(p)))
        outputs = []
        out_el = layer_el.find("output")
        if out_el is not None:
            for p in out_el.findall("port"):
                outputs.append(IRPort(int(p.get("id")), _parse_shape(p)))
        layer = IRLayer(lid, layer_el.get("name"), ltype, attrs, inputs, outputs)
        layers[lid] = layer
        if ltype == "Const":
            consts[lid] = _read_const(layer, blob)
        elif ltype == "TensorIterator":
            layer.extra = _parse_tensor_iterator(layer_el, layer, blob)

    edges: dict[tuple[int, int], tuple[int, int]] = {}
    for e in root.find("edges").findall("edge"):
        edges[(int(e.get("to-layer")), int(e.get("to-port")))] = (
            int(e.get("from-layer")),
            int(e.get("from-port")),
        )
    return IRGraph(name, layers, edges, consts)


def _parse_tensor_iterator(layer_el, layer: IRLayer, blob: bytes) -> dict:
    """Parse a TensorIterator's <body>, <port_map> and <back_edges>.

    The OMZ recurrent decoders (e.g. action-recognition-0001-decoder)
    wrap their LSTM step in a TensorIterator that slices the time axis
    of the input, carries hidden/cell state over back-edges, and
    concatenates (or takes the last) per-step outputs.
    """
    body = _parse_graph_el(layer_el.find("body"), f"{layer.name}.body", blob)
    pm = layer_el.find("port_map")

    def _maybe(el, key):
        v = el.get(key)
        return int(v) if v is not None else None

    in_by_port = {p.id: i for i, p in enumerate(layer.inputs)}
    out_by_port = {p.id: i for i, p in enumerate(layer.outputs)}
    inputs = []
    for el in pm.findall("input"):
        part_size = _maybe(el, "part_size")
        if _maybe(el, "axis") is not None and part_size not in (None, 1):
            raise ValueError(
                f"TensorIterator {layer.name}: sliced input with "
                f"part_size={part_size} unsupported (execution takes "
                f"size-1 slices)"
            )
        inputs.append({
            "arg": in_by_port[int(el.get("external_port_id"))],
            "layer": int(el.get("internal_layer_id")),
            "axis": _maybe(el, "axis"),
            "stride": _maybe(el, "stride") or 1,
            "start": _maybe(el, "start") or 0,
            "end": _maybe(el, "end"),
        })
    outputs = []
    for el in pm.findall("output"):
        part_size = _maybe(el, "part_size")
        if _maybe(el, "axis") is not None and part_size not in (None, 1):
            raise ValueError(
                f"TensorIterator {layer.name}: concatenated output with "
                f"part_size={part_size} unsupported"
            )
        outputs.append({
            "out": out_by_port[int(el.get("external_port_id"))],
            "layer": int(el.get("internal_layer_id")),
            "axis": _maybe(el, "axis"),
            "stride": _maybe(el, "stride") or 1,
        })
    be_el = layer_el.find("back_edges")
    back_edges = [
        (int(e.get("from-layer")), int(e.get("to-layer")))
        for e in (be_el if be_el is not None else [])
    ]
    return {"body": body, "inputs": inputs, "outputs": outputs,
            "back_edges": back_edges}


def _read_const(layer: IRLayer, blob: bytes) -> np.ndarray:
    et = layer.attrs.get("element_type", "f32")
    shape = tuple(
        int(d) for d in layer.attrs.get("shape", "").split(",") if d != ""
    )
    offset = int(layer.attrs.get("offset", "0"))
    size = int(layer.attrs.get("size", "0"))
    raw = blob[offset : offset + size]
    if et == "bf16":
        # numpy has no bfloat16: widen via int16 bit-shift into f32
        u16 = np.frombuffer(raw, np.uint16)
        arr = (u16.astype(np.uint32) << 16).view(np.float32)
        return arr.reshape(shape)
    dtype = _ELEMENT_DTYPES.get(et)
    if dtype is None:
        raise ValueError(f"unsupported IR element_type {et!r} in {layer.name}")
    count = int(np.prod(shape)) if shape else 1
    if len(raw) < count * np.dtype(dtype).itemsize:
        raise ValueError(
            f"const {layer.name}: .bin too small (need "
            f"{count * np.dtype(dtype).itemsize} at {offset}, have {len(raw)})"
        )
    return np.frombuffer(raw, dtype, count=count).reshape(shape)


# --------------------------------------------------------------------------
# Constant folding (numpy) — evaluates the static shape machinery
# (ShapeOf → Gather/Concat/StridedSlice → PriorBox) so anchors become
# import-time constants and no shape ops survive into the forward.
# --------------------------------------------------------------------------


def _np_interpret(layer: IRLayer, inputs: list[np.ndarray]) -> np.ndarray | None:
    """Numpy evaluation for const-foldable layer types; None = can't."""
    t = layer.type
    a = layer.attrs
    if t == "ShapeOf":
        return np.asarray(inputs[0].shape if inputs[0].ndim else (), np.int64)
    if t == "Concat":
        return np.concatenate(inputs, axis=int(a.get("axis", "0")))
    if t == "Gather":
        axis = int(inputs[2]) if len(inputs) > 2 else 0
        return np.take(inputs[0], inputs[1].astype(np.int64), axis=axis)
    if t == "StridedSlice":
        begin, end = inputs[1].astype(int), inputs[2].astype(int)
        strides = (
            inputs[3].astype(int) if len(inputs) > 3 else np.ones_like(begin)
        )
        bm = [int(x) for x in a.get("begin_mask", "").split(",") if x != ""]
        em = [int(x) for x in a.get("end_mask", "").split(",") if x != ""]
        sl = []
        for i in range(len(begin)):
            b = None if (i < len(bm) and bm[i]) else begin[i]
            e = None if (i < len(em) and em[i]) else end[i]
            sl.append(slice(b, e, strides[i]))
        return inputs[0][tuple(sl)]
    if t in ("Unsqueeze", "Squeeze"):
        axes = inputs[1].astype(int).reshape(-1) if len(inputs) > 1 else None
        x = inputs[0]
        if t == "Unsqueeze":
            for ax in sorted(axes):
                x = np.expand_dims(x, ax)
            return x
        return np.squeeze(x, tuple(axes) if axes is not None else None)
    if t == "Reshape":
        return inputs[0].reshape(_resolve_reshape(inputs[0].shape, inputs[1]))
    if t == "Convert":
        dt = _ELEMENT_DTYPES.get(a.get("destination_type", "f32"), np.float32)
        return inputs[0].astype(dt)
    if t in ("Add", "Multiply", "Subtract", "Divide", "Power", "Maximum", "Minimum"):
        x, y = inputs
        return {
            "Add": np.add, "Multiply": np.multiply, "Subtract": np.subtract,
            "Divide": np.divide, "Power": np.power,
            "Maximum": np.maximum, "Minimum": np.minimum,
        }[t](x, y)
    if t == "Range":
        return np.arange(int(inputs[0]), int(inputs[1]), int(inputs[2]))
    if t == "PriorBox":
        return _prior_box(layer, inputs)
    if t == "PriorBoxClustered":
        return _prior_box_clustered(layer, inputs)
    return None


def _attr_floats(attrs: dict[str, str], key: str, default=()) -> list[float]:
    raw = attrs.get(key, "")
    if not raw:
        return list(default)
    return [float(x) for x in raw.split(",") if x != ""]


def _prior_box(layer: IRLayer, inputs: list[np.ndarray]) -> np.ndarray:
    """opset1 PriorBox → [2, A*4] (boxes row + variances row), corner
    coords normalized to the image — the caffe SSD convention the
    reference's DetectionOutput consumes."""
    a = layer.attrs
    fh, fw = (int(x) for x in inputs[0].reshape(-1)[-2:])
    ih, iw = (int(x) for x in inputs[1].reshape(-1)[-2:])
    min_sizes = _attr_floats(a, "min_size")
    max_sizes = _attr_floats(a, "max_size")
    ars = _attr_floats(a, "aspect_ratio")
    flip = a.get("flip", "false").lower() in ("1", "true")
    clip = a.get("clip", "false").lower() in ("1", "true")
    step = float(a.get("step", "0"))
    offset = float(a.get("offset", "0.5"))
    variances = _attr_floats(a, "variance", (0.1,)) or [0.1]
    scale_all = a.get("scale_all_sizes", "true").lower() in ("1", "true")

    full_ars = [1.0]
    for ar in ars:
        if ar not in full_ars:
            full_ars.append(ar)
        if flip and (1.0 / ar) not in full_ars:
            full_ars.append(1.0 / ar)

    step_x = step if step else iw / fw
    step_y = step if step else ih / fh
    boxes = []
    for y in range(fh):
        for x in range(fw):
            cx = (x + offset) * step_x
            cy = (y + offset) * step_y
            wh: list[tuple[float, float]] = []
            for i, ms in enumerate(min_sizes):
                wh.append((ms, ms))
                if i < len(max_sizes):
                    s = math.sqrt(ms * max_sizes[i])
                    wh.append((s, s))
                # caffe order: min, max, then aspect-ratio variants;
                # with scale_all_sizes=false only the first min_size
                # gets the AR variants
                if scale_all or i == 0:
                    for ar in full_ars:
                        if abs(ar - 1.0) < 1e-6:
                            continue
                        r = math.sqrt(ar)
                        wh.append((ms * r, ms / r))
            for w_, h_ in wh:
                boxes.append(
                    [
                        (cx - w_ / 2.0) / iw,
                        (cy - h_ / 2.0) / ih,
                        (cx + w_ / 2.0) / iw,
                        (cy + h_ / 2.0) / ih,
                    ]
                )
    out = np.asarray(boxes, np.float32).reshape(-1)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    if len(variances) == 1:
        variances = variances * 4
    var_row = np.tile(np.asarray(variances, np.float32), len(boxes))
    return np.stack([out, var_row])


def _prior_box_clustered(layer: IRLayer, inputs: list[np.ndarray]) -> np.ndarray:
    a = layer.attrs
    fh, fw = (int(x) for x in inputs[0].reshape(-1)[-2:])
    ih, iw = (int(x) for x in inputs[1].reshape(-1)[-2:])
    widths = _attr_floats(a, "width")
    heights = _attr_floats(a, "height")
    clip = a.get("clip", "false").lower() in ("1", "true")
    step = float(a.get("step", "0"))
    step_w = float(a.get("step_w", "0")) or step or iw / fw
    step_h = float(a.get("step_h", "0")) or step or ih / fh
    offset = float(a.get("offset", "0.5"))
    variances = _attr_floats(a, "variance", (0.1,)) or [0.1]
    boxes = []
    for y in range(fh):
        for x in range(fw):
            cx = (x + offset) * step_w
            cy = (y + offset) * step_h
            for w_, h_ in zip(widths, heights):
                boxes.append(
                    [
                        (cx - w_ / 2.0) / iw,
                        (cy - h_ / 2.0) / ih,
                        (cx + w_ / 2.0) / iw,
                        (cy + h_ / 2.0) / ih,
                    ]
                )
    out = np.asarray(boxes, np.float32).reshape(-1)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    if len(variances) == 1:
        variances = variances * 4
    var_row = np.tile(np.asarray(variances, np.float32), len(boxes))
    return np.stack([out, var_row])


def _resolve_reshape(in_shape: tuple[int, ...], target: np.ndarray) -> list[int]:
    """OpenVINO Reshape semantics: 0 copies the input dim (when
    special_zero), -1 infers."""
    tgt = [int(x) for x in np.asarray(target).reshape(-1)]
    out = []
    for i, d in enumerate(tgt):
        if d == 0 and i < len(in_shape):
            out.append(int(in_shape[i]))
        else:
            out.append(d)
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1]))
        total = int(np.prod(in_shape)) if in_shape else 1
        out[out.index(-1)] = total // max(known, 1)
    return out


def constant_fold(graph: IRGraph) -> None:
    """Evaluate every layer whose inputs are all constants (in numpy,
    at import time) and register it as a const. Shape chains and
    PriorBox branches collapse to anchor tables here."""
    changed = True
    while changed:
        changed = False
        for layer in graph.topo_order():
            if layer.id in graph.consts or layer.type in ("Const", "Parameter"):
                continue
            vals = []
            ok = True
            for port in layer.inputs:
                src = graph.edges.get((layer.id, port.id))
                if src is None or src[0] not in graph.consts:
                    ok = False
                    break
                vals.append(graph.consts[src[0]])
            if not ok or not layer.inputs:
                continue
            try:
                out = _np_interpret(layer, vals)
            except Exception as exc:  # noqa: BLE001 — leave to runtime
                log.debug("constfold %s (%s) failed: %s", layer.name, layer.type, exc)
                out = None
            if out is not None:
                # conform to the declared port shape (e.g. PriorBox
                # helpers return [2, N] where the IR declares
                # [1, 2, N]) so downstream folds see the right rank
                want = layer.outputs[0].shape if layer.outputs else ()
                if want and int(np.prod(out.shape)) == int(np.prod(want)):
                    out = out.reshape(want)
                graph.consts[layer.id] = out
                changed = True


def _pair(attrs: dict[str, str], key: str, default: str = "1,1") -> tuple[int, ...]:
    return tuple(int(x) for x in attrs.get(key, default).split(",") if x != "")


def _conv_padding(
    attrs: dict[str, str],
    nd: int,
    spatial: tuple[int, ...] | None = None,
    kernel: tuple[int, ...] | None = None,
    dilations: tuple[int, ...] | None = None,
    strides: tuple[int, ...] | None = None,
) -> list[tuple[int, int]]:
    auto = attrs.get("auto_pad", "explicit")
    if auto in ("same_upper", "same_lower"):
        # explicit pads: same_upper puts the odd pad row/col at the END
        # side, same_lower at the BEGIN side
        pads = []
        for d, k, dil, s in zip(spatial, kernel, dilations, strides):
            eff_k = (k - 1) * dil + 1
            out = -(-d // s)
            total = max((out - 1) * s + eff_k - d, 0)
            lo, hi = total // 2, total - total // 2
            pads.append((lo, hi) if auto == "same_upper" else (hi, lo))
        return pads
    pb = _pair(attrs, "pads_begin", ",".join(["0"] * nd))
    pe = _pair(attrs, "pads_end", ",".join(["0"] * nd))
    return list(zip(pb, pe))


def _window_padding(attrs, spatial, kernel, strides):
    auto = attrs.get("auto_pad", "explicit")
    if auto in ("same_upper", "same_lower"):
        pads = []
        for d, k, s in zip(spatial, kernel, strides):
            out = -(-d // s)
            total = max((out - 1) * s + k - d, 0)
            if auto == "same_upper":
                pads.append((total // 2, total - total // 2))
            else:
                pads.append((total - total // 2, total // 2))
        return pads
    pb = _pair(attrs, "pads_begin", ",".join(["0"] * len(kernel)))
    pe = _pair(attrs, "pads_end", ",".join(["0"] * len(kernel)))
    pads = list(zip(pb, pe))
    if attrs.get("rounding_type", "floor") == "ceil":
        # grow end-padding so ceil-mode windows fit exactly
        pads = [
            (b, e + max(0, (-(-((d + b + e - k)) // s)) * s + k - (d + b + e)))
            for (b, e), d, k, s in zip(pads, spatial, kernel, strides)
        ]
    return pads


def _sanitize(name: str) -> str:
    return name.replace("/", "_").replace(".", "_")


# --------------------------------------------------------------------------
# The op table: one plain tensor function per runtime layer
# --------------------------------------------------------------------------


def _flag(attrs: dict[str, str], key: str, default: str) -> bool:
    return attrs.get(key, default).lower() in ("1", "true")


def _ints(v) -> list[int]:
    return [int(i) for i in np.asarray(v).reshape(-1)]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as ``jnp.matmul`` promotes."""
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    return a @ b


def _torch_pad(pads: list[tuple[int, int]]) -> list[int]:
    """Per-axis (lo, hi) pairs, first axis first → ``F.pad``'s list,
    last axis first."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


def _index_pad(x: torch.Tensor, pads: list[tuple[int, int]],
               mode: str) -> torch.Tensor:
    """``jnp.pad`` in reflect, symmetric or edge mode, one axis at a
    time, through index arithmetic on the device."""
    for ax, (lo, hi) in enumerate(pads):
        if lo == 0 and hi == 0:
            continue
        n = x.shape[ax]
        idx = torch.arange(-lo, n + hi, device=x.device)
        if mode == "edge":
            idx = idx.clamp(0, n - 1)
        elif mode == "reflect":
            period = 2 * (n - 1)
            if period == 0:
                idx = torch.zeros_like(idx)
            else:
                j = torch.remainder(idx, period)
                idx = torch.where(j >= n, period - j, j)
        else:  # symmetric
            period = 2 * n
            j = torch.remainder(idx, period)
            idx = torch.where(j >= n, period - 1 - j, j)
        x = torch.index_select(x, ax, idx)
    return x


def _resize_weights(m: int, n: int, kernel: Callable) -> np.ndarray:
    """``jax.image.resize``'s [m, n] weight matrix for one axis (scale
    n / m, no translation, antialiased), computed in float32 as jax
    computes it."""
    f32 = np.float32
    scale = f32(n / m)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = kernel(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(m) - f32(0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0, 1 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@dataclasses.dataclass
class _Op:
    """A runtime layer's function and the constant tensors it needs
    beyond its inputs (appended to them as extra arguments)."""

    fn: Callable[..., Any]
    aux: list[np.ndarray] = dataclasses.field(default_factory=list)


def _static(layer: IRLayer, st: list, i: int):
    """Input ``i``'s build-time value (a shape, axes, a count). The
    reference reads these with numpy while it traces; here they must be
    constants of the graph."""
    if i >= len(st) or st[i] is None:
        raise ValueError(
            f"{layer.type} {layer.name}: input {i} must be a constant "
            "(a runtime shape argument is not supported)")
    return st[i]


def _torch_op(layer: IRLayer, st: list, fmt: torch.memory_format,
              shift_ok: bool) -> _Op:
    """The function of one runtime layer. ``st[i]`` is input ``i``'s
    value when it is a constant of the graph (None when it is computed
    at run time); ``fmt`` is the memory format convolutions and pools
    run in; ``shift_ok`` lets a depthwise GroupConvolution take the
    shift-and-add path under ``EVAM_DWCONV=shift``."""
    t = layer.type
    a = layer.attrs

    if t in ("Convolution", "GroupConvolution"):
        grouped = t == "GroupConvolution"
        shift = grouped and shift_ok and use_shift_depthwise()

        def conv(x, w):
            if grouped:
                g = w.shape[0]
                w2 = w.reshape((w.shape[0] * w.shape[1],) + tuple(w.shape[2:]))
            else:
                g, w2 = 1, w
            nd = w2.dim() - 2
            strides = _pair(a, "strides", ",".join(["1"] * nd))
            dils = _pair(a, "dilations", ",".join(["1"] * nd))
            pads = _conv_padding(a, nd, tuple(x.shape[2:]),
                                 tuple(w2.shape[2:]), dils, strides)
            if (shift and nd == 2 and w.shape[1] == 1 and w.shape[2] == 1
                    and g == x.shape[1] and dils == (1, 1)):
                # MobileNet depthwise by shift-and-add (ops/depthwise.py)
                return depthwise_shift_nchw(
                    x, w.reshape((g,) + tuple(w.shape[3:])).to(x.dtype),
                    strides, tuple(pads))
            if nd == 2:
                x = x.contiguous(memory_format=fmt)
            if any(lo != hi for lo, hi in pads):
                x = F.pad(x, _torch_pad(pads))
                padding = 0
            else:
                padding = tuple(lo for lo, _ in pads)
            conv_fn = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nd]
            return conv_fn(x, w2.to(x.dtype), None, strides, padding, dils, g)
        return _Op(conv)
    if t in ("Add", "Multiply", "Subtract", "Divide", "Power",
             "Maximum", "Minimum"):
        fn = {
            "Add": torch.add, "Multiply": torch.mul,
            "Subtract": torch.sub, "Divide": torch.true_divide,
            "Power": torch.pow, "Maximum": torch.maximum,
            "Minimum": torch.minimum,
        }[t]
        return _Op(lambda x, y: fn(x, y.to(x.dtype)))
    if t == "ReLU":
        return _Op(torch.relu)
    if t == "PReLU":
        return _Op(lambda x, slope: torch.where(x >= 0, x,
                                                x * slope.to(x.dtype)))
    if t == "Sigmoid":
        return _Op(torch.sigmoid)
    if t == "Tanh":
        return _Op(torch.tanh)
    if t == "Exp":
        return _Op(torch.exp)
    if t == "HSwish":
        return _Op(F.hardswish)
    if t == "Swish":
        return _Op(F.silu)
    if t == "Mish":
        return _Op(lambda x: x * torch.tanh(_softplus(x)))
    if t == "Elu":
        alpha = float(a.get("alpha", "1.0"))
        return _Op(lambda x: F.elu(x, alpha))
    if t == "Clamp":
        lo, hi = float(a.get("min", "0")), float(a.get("max", "6"))
        return _Op(lambda x: torch.clamp(x, lo, hi))
    if t == "SoftMax":
        axis = int(a.get("axis", "1"))
        return _Op(lambda x: torch.softmax(x, dim=axis))
    if t in ("MaxPool", "AvgPool"):
        is_max = t == "MaxPool"
        exclude = _flag(a, "exclude-pad", "true")

        def pool(x):
            k = _pair(a, "kernel")
            s = _pair(a, "strides", ",".join(["1"] * len(k)))
            pads = _window_padding(a, tuple(x.shape[2:]), k, s)
            if len(k) == 1:  # through the 2-D pools, over a unit axis
                k, s, pads = (1,) + k, (1,) + s, [(0, 0)] + pads
                x = x.unsqueeze(2)
                squeeze = True
            else:
                squeeze = False
            if len(k) == 2:
                x = x.contiguous(memory_format=fmt)
            flat = _torch_pad(pads)
            if is_max:
                xp = F.pad(x, flat, value=-math.inf) if any(flat) else x
                out = (F.max_pool2d if len(k) == 2 else F.max_pool3d)(
                    xp, k, s)
            else:
                avg = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
                xp = F.pad(x, flat) if any(flat) else x
                summed = avg(xp, k, s, divisor_override=1)
                if exclude:
                    ones = torch.ones_like(x)
                    counts = avg(F.pad(ones, flat) if any(flat) else ones,
                                 k, s, divisor_override=1)
                    out = summed / counts
                else:
                    out = summed / float(np.prod(k))
            return out.squeeze(2) if squeeze else out
        return _Op(pool)
    if t in ("ReduceMean", "ReduceMax", "ReduceSum", "ReduceMin",
             "ReduceProd", "ReduceL2", "ReduceL1"):
        keep = _flag(a, "keep_dims", "true")
        axes = tuple(_ints(_static(layer, st, 1)))

        def reduce(x, _axes):
            if not axes:  # jnp reduces over no axis: the input itself
                return x
            if t == "ReduceMean":
                return (x if x.is_floating_point() else x.float()).mean(
                    dim=axes, keepdim=keep)
            if t == "ReduceMax":
                return torch.amax(x, dim=axes, keepdim=keep)
            if t == "ReduceMin":
                return torch.amin(x, dim=axes, keepdim=keep)
            if t == "ReduceSum":
                return torch.sum(x, dim=axes, keepdim=keep)
            if t == "ReduceL1":
                return torch.sum(torch.abs(x), dim=axes, keepdim=keep)
            if t == "ReduceL2":
                return torch.sqrt(torch.sum(x * x, dim=axes, keepdim=keep))
            out = x
            for ax in sorted((d % x.dim() for d in axes), reverse=True):
                out = torch.prod(out, dim=ax, keepdim=keep)
            return out
        return _Op(reduce)
    if t == "MatMul":
        ta = _flag(a, "transpose_a", "false")
        tb = _flag(a, "transpose_b", "false")

        def matmul(x, w):
            if ta:
                x = x.transpose(-1, -2)
            w = w.to(x.dtype)
            if tb:
                w = w.transpose(-1, -2)
            return x @ w
        return _Op(matmul)
    if t == "Reshape":
        target = _static(layer, st, 1)

        def reshape(x, _tgt):
            shape = _resolve_reshape(tuple(x.shape), target)
            total, want = int(np.prod(x.shape)), int(np.prod(shape))
            if total != want and shape and want:
                # IR graphs bake batch=1 into reshape targets; the
                # engine feeds batch B — rescale the leading dim (the
                # OpenVINO runtime does the same on network reshape).
                if total % want == 0:
                    shape[0] = shape[0] * (total // want)
            return x.reshape(shape)
        return _Op(reshape)
    if t == "Squeeze":
        axes = (tuple(_ints(_static(layer, st, 1)))
                if len(layer.inputs) > 1 else None)
        return _Op(lambda x, *_: torch.squeeze(x) if axes is None
                   else torch.squeeze(x, axes))
    if t == "Unsqueeze":
        axes = sorted(_ints(_static(layer, st, 1)))

        def unsqueeze(x, _axes):
            for ax in axes:
                x = torch.unsqueeze(x, ax)
            return x
        return _Op(unsqueeze)
    if t == "Transpose":
        order = _ints(_static(layer, st, 1))
        return _Op(lambda x, _order: x.permute(order))
    if t == "Concat":
        axis = int(a.get("axis", "0"))
        return _Op(lambda *xs: torch.cat(xs, dim=axis))
    if t == "Split":
        num = int(a.get("num_splits", "1"))
        axis = _ints(_static(layer, st, 1))[0]
        return _Op(lambda x, _axis: tuple(
            torch.split(x, x.shape[axis] // num, dim=axis)))
    if t == "Convert":
        dt = _CONVERT_DTYPES.get(a.get("destination_type", "f32"),
                                 torch.float32)
        return _Op(lambda x: x.to(dt))
    if t == "BatchNormInference":
        eps = float(a.get("epsilon", "1e-5"))

        def batchnorm(*inputs):
            # opset5 order: (data, gamma, beta, mean, var); opset1
            # used (gamma, beta, data, mean, var). The data tensor is
            # the only rank>1 input — bind by rank so both layouts
            # work instead of silently mis-binding.
            ranks = [i.dim() for i in inputs]
            data_idx = max(range(len(inputs)), key=lambda i: ranks[i])
            x = inputs[data_idx]
            gamma, beta, mean, var = (
                v for i, v in enumerate(inputs) if i != data_idx)
            shape = (1, -1) + (1,) * (x.dim() - 2)
            g = gamma.to(x.dtype).reshape(shape)
            b = beta.to(x.dtype).reshape(shape)
            mu = mean.to(x.dtype).reshape(shape)
            v = var.to(x.dtype).reshape(shape)
            return (x - mu) * torch.rsqrt(v + eps) * g + b
        return _Op(batchnorm)
    if t == "MVN":
        eps = float(a.get("eps", a.get("epsilon", "1e-9")))
        inside = a.get("eps_mode", "inside_sqrt") == "inside_sqrt"
        norm_var = _flag(a, "normalize_variance", "true")
        across = _flag(a, "across_channels", "false")
        axes_v = (tuple(_ints(_static(layer, st, 1)))
                  if len(layer.inputs) > 1 else None)

        def mvn(x, *_):
            ax = (tuple(range(1 if across else 2, x.dim()))
                  if axes_v is None else axes_v)
            mu = torch.mean(x, dim=ax, keepdim=True)
            out = x - mu
            if norm_var:
                var = torch.mean(out * out, dim=ax, keepdim=True)
                denom = (torch.sqrt(var + eps) if inside
                         else torch.sqrt(var) + eps)
                out = out / denom
            return out
        return _Op(mvn)
    if t == "FakeQuantize":
        levels = int(a.get("levels", "256"))

        def fake_quantize(x, in_lo, in_hi, out_lo, out_hi):
            # clamp to [in_lo, in_hi], quantize to `levels` steps,
            # rescale to [out_lo, out_hi] — executed in float
            in_lo, in_hi = in_lo.to(x.dtype), in_hi.to(x.dtype)
            out_lo, out_hi = out_lo.to(x.dtype), out_hi.to(x.dtype)
            xc = torch.minimum(torch.maximum(x, in_lo), in_hi)
            scale = (in_hi - in_lo) / (levels - 1)
            q = torch.round((xc - in_lo) / scale)
            return q * (out_hi - out_lo) / (levels - 1) + out_lo
        return _Op(fake_quantize)
    if t == "Gather":
        if int(a.get("batch_dims", "0")) != 0:
            raise ValueError(
                f"Gather with batch_dims={a['batch_dims']} "
                f"({layer.name}) is not supported — plain-axis take "
                "would silently mis-index"
            )
        axis = _ints(_static(layer, st, 2))[0] if len(layer.inputs) > 2 else 0

        def gather(x, idx, *_):
            ax = axis % x.dim()
            n = x.shape[ax]
            idx = idx.long()
            idx = torch.where(idx < 0, idx + n, idx)  # jnp.take wraps
            ok = (idx >= 0) & (idx < n)
            flat = torch.index_select(x, ax, idx.clamp(0, n - 1).reshape(-1))
            out = flat.reshape(tuple(x.shape[:ax]) + tuple(idx.shape)
                               + tuple(x.shape[ax + 1:]))
            if x.is_floating_point():
                # jnp.take fills an out-of-range index with NaN
                mask = ok.reshape((1,) * ax + tuple(idx.shape)
                                  + (1,) * (x.dim() - ax - 1))
                out = torch.where(mask, out, torch.nan)
            return out
        return _Op(gather)
    if t == "Pad":
        mode = a.get("pad_mode", "constant")
        pads = list(zip(_ints(_static(layer, st, 1)),
                        _ints(_static(layer, st, 2))))
        if mode == "constant":
            cv = (float(np.asarray(_static(layer, st, 3)).reshape(-1)[0])
                  if len(layer.inputs) > 3 else 0.0)
            return _Op(lambda x, *_: F.pad(x, _torch_pad(pads), value=cv))
        if mode not in ("reflect", "symmetric", "edge"):
            raise ValueError(f"unsupported Pad mode {mode!r}")
        return _Op(lambda x, *_: _index_pad(x, pads, mode))
    if t == "Interpolate":
        mode = a.get("mode", "nearest")
        method = {"linear": "linear", "linear_onnx": "linear",
                  "cubic": "cubic"}.get(mode, "nearest")
        in_shape = tuple(layer.inputs[0].shape)
        out_shape = tuple(layer.outputs[0].shape)
        # jax.image.resize over every axis but the batch that changes
        dims = [d for d in range(1, len(out_shape))
                if in_shape[d] != out_shape[d]]
        aux = []
        for d in dims:
            m, n = in_shape[d], out_shape[d]
            if method == "nearest":
                off = ((np.arange(n, dtype=np.float32) + np.float32(0.5))
                       * np.float32(m) / np.float32(n))
                aux.append(np.floor(off.astype(np.float32)).astype(np.int64))
            else:
                aux.append(_resize_weights(
                    m, n, _triangle if method == "linear" else _keys_cubic))
        n_in = len(layer.inputs)

        def interp(x, *rest):
            mats = rest[n_in - 1:]
            for d, mat in zip(dims, mats):
                if method == "nearest":
                    x = torch.index_select(x, d, mat)
                else:
                    x = torch.movedim(
                        torch.movedim(x, d, -1) @ mat.to(x.dtype), -1, d)
            return x
        return _Op(interp, aux)
    if t in ("Sqrt", "Log", "Abs", "Negative", "Floor", "Ceiling",
             "Erf", "HSigmoid", "SoftPlus", "Gelu", "Round", "Sign"):
        tanh_gelu = a.get("approximation_mode", "ERF").upper() == "TANH"
        fn = {
            "Sqrt": torch.sqrt, "Log": torch.log, "Abs": torch.abs,
            "Negative": torch.neg, "Floor": torch.floor,
            "Ceiling": torch.ceil, "Erf": torch.erf,
            "HSigmoid": F.hardsigmoid, "SoftPlus": _softplus,
            # OpenVINO Gelu defaults to approximation_mode=ERF
            "Gelu": lambda x: F.gelu(
                x, approximate="tanh" if tanh_gelu else "none"),
            # half_to_even (torch.round) is the spec default
            "Round": (
                torch.round
                if a.get("mode", "half_to_even") == "half_to_even"
                else (lambda x: torch.trunc(
                    x + torch.where(x >= 0, 0.5, -0.5).to(x.dtype)))
            ),
            "Sign": torch.sign,
        }[t]
        return _Op(fn)
    if t in ("Greater", "GreaterEqual", "Less", "LessEqual", "Equal",
             "NotEqual", "LogicalAnd", "LogicalOr", "LogicalXor"):
        fn = {
            "Greater": torch.gt, "GreaterEqual": torch.ge,
            "Less": torch.lt, "LessEqual": torch.le,
            "Equal": torch.eq, "NotEqual": torch.ne,
            "LogicalAnd": torch.logical_and, "LogicalOr": torch.logical_or,
            "LogicalXor": torch.logical_xor,
        }[t]
        return _Op(lambda x, y: fn(x, y))
    if t == "LogicalNot":
        return _Op(torch.logical_not)
    if t == "TopK":
        # opset3/11: inputs (data, k); outputs (values, indices). The
        # stable sort keeps the lower index first among ties, as
        # lax.top_k does (torch.topk promises no order there).
        axis = int(a.get("axis", "-1"))
        largest = a.get("mode", "max") == "max"
        idx_dt = torch.int64 if a.get("index_element_type",
                                      "i32") == "i64" else torch.int32
        by_index = a.get("sort", "value") == "index"
        k = _ints(_static(layer, st, 1))[0]

        def topk(x, _k):
            xs = torch.movedim(x, axis, -1)
            _, order = torch.sort(xs, dim=-1, descending=largest,
                                  stable=True)
            idxs = order[..., :k]
            if by_index:
                # elements ordered by ORIGINAL index, not by value
                idxs = torch.sort(idxs, dim=-1).values
            vals = torch.gather(xs, -1, idxs)
            return (torch.movedim(vals, -1, axis),
                    torch.movedim(idxs, -1, axis).to(idx_dt))
        return _Op(topk)
    if t == "ReverseSequence":
        batch_axis = int(a.get("batch_axis", "0"))
        seq_axis = int(a.get("seq_axis", "1"))

        def reverse_sequence(x, seq_lengths):
            t_len = x.shape[seq_axis]
            shape = [1] * x.dim()
            shape[seq_axis] = t_len
            pos = torch.arange(t_len, device=x.device).reshape(shape)
            lens_shape = [1] * x.dim()
            lens_shape[batch_axis] = x.shape[batch_axis]
            lens = seq_lengths.long().reshape(lens_shape)
            # per batch row: positions < len are mirrored, the tail
            # stays in place (the ONNX/OpenVINO convention)
            src = torch.where(pos < lens, lens - 1 - pos, pos)
            return torch.gather(x, seq_axis, src.expand(x.shape))
        return _Op(reverse_sequence)
    if t == "CTCGreedyDecoder":
        # opset1: logits [T, N, C], seq_mask [T, N] → [N, T, 1, 1]
        # class ids, -1 padded; optional repeated-merge
        merge = _flag(a, "ctc_merge_repeated", "true")

        def ctc_greedy(logits, seq_mask):
            t_len, n, c = logits.shape
            blank = c - 1  # OpenVINO convention: last class is blank
            best = torch.argmax(logits, dim=-1).to(torch.int32)  # [T, N]
            mask = seq_mask[:t_len].bool()
            keep = mask & (best != blank)
            if merge:
                # collapse repeats first, then drop the blanks
                prev = torch.cat([torch.full((1, n), -1, dtype=torch.int32,
                                             device=best.device), best[:-1]])
                keep = keep & (best != prev)
            # stable compaction per column: kept symbols first, -1 pad
            keep_t, best_t = keep.T, best.T
            order = torch.argsort((~keep_t).to(torch.int32), dim=1,
                                  stable=True)
            vals = torch.gather(best_t, 1, order)
            kept = torch.gather(keep_t, 1, order)
            out = torch.where(kept, vals, torch.full_like(vals, -1))
            return out.reshape(n, t_len, 1, 1).float()
        return _Op(ctc_greedy)
    if t == "HardSigmoid":
        return _Op(lambda x, alpha, beta: torch.clamp(
            x * alpha.to(x.dtype) + beta.to(x.dtype), 0.0, 1.0))
    if t == "Selu":
        return _Op(lambda x, alpha, lam: lam.to(x.dtype) * torch.where(
            x > 0, x, alpha.to(x.dtype) * (torch.exp(x) - 1)))
    if t == "Select":
        return _Op(lambda c, a_, b_: torch.where(
            c if c.dtype == torch.bool else c != 0, a_, b_.to(a_.dtype)))
    if t == "Tile":
        reps = _ints(_static(layer, st, 1))
        return _Op(lambda x, _reps: torch.tile(x, reps))
    if t == "VariadicSplit":
        ax = _ints(_static(layer, st, 1))[0]
        lens0 = _ints(_static(layer, st, 2))

        def vsplit(x, _axis, _lengths):
            lens = list(lens0)
            # -1 means "the remainder" (at most one occurrence)
            if -1 in lens:
                rest = x.shape[ax] - sum(v for v in lens if v >= 0)
                lens[lens.index(-1)] = rest
            return tuple(torch.split(x, lens, dim=ax))
        return _Op(vsplit)
    if t == "NormalizeL2":
        eps = float(a.get("eps", "1e-12"))
        add_mode = a.get("eps_mode", "add") == "add"
        axes = tuple(_ints(_static(layer, st, 1)))

        def normalize(x, _axes):
            ss = torch.sum(x * x, dim=axes, keepdim=True)
            denom = (torch.sqrt(ss + eps) if add_mode
                     else torch.sqrt(torch.clamp(ss, min=eps)))
            return x / denom
        return _Op(normalize)
    if t == "LRN":
        # across the channel axis (NCHW axis 1)
        alpha = float(a.get("alpha", "1e-4"))
        beta = float(a.get("beta", "0.75"))
        bias = float(a.get("bias", "1.0"))
        size = int(a.get("size", "5"))
        if len(layer.inputs) > 1 and _ints(_static(layer, st, 1)) != [1]:
            raise ValueError(
                f"LRN over axes {_ints(st[1])} ({layer.name}) is not "
                "supported — only across-channel (axes=[1])")

        def lrn(x, *_):
            half = size // 2
            pads = [(0, 0)] * x.dim()
            pads[1] = (half, size - 1 - half)
            sqp = F.pad(x * x, _torch_pad(pads))
            acc = sum(sqp.narrow(1, i, x.shape[1]) for i in range(size))
            return x / torch.pow(bias + (alpha / size) * acc, beta)
        return _Op(lrn)
    if t == "SpaceToDepth":
        bs = int(a.get("block_size", "2"))
        first = a.get("mode", "blocks_first") == "blocks_first"

        def s2d(x):
            b_, c, h, w = x.shape
            x = x.reshape(b_, c, h // bs, bs, w // bs, bs)
            perm = (0, 3, 5, 1, 2, 4) if first else (0, 1, 3, 5, 2, 4)
            return x.permute(perm).reshape(b_, c * bs * bs, h // bs, w // bs)
        return _Op(s2d)
    if t == "DepthToSpace":
        bs = int(a.get("block_size", "2"))
        first = a.get("mode", "blocks_first") == "blocks_first"

        def d2s(x):
            b_, c, h, w = x.shape
            co = c // (bs * bs)
            if first:
                x = x.reshape(b_, bs, bs, co, h, w).permute(0, 3, 4, 1, 5, 2)
            else:
                x = x.reshape(b_, co, bs, bs, h, w).permute(0, 1, 4, 2, 5, 3)
            return x.reshape(b_, co, h * bs, w * bs)
        return _Op(d2s)
    if t == "LSTMCell":
        def lstm_cell(x, h0, c0, w, r, b):
            # opset4 LSTMCell: W [4H, D], R [4H, H], B [4H]; gate
            # order f, i, c, o (the OpenVINO "fico" convention)
            gates = (_mm(x, w.T.to(x.dtype)) + _mm(h0, r.T.to(x.dtype)))
            gates = gates + b.to(x.dtype)
            f, i, c_, o = torch.chunk(gates, 4, dim=-1)
            c1 = torch.sigmoid(f) * c0 + torch.sigmoid(i) * torch.tanh(c_)
            h1 = torch.sigmoid(o) * torch.tanh(c1)
            return h1, c1
        return _Op(lstm_cell)
    if t == "GRUCell":
        if _flag(a, "linear_before_reset", "false"):
            raise ValueError(
                f"GRUCell {layer.name}: linear_before_reset=1 (4H bias "
                "with a separate Rb term) is not supported")

        def gru_cell(x, h0, w, r, b):
            # opset3 GRUCell, gate order z, r, h; linear_before_reset=0
            wz, wr, wh = torch.chunk(w.to(x.dtype), 3, dim=0)
            rz, rr, rh = torch.chunk(r.to(x.dtype), 3, dim=0)
            bz, br_, bh = torch.chunk(b.to(x.dtype), 3, dim=-1)
            z = torch.sigmoid(_mm(x, wz.T) + _mm(h0, rz.T) + bz)
            rg = torch.sigmoid(_mm(x, wr.T) + _mm(h0, rr.T) + br_)
            hh = torch.tanh(_mm(x, wh.T) + _mm(rg * h0, rh.T) + bh)
            return (1 - z) * hh + z * h0
        return _Op(gru_cell)
    raise ValueError(
        f"IR layer type {t!r} ({layer.name}) is not supported by the "
        "importer; supported types cover the OMZ CNN opset"
    )


# --------------------------------------------------------------------------
# Execution plan
# --------------------------------------------------------------------------

#: an input of a step: ("v", (layer, port)) a value computed in the
#: plan, ("p", name) a weight, ("a", key) another constant tensor
Ref = tuple[str, Any]


@dataclasses.dataclass
class _Step:
    layer: IRLayer
    fn: Callable[..., Any] | None
    refs: list[Ref]
    outs: list[tuple[int, int]]
    #: a TensorIterator: its body plan (``fn`` is None)
    ti: "_TensorIterator | None" = None
    #: values no later step reads, dropped once this step has run
    free: list[tuple[int, int]] = dataclasses.field(default_factory=list)


def _set_lifetimes(steps: list[_Step], keep: set) -> None:
    """Mark on each step the values it reads or makes for the last time
    (``keep``: read after the plan has run), so a forward holds only
    live activations — at a large batch all of them at once would not
    fit on the card."""
    last: dict[tuple[int, int], int] = {}
    for i, step in enumerate(steps):
        for key in step.outs:
            last.setdefault(key, i)
        for kind, key in step.refs:
            if kind == "v":
                last[key] = i
    for key, i in last.items():
        if key not in keep:
            steps[i].free.append(key)


@dataclasses.dataclass
class _TensorIterator:
    name: str
    steps: list[_Step]
    params: list[IRLayer]            # the body's Parameter layers
    results: dict[int, Ref]          # Result layer id → its source
    inputs: list[dict]
    outputs: list[dict]
    back_by_param: dict[int, int]    # to Parameter ← from Result
    n_outputs: int

    @staticmethod
    def _norm(v: int, extent: int) -> int:
        # OpenVINO port-map convention: negative start/end count from
        # the end with -1 = "one past the last element" (end=-1 → full
        # forward range; start=-1, stride=-1 → reverse from the last
        # element)
        return v + extent + 1 if v < 0 else v

    def _slice_range(self, m: dict, extent: int) -> tuple[int, int]:
        """(begin, trips) for one sliced port-map entry."""
        stride = m["stride"]
        begin = self._norm(m["start"], extent)
        if m["end"] is not None:
            end = self._norm(m["end"], extent)
        else:
            end = extent if stride > 0 else 0
        trips = -(-abs(end - begin) // abs(stride))  # ceil
        # negative stride starts one below the (exclusive) begin
        return (begin if stride > 0 else begin - 1), trips

    def run(self, model: "ImportedIRModel", inputs: list) -> Any:
        """A Python loop over the static trip count: straight-line
        launches, capturable as they are."""
        sliced = [m for m in self.inputs if m["axis"] is not None]
        ranges = {m["layer"]: self._slice_range(
            m, inputs[m["arg"]].shape[m["axis"]]) for m in sliced}
        all_trips = {lid: t for lid, (_, t) in ranges.items()}
        trips = next(iter(all_trips.values()))
        if len(set(all_trips.values())) > 1:
            raise ValueError(
                f"TensorIterator {self.name}: sliced inputs disagree "
                f"on trip count: {all_trips}")
        if trips <= 0:
            raise ValueError(
                f"TensorIterator {self.name}: zero-trip slice range "
                "(empty time axis?) — refusing to emit empty outputs")
        state = {m["layer"]: inputs[m["arg"]]
                 for m in self.inputs if m["axis"] is None}
        per_step: dict[int, list] = {
            m["out"]: [] for m in self.outputs if m["axis"] is not None}
        final: dict[int, Any] = {}
        for it in range(trips):
            bindings = dict(state)
            for m in sliced:
                begin, _ = ranges[m["layer"]]
                bindings[m["layer"]] = inputs[m["arg"]].narrow(
                    m["axis"], begin + it * m["stride"], 1)
            missing = [pl.id for pl in self.params if pl.id not in bindings]
            if missing:
                raise ValueError(
                    f"TensorIterator {self.name}: body Parameters "
                    f"{missing} have neither a port-map input nor a "
                    "back-edge-seeded binding")
            values = {(pl.id, pl.outputs[0].id): bindings[pl.id]
                      for pl in self.params}
            model._run(self.steps, values)
            results = {rid: model._fetch(ref, values)
                       for rid, ref in self.results.items()}
            # back edges: a Result feeds its Parameter next iteration
            for to_param, from_result in self.back_by_param.items():
                state[to_param] = results[from_result]
            for m in self.outputs:
                if m["axis"] is not None:
                    per_step[m["out"]].append(results[m["layer"]])
                else:
                    final[m["out"]] = results[m["layer"]]
        outs: list[Any] = [None] * self.n_outputs
        for m in self.outputs:
            if m["axis"] is not None:
                seq = per_step[m["out"]]
                if m["stride"] < 0:
                    seq = seq[::-1]
                outs[m["out"]] = torch.cat(seq, dim=m["axis"])
            else:
                outs[m["out"]] = final[m["out"]]
        return tuple(outs) if len(outs) > 1 else outs[0]


def _as_tensor(value: np.ndarray) -> torch.Tensor:
    """A constant as a CPU tensor: float64 as float32 and wide unsigned
    types as int64 (JAX without 64-bit types computes them so)."""
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype in (np.uint16, np.uint32, np.uint64):
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.array(arr, copy=True))


class _PlanBuilder:
    """Turns a graph's runtime layers into steps, collecting the
    constant tensors they need as auxiliary buffers."""

    def __init__(self):
        self.aux: dict[str, torch.Tensor] = {}
        self.aux_of: dict[tuple[int, int], str] = {}

    def add_aux(self, value: np.ndarray, owner: tuple[int, int] | None = None
                ) -> str:
        if owner is not None and owner in self.aux_of:
            return self.aux_of[owner]
        key = f"a{len(self.aux)}"
        self.aux[key] = _as_tensor(value)
        if owner is not None:
            self.aux_of[owner] = key
        return key

    def steps(self, graph: IRGraph, layers: list[IRLayer], scope: int,
              const_ref: Callable[[int], Ref], nhwc: bool) -> list[_Step]:
        out = []
        for layer in layers:
            srcs = [graph.edges[(layer.id, p.id)] for p in layer.inputs]
            is_const = [s[0] in graph.consts for s in srcs]
            st = [graph.consts[s[0]] if c else None
                  for s, c in zip(srcs, is_const)]
            refs = [const_ref(s[0]) if c else ("v", s)
                    for s, c in zip(srcs, is_const)]
            t = layer.type
            rank4_in = bool(layer.inputs) and len(layer.inputs[0].shape) == 4
            # the reference's NHWC pass: these run channels_last
            cl = nhwc and not is_const[0] and rank4_in and (
                (t in ("Convolution", "GroupConvolution")
                 and len(srcs) == 2 and is_const[1]
                 and len(layer.outputs[0].shape) == 4)
                or t in ("MaxPool", "AvgPool"))
            fmt = torch.channels_last if cl else torch.contiguous_format
            outs = [(layer.id, p.id) for p in layer.outputs]
            if t == "TensorIterator":
                out.append(_Step(layer, None, refs, outs,
                                 ti=self.tensor_iterator(layer, scope)))
                continue
            op = _torch_op(layer, st, fmt, shift_ok=not cl)
            refs += [("a", self.add_aux(arr)) for arr in op.aux]
            out.append(_Step(layer, op.fn, refs, outs))
        return out

    def tensor_iterator(self, layer: IRLayer, scope: int) -> _TensorIterator:
        ti = layer.extra
        body: IRGraph = ti["body"]
        constant_fold(body)
        sub = scope * 100003 + layer.id + 1  # a key space per body

        def body_const(lid: int) -> Ref:
            return ("a", self.add_aux(body.consts[lid], (sub, lid)))

        runtime = [bl for bl in body.topo_order()
                   if bl.id not in body.consts
                   and bl.type not in ("Parameter", "Const", "Result")]
        steps = self.steps(body, runtime, sub, body_const, nhwc=False)
        results = {}
        for bl in body.layers.values():
            if bl.type == "Result":
                src = body.edges[(bl.id, bl.inputs[0].id)]
                results[bl.id] = (body_const(src[0]) if src[0] in body.consts
                                  else ("v", src))
        _set_lifetimes(steps, {key for kind, key in results.values()
                               if kind == "v"})
        if not any(m["axis"] is not None for m in ti["inputs"]):
            raise ValueError(
                f"TensorIterator {layer.name} has no sliced input — "
                "trip count is undefined for this importer")
        return _TensorIterator(
            name=layer.name, steps=steps,
            params=[bl for bl in body.layers.values()
                    if bl.type == "Parameter"],
            results=results, inputs=ti["inputs"], outputs=ti["outputs"],
            back_by_param={to: frm for frm, to in ti["back_edges"]},
            n_outputs=len(layer.outputs))


class _Store(nn.Module):
    """Named tensors held as buffers (names are the IR's sanitized layer
    names, which need not be Python identifiers)."""

    def __init__(self, tensors: dict[str, torch.Tensor], persistent: bool):
        super().__init__()
        for name, value in tensors.items():
            self._buffers[name] = value
            if not persistent:
                self._non_persistent_buffers_set.add(name)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._buffers[name]

    def items(self):
        return self._buffers.items()


# --------------------------------------------------------------------------
# Model assembly
# --------------------------------------------------------------------------


class ImportedIRModel(nn.Module):
    """A built IR model: ``forward(x)`` (NCHW, the IR convention) →
    ``{output name: tensor}``, its weights (:attr:`params`) and the
    detection metadata of the reference's ``ImportedIRModel``."""

    def __init__(self, graph: IRGraph, layout: str | None = None):
        super().__init__()
        constant_fold(graph)
        if layout is None:
            layout = os.environ.get("EVAM_IR_LAYOUT", "nhwc")

        params: dict[str, torch.Tensor] = {}
        for lid, val in graph.consts.items():
            if np.issubdtype(val.dtype, np.floating):
                # every float const is a weight: precision casting and
                # msgpack serialization must reach biases too
                params[_sanitize(graph.layers[lid].name)] = torch.from_numpy(
                    np.array(val, copy=True))

        parameters = [l for l in graph.layers.values() if l.type == "Parameter"]
        if len(parameters) != 1:
            raise ValueError(
                f"expected exactly one Parameter input, found {len(parameters)}"
            )
        input_layer = parameters[0]
        self.name = graph.name
        self.input_shape = tuple(input_layer.outputs[0].shape)

        results = [l for l in graph.layers.values() if l.type == "Result"]
        det_layers = [l for l in graph.layers.values()
                      if l.type == "DetectionOutput"]
        region_layers = [l for l in graph.layers.values()
                         if l.type == "RegionYolo"]

        self.anchors: np.ndarray | None = None
        self.variances = (0.1, 0.1, 0.2, 0.2)
        self.num_classes = 0
        self.detection_attrs: dict[str, str] = {}
        #: per RegionYolo output: {"anchors": [[w, h], ...] in pixels}
        self.yolo_specs: list[dict] = []
        #: "ssd" (DetectionOutput cut) or "yolo" (RegionYolo cut)
        self.detector_kind = "ssd"
        self.is_detector = bool(det_layers) or bool(region_layers)
        #: (output_name, layer_id, port_id) to evaluate
        wanted: list[tuple[str, int, int]] = []

        if region_layers and not det_layers:
            # YOLO-family IR: cut at each RegionYolo; the raw grid maps
            # become outputs, decoded in the engine step
            # (ops.boxes.yolo_gather)
            self.detector_kind = "yolo"
            for i, reg in enumerate(sorted(region_layers, key=lambda l: l.id)):
                # the spec default for do_softmax is TRUE (v2): an IR
                # omitting the attribute must hit the v2 guard
                if reg.attrs.get("do_softmax", "1").lower() in ("1", "true"):
                    raise ValueError(
                        f"RegionYolo {reg.name}: do_softmax=1 (YOLOv2 "
                        "grid-unit anchors) is not supported — the decode "
                        "path implements the v3 pixel-anchor convention"
                    )
                classes = int(reg.attrs.get("classes", "20"))
                if self.num_classes and classes != self.num_classes:
                    raise ValueError("RegionYolo heads disagree on classes")
                self.num_classes = classes
                flat = _attr_floats(reg.attrs, "anchors")
                pairs = [[flat[2 * j], flat[2 * j + 1]]
                         for j in range(len(flat) // 2)]
                mask = [int(v) for v in reg.attrs.get("mask", "").split(",")
                        if v]
                self.yolo_specs.append(
                    {"anchors": [pairs[m] for m in mask] if mask else pairs})
                src = graph.edges[(reg.id, reg.inputs[0].id)]
                wanted.append((f"yolo_{i}", *src))
            self.detection_attrs = dict(region_layers[0].attrs)
        elif self.is_detector:
            det = det_layers[0]
            self.detection_attrs = dict(det.attrs)
            self.num_classes = int(det.attrs.get("num_classes", "0"))
            srcs = [graph.edges[(det.id, p.id)] for p in det.inputs]
            # inputs: 0=loc [B, A*4], 1=conf [B, A*C], 2=priors
            prior_src = srcs[2][0]
            if prior_src not in graph.consts:
                raise ValueError(
                    "DetectionOutput priors did not constant-fold — the "
                    "PriorBox branch uses an unsupported op"
                )
            priors = np.asarray(graph.consts[prior_src], np.float32)
            priors = priors.reshape(priors.shape[-2], priors.shape[-1])
            box_row = priors[0].reshape(-1, 4)
            if _flag(det.attrs, "variance_encoded_in_target", "false"):
                # loc deltas already carry the variance scaling
                self.variances = (1.0, 1.0, 1.0, 1.0)
            elif priors.shape[0] > 1:
                var4 = priors[1].reshape(-1, 4)[0]
                self.variances = tuple(float(v) for v in var4)
            # corners → cxcywh (ops.boxes.decode_boxes convention)
            x0, y0, x1, y1 = box_row.T
            self.anchors = np.stack(
                [(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], axis=-1
            ).astype(np.float32)
            wanted = [("loc", *srcs[0]), ("conf", *srcs[1])]
        else:
            for r in results:
                src = graph.edges.get((r.id, r.inputs[0].id))
                # the producing layer's friendly name; a multi-output
                # layer's second port gets a port suffix
                out_name = _sanitize(graph.layers[src[0]].name)
                if any(w[0] == out_name for w in wanted):
                    out_name = f"{out_name}_p{src[1]}"
                wanted.append((out_name, *src))

        def _is_prob(lid: int) -> bool:
            """Walk back through shape-only layers to see if this output
            was already softmaxed inside the graph."""
            seen = 0
            while seen < 16:
                layer = graph.layers[lid]
                if layer.type == "SoftMax":
                    return True
                if layer.type in ("Reshape", "Squeeze", "Unsqueeze",
                                  "Transpose", "Convert", "Concat"):
                    src = graph.edges.get((lid, layer.inputs[0].id))
                    if src is None:
                        return False
                    lid = src[0]
                    seen += 1
                    continue
                return False
            return False

        self.output_names = [w[0] for w in wanted]
        self.output_shapes: list[tuple[int, ...]] = []
        #: per output: True when the graph already applies SoftMax
        self.output_is_prob: list[bool] = []
        for _, lid, pid in wanted:
            port = next(p for p in graph.layers[lid].outputs if p.id == pid)
            self.output_shapes.append(tuple(port.shape))
            self.output_is_prob.append(_is_prob(lid))

        needed: set[int] = set()

        def mark(lid: int) -> None:
            if lid in needed or lid in graph.consts:
                return
            needed.add(lid)
            for port in graph.layers[lid].inputs:
                src = graph.edges.get((lid, port.id))
                if src is not None:
                    mark(src[0])

        for _, lid, _pid in wanted:
            mark(lid)

        self.layout = layout
        nhwc = layout == "nhwc" and any(
            l.type in ("Convolution", "GroupConvolution")
            for l in graph.layers.values() if l.id in needed)
        builder = _PlanBuilder()
        names = {lid: _sanitize(graph.layers[lid].name) for lid in graph.consts}

        def top_const(lid: int) -> Ref:
            if np.issubdtype(graph.consts[lid].dtype, np.floating):
                return ("p", names[lid])
            return ("a", builder.add_aux(graph.consts[lid], (0, lid)))

        runtime = [l for l in graph.topo_order() if l.id in needed
                   and l.type not in ("Parameter", "Const", "Result")]
        self._steps = builder.steps(graph, runtime, 0, top_const, nhwc)
        self._input_key = (input_layer.id, input_layer.outputs[0].id)
        self._outputs = [
            (name, top_const(lid) if lid in graph.consts else ("v", (lid, pid)))
            for name, lid, pid in wanted]
        _set_lifetimes(self._steps, {key for _, (kind, key) in self._outputs
                                     if kind == "v"})
        if nhwc:
            # the NHWC plan's convolution weights, stored channels_last
            for step in self._steps:
                if step.layer.type == "Convolution" and len(step.refs) == 2 \
                        and step.refs[1][0] == "p":
                    w = params[step.refs[1][1]]
                    if w.dim() == 4:
                        params[step.refs[1][1]] = w.contiguous(
                            memory_format=torch.channels_last)
        self.weights = _Store(params, persistent=True)
        self.aux = _Store(builder.aux, persistent=False)

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """The flat weight dict (sanitized layer name → tensor), in the
        reference's order."""
        return dict(self.weights.items())

    @property
    def input_hw(self) -> tuple[int, int]:
        if len(self.input_shape) == 4:
            return (int(self.input_shape[2]), int(self.input_shape[3]))
        # non-image IR (clip embeddings [1,T,D], audio [1,S]): the
        # registry uses this only to fill the PreprocessSpec, which
        # those families never apply — report the trailing dims
        return (1, int(self.input_shape[-1]))

    def trainable_params(self) -> dict[str, torch.Tensor]:
        """Make every floating weight a leaf that takes gradients, in
        place, and return them by name in :attr:`params`' order. They
        stay buffers of the same names, shapes, dtypes and memory
        formats, so the forward, :meth:`load_params` and
        :meth:`cast_params` see them as before. A weight the forward
        never reads (a folded PriorBox) gets no gradient."""
        for name, value in self.weights.items():
            if value.is_floating_point():
                self.weights._buffers[name] = value.detach().requires_grad_()
        return {name: value for name, value in self.weights.items()
                if value.requires_grad}

    @torch.no_grad()
    def load_params(self, flat: dict[str, torch.Tensor]) -> None:
        """Replace every weight with ``flat``'s (the same names and
        shapes; each keeps the loaded dtype, as flax's restore does)."""
        if set(flat) != set(self.weights._buffers):
            missing = sorted(set(self.weights._buffers) - set(flat))[:5]
            extra = sorted(set(flat) - set(self.weights._buffers))[:5]
            raise ValueError(f"not this IR's weight dict (missing {missing}, "
                             f"unexpected {extra})")
        for name, value in flat.items():
            old = self.weights._buffers[name]
            if tuple(value.shape) != tuple(old.shape):
                raise ValueError(f"weight {name}: shape {tuple(value.shape)}, "
                                 f"the IR's is {tuple(old.shape)}")
        for name, value in flat.items():
            old = self.weights._buffers[name]
            fmt = (torch.channels_last
                   if old.dim() == 4 and not old.is_contiguous()
                   else torch.contiguous_format)
            self.weights._buffers[name] = value.to(old.device).contiguous(
                memory_format=fmt)

    @torch.no_grad()
    def cast_params(self, dtype: torch.dtype) -> None:
        """Cast every floating weight to ``dtype`` (memory format kept)."""
        for name, value in self.weights._buffers.items():
            if value.is_floating_point():
                self.weights._buffers[name] = value.to(dtype)

    def _fetch(self, ref: Ref, values: dict):
        kind, key = ref
        if kind == "v":
            if key not in values:
                raise KeyError(f"unresolved IR edge {key}")
            return values[key]
        if kind == "p":
            w = self.weights[key]
            return w.float() if w.dtype == torch.float64 else w
        return self.aux[key]

    def _run(self, steps: list[_Step], values: dict) -> None:
        for step in steps:
            ins = [self._fetch(r, values) for r in step.refs]
            out = step.ti.run(self, ins) if step.ti is not None \
                else step.fn(*ins)
            if isinstance(out, tuple):
                for key, o in zip(step.outs, out):
                    values[key] = o
            else:
                values[step.outs[0]] = out
            for key in step.free:
                values.pop(key, None)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        values = {self._input_key: x}
        self._run(self._steps, values)
        return {name: self._fetch(ref, values) for name, ref in self._outputs}


def build_ir_model(graph: IRGraph, layout: str | None = None
                   ) -> ImportedIRModel:
    """Constant-fold, cut at DetectionOutput or RegionYolo if present,
    and build the remaining layers into a module (on the CPU; move it
    with ``.to``). ``layout``: "nhwc" (default: ``EVAM_IR_LAYOUT``, else
    nhwc) or "nchw"."""
    return ImportedIRModel(graph, layout)


def load_ir(xml_path: str | Path, layout: str | None = None
            ) -> ImportedIRModel:
    """Parse + build in one call."""
    model = build_ir_model(parse_ir(xml_path), layout)
    if model.detector_kind == "yolo":
        det_note = f", yolo heads={len(model.yolo_specs)}"
    elif model.is_detector:
        det_note = f", detector A={len(model.anchors)}"
    else:
        det_note = ""
    log.info(
        "imported IR %s: input %s, outputs %s%s, %d weight tensors",
        model.name, model.input_shape, model.output_names, det_note,
        len(model.weights._buffers),
    )
    return model
