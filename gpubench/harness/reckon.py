"""Operations and bytes, and the peaks they are held against.

Frozen here so that a later change to a kernel cannot move its own
yardstick. Peaks are NVIDIA's published dense rates of one H100 SXM
(no sparsity) at its full 700 W limit; a card set lower reads lower
against them, so every run prints its power limit beside them.

A configuration's ``layers`` table gives each layer's shapes and the
precision it is served in; K1 is the int8 GEMM every 1×1, stride-1,
ungrouped int8 convolution runs on.
"""

from __future__ import annotations

#: operations a second by precision (tensor cores where the precision
#: has them; float32 outside them)
PEAK_OPS = {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12,
            "fp16": 989e12, "tf32": 495e12, "fp32": 67e12}
#: device memory bandwidth, bytes a second
PEAK_BYTES = 3.35e12
#: bytes of one element by dtype name
DTYPE_BYTES = {"int8": 1, "uint8": 1, "bf16": 2, "fp16": 2, "fp32": 4}


def layer_ops(layer: dict) -> int:
    """Operations (a multiply and an add each count one) of one layer
    for one input: a convolution over its output grid, or a dense."""
    if layer["kind"] == "dense":
        return 2 * layer["cin"] * layer["cout"]
    oh, ow = layer["out_hw"]
    k = layer["k"]
    return 2 * oh * ow * layer["cout"] * (layer["cin"] // layer["groups"]) * k * k


def is_k1(layer: dict) -> bool:
    return (layer["precision"] == "int8" and layer["kind"] == "conv"
            and layer["k"] == 1 and layer["stride"] == 1
            and layer["groups"] == 1)


def peak_seconds(layers: list[dict], per: str) -> float:
    """Seconds at the published peak for the layers applied once per
    ``per`` ("frame" or "roi")."""
    return sum(layer_ops(l) / PEAK_OPS[l["precision"]]
               for l in layers if l["per"] == per)


def k1_launch(m: int, k: int, n: int, x_dtype: str = "bf16"
              ) -> tuple[int, int]:
    """(operations, bytes) of one K1 launch over x [m, k] and int8
    weights [n, k]: x read once at its dtype, the weights, their float32
    scales and the float32 bias once each, the float32 output written
    once."""
    ops = 2 * m * n * k
    nbytes = (m * k * DTYPE_BYTES[x_dtype] + n * k + 4 * n + 4 * n
              + 4 * m * n)
    return ops, nbytes


def k1_bound_seconds(m: int, k: int, n: int, x_dtype: str = "bf16") -> float:
    """The least time the card could take for one K1 launch: the larger
    of its operations at the int8 peak and its bytes at the bandwidth."""
    ops, nbytes = k1_launch(m, k, n, x_dtype)
    return max(ops / PEAK_OPS["int8"], nbytes / PEAK_BYTES)


def k1_shapes(layers: list[dict], bucket: int, rois: int) -> list[tuple]:
    """(m, k, n) of every K1 launch of one forward at ``bucket`` frames:
    a frame's layers see ``bucket`` inputs, an ROI's ``bucket × rois``
    (the fused step classifies every ROI slot)."""
    out = []
    for l in layers:
        if not is_k1(l):
            continue
        oh, ow = l["out_hw"]
        inputs = bucket * (rois if l["per"] == "roi" else 1)
        out.append((inputs * oh * ow, l["cin"], l["cout"]))
    return out


def forward_bound_seconds(layers: list[dict], bucket: int, rois: int) -> float:
    return sum(k1_bound_seconds(m, k, n)
               for m, k, n in k1_shapes(layers, bucket, rois))
