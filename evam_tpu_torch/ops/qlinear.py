"""INT8 quantized conv/dense primitives (counterpart of ``evam_tpu/ops/qlinear.py``).

Scheme, as in the reference:

* **weights**: symmetric per-output-channel int8 (``round(w / w_scale)``).
  The reference quantizes them inside its jitted step; the port
  quantizes once, at load, from the params as they are served (cast to
  bf16 first in INT8 serving) — the same constants, so the same codes.
* **activations**: symmetric dynamic int8. ``EVAM_QGEMM=xla`` (default)
  uses one scale per example; ``EVAM_QGEMM=pallas`` sends every 1×1,
  stride-1, ungrouped conv and every 2-D dense through the hand-written
  kernel (``ops/qgemm.py``), which scales per row (per pixel). The two
  are not numerics-neutral, exactly as in the reference.
* bias add stays float.

The per-example path keeps the reference's order of operations:
``y * (x_scale * w_scale) + bias``. Its int8 product must be exact (the
reference's is int32): the port computes it over int-valued floats —
float64 on the CPU; on the card float32 where every partial sum stays
below 2²⁴ (K·127² < 2²⁴, i.e. K ≤ 1040) and float64 beyond — as an
im2col matrix product, so no convolution algorithm (Winograd, FFT) can
round it.
"""

from __future__ import annotations

import os as _os

import torch
import torch.nn.functional as F

from evam_tpu_torch.ops.padding import pad_same
from evam_tpu_torch.ops.qgemm import div_rn, qgemm

#: "xla" (default) or "pallas": the reference's knob names; "pallas"
#: selects the hand-written CUDA kernel
QGEMM_BACKEND = _os.environ.get("EVAM_QGEMM", "xla")

#: largest K whose int8 dot products are exact in float32 partial sums
_F32_EXACT_K = (1 << 24) // (127 * 127)


def quantize_weight(kernel: torch.Tensor, out_axis: int = -1
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Float kernel → (int8 kernel, per-out-channel scale [out] f32).

    ``out_axis`` names the output-channel axis: -1 for the reference's
    HWIO / ``[in, out]`` layouts, 0 for torch's OIHW / ``[out, in]``.
    """
    w = kernel.float()
    axis = out_axis % w.dim()
    reduce = tuple(d for d in range(w.dim()) if d != axis)
    w_scale = torch.clamp(div_rn(torch.amax(torch.abs(w), dim=reduce), 127.0),
                          min=1e-8)
    shape = [1] * w.dim()
    shape[axis] = -1
    wq = torch.clamp(torch.round(div_rn(w, w_scale.reshape(shape))), -127, 127)
    return wq.to(torch.int8), w_scale


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Float activations → (int8 tensor, per-example scale, keepdims).

    The scale reduces over every non-batch axis, so a frame's
    quantization never depends on what it was batched with."""
    xf = x.float()
    axes = tuple(range(1, xf.dim()))
    x_scale = torch.clamp(
        div_rn(torch.amax(torch.abs(xf), dim=axes, keepdim=True), 127.0),
        min=1e-8)
    xq = torch.clamp(torch.round(div_rn(xf, x_scale)), -127, 127).to(torch.int8)
    return xq, x_scale


def _exact_dtype(x: torch.Tensor, k: int) -> torch.dtype:
    if x.device.type == "cpu" or k > _F32_EXACT_K:
        return torch.float64
    return torch.float32


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 a [..., K] @ b [K, N] → float32 (int32-valued sums)."""
    dt = _exact_dtype(a, a.shape[-1])
    return torch.matmul(a.to(dt), b.to(dt)).float()


def _int_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int,
              groups: int) -> torch.Tensor:
    """Exact SAME conv of int8 xq [B, C, H, W] with int8 wq [O, C/g, kh, kw]
    → float32 NCHW holding the int32 sums."""
    b = xq.shape[0]
    o, cg, kh, kw = wq.shape
    dt = _exact_dtype(xq, cg * kh * kw)
    xp = pad_same(xq.to(dt), (kh, kw), stride)
    out_h = (xp.shape[2] - kh) // stride + 1
    out_w = (xp.shape[3] - kw) // stride + 1
    cols = F.unfold(xp, (kh, kw), stride=stride)   # [B, C*kh*kw, L]
    cols = cols.reshape(b, groups, cg * kh * kw, out_h * out_w)
    w = wq.to(dt).reshape(groups, o // groups, cg * kh * kw)
    y = torch.matmul(w[None], cols)                # [B, g, O/g, L]
    return y.reshape(b, o, out_h, out_w).float()


def qconv_nchw(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
               bias: torch.Tensor | None, stride: int = 1,
               groups: int = 1) -> torch.Tensor:
    """INT8 SAME conv on pre-quantized weights, NCHW in/out (float32 out).

    ``wq`` int8 OIHW, ``w_scale`` [O] float32. On ``EVAM_QGEMM=pallas``
    a 1×1, stride-1, ungrouped conv is a GEMM over pixels and goes to
    the kernel; channels_last input makes ``[B·H·W, C]`` a view.
    """
    o, _, kh, kw = wq.shape
    if (QGEMM_BACKEND == "pallas" and kh == kw == 1 and stride == 1
            and groups == 1):
        b, c, h, w = x.shape
        rows = x.permute(0, 2, 3, 1).reshape(-1, c).contiguous()
        out = qgemm(rows, wq.reshape(o, c), w_scale, bias)
        return out.reshape(b, h, w, o).permute(0, 3, 1, 2)
    xq, x_scale = quantize_act(x)
    y = _int_conv(xq, wq, stride, groups)
    out = y * (x_scale * w_scale.reshape(1, -1, 1, 1))
    if bias is not None:
        out = out + bias.float().reshape(1, -1, 1, 1)
    return out


def quant_conv(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None,
    strides: tuple[int, int] = (1, 1),
    padding: str = "SAME",
    feature_group_count: int = 1,
) -> torch.Tensor:
    """INT8 convolution with float in/out, in the reference's layouts
    (x NHWC, kernel HWIO), quantizing the kernel per call."""
    if padding != "SAME" or strides[0] != strides[1]:
        raise NotImplementedError("quant_conv supports square-stride SAME")
    wq, w_scale = quantize_weight(kernel)
    out = qconv_nchw(x.permute(0, 3, 1, 2), wq.permute(3, 2, 0, 1), w_scale,
                     bias, stride=strides[0], groups=feature_group_count)
    return out.permute(0, 2, 3, 1)


def quant_dense(x: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor | None) -> torch.Tensor:
    """INT8 matmul with float in/out (kernel [in, out])."""
    wq, w_scale = quantize_weight(kernel)
    if QGEMM_BACKEND == "pallas" and x.dim() == 2:
        return qgemm(x, wq.T.contiguous(), w_scale, bias)
    xq, x_scale = quantize_act(x)
    out = _int_matmul(xq, wq) * (x_scale * w_scale)
    if bias is not None:
        out = out + bias.float()
    return out
