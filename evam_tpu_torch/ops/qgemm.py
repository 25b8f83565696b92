"""Int8 GEMM with fused per-row activation quantization.

Counterpart of ``evam_tpu/ops/pallas_qgemm.py`` (``_qgemm_kernel``,
``pallas_quant_dense``). The kernel is CUDA C++ for ``sm_90a``
(``evam_tpu_torch/csrc/qgemm.cu``, built by ``ops/kernels.py``); this
module holds its wrapper :func:`qgemm`, its plain version
:func:`qgemm_reference`, and the launch count :data:`launches`.

Weights arrive quantized per output channel (``ops/qlinear.py::
quantize_weight``) and transposed to ``[N, K]`` with K contiguous — done
once at load for served models.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from evam_tpu_torch.ops import kernels


#: launches of the CUDA kernel; the wrapper adds one per launch and
#: nowhere else (plain-version calls do not count). Callers reset it
#: to 0 before a run whose launches they want to count.
launches = 0


def _lib():
    lib = kernels.load("qgemm")
    if lib.evam_qgemm.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.evam_qgemm.argtypes = [p, i, p, p, p, p, p, p, i, i, i, p]
        lib.evam_qgemm.restype = ctypes.c_int
    return lib


def div_rn(a: torch.Tensor, b) -> torch.Tensor:
    """float32 a / b, correctly rounded on every device.

    The quotient of two float32 values computed in float64 and rounded
    once to float32 is the correctly rounded float32 quotient (53 ≥
    2·24 + 2 bits), so this equals IEEE division — what the kernel's
    ``__fdiv_rn`` and XLA compute. torch on the card divides by a CPU
    scalar as a product with its reciprocal, which can be off by one
    ulp (``max|x| / 127.0`` is), so the plain version does not rely on
    its float32 division.
    """
    b = b.double() if isinstance(b, torch.Tensor) else float(b)
    return (a.double() / b).float()


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] float → (int8 codes [M, K], row scales [M] float32).

    ``scale = max(max|x_row| / 127, 1e-8)``, codes
    ``clip(round_half_even(x / scale), ±127)`` — ``_qgemm_kernel``'s
    quantization, over the full K.
    """
    xf = x.float()
    row_max = torch.amax(torch.abs(xf), dim=1, keepdim=True)
    row_scale = torch.clamp(div_rn(row_max, 127.0), min=1e-8)
    codes = torch.clamp(torch.round(div_rn(xf, row_scale)), -127, 127)
    return codes.to(torch.int8), row_scale[:, 0]


def qgemm_reference(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the kernel, same arithmetic in the same order.

    x [M, K] bf16/f32, wq [N, K] int8, w_scale [N] f32, bias [N] or
    None → [M, N] float32. The int8 product is exact: int32 on the CPU
    (torch's int8 matmul wraps, so the codes are upcast first), float64
    on the card (|sum| ≤ K·127² ≪ 2⁵³).
    """
    codes, row_scale = quantize_rows(x)
    if x.device.type == "cpu":
        acc = torch.matmul(codes.to(torch.int32), wq.to(torch.int32).T)
    else:
        acc = torch.matmul(codes.double(), wq.double().T)
    out = acc.float() * row_scale[:, None] * w_scale.float()
    if bias is not None:
        out = out + bias.float()
    return out


def _check_args(x, wq, w_scale, bias):
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[1]:
        raise ValueError(
            f"qgemm wants x [M, K] and wq [N, K], got {tuple(x.shape)} "
            f"and {tuple(wq.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qgemm x must be bfloat16 or float32, got {x.dtype}")
    if wq.dtype != torch.int8:
        raise TypeError(f"qgemm wq must be int8, got {wq.dtype}")
    n = wq.shape[0]
    if tuple(w_scale.shape) != (n,) or w_scale.dtype != torch.float32:
        raise ValueError(
            f"qgemm w_scale must be float32 [{n}], got {w_scale.dtype} "
            f"{tuple(w_scale.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"qgemm bias must be [{n}], got {tuple(bias.shape)}")
    devices = {t.device for t in (x, wq, w_scale) + ((bias,) if bias is not None else ())}
    if len(devices) != 1:
        raise ValueError(f"qgemm operands on different devices: {devices}")


def qgemm(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
          bias: torch.Tensor | None = None, *, return_codes: bool = False):
    """out[m, n] = (Σ_k q(x)[m, k]·wq[n, k])·row_scale[m]·w_scale[n] (+ bias[n]).

    x [M, K] bf16/f32, wq [N, K] int8, w_scale [N] f32, bias [N] or
    None → [M, N] float32. With ``return_codes`` also returns the int8
    codes [M, K] and row scales [M] the computation used (the kernel
    writes them out; for comparison with :func:`quantize_rows`).
    """
    global launches
    _check_args(x, wq, w_scale, bias)
    if x.device.type == "cpu":
        out = qgemm_reference(x, wq, w_scale, bias)
        return (out, *quantize_rows(x)) if return_codes else out
    if x.device.type != "cuda":
        raise ValueError(f"qgemm runs on cpu or cuda, not {x.device}")
    for name, t in (("x", x), ("wq", wq), ("w_scale", w_scale)):
        if not t.is_contiguous():
            raise ValueError(f"qgemm {name} must be contiguous")
    m, k = x.shape
    n = wq.shape[0]
    if m == 0:
        out = torch.zeros((0, n), dtype=torch.float32, device=x.device)
        out = out + bias.float() if bias is not None else out
        if return_codes:
            return (out, torch.zeros((0, k), dtype=torch.int8, device=x.device),
                    torch.zeros((0,), dtype=torch.float32, device=x.device))
        return out
    bias_f = bias.float().contiguous() if bias is not None else None
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    codes = scales = None
    if return_codes:
        codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
        scales = torch.empty((m,), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.evam_qgemm(
            x.data_ptr(), int(x.dtype == torch.bfloat16), wq.data_ptr(),
            w_scale.data_ptr(),
            bias_f.data_ptr() if bias_f is not None else None,
            out.data_ptr(),
            codes.data_ptr() if codes is not None else None,
            scales.data_ptr() if scales is not None else None,
            m, n, k, stream)
    kernels.check(lib, rc, "qgemm")
    launches += 1
    if return_codes:
        return out, codes, scales
    return out
