"""Int8 GEMM with fused per-row activation quantization.

Counterpart of ``evam_tpu/ops/pallas_qgemm.py`` (``_qgemm_kernel``,
``pallas_quant_dense``). The kernel is CUDA C++ for ``sm_90a``
(``evam_tpu_torch/csrc/qgemm.cu``, built by ``ops/kernels.py``); this
module holds its wrapper :func:`qgemm`, its launch plan :func:`plan`,
its plain version :func:`qgemm_reference`, and the launch counts
:data:`launches` and :data:`variant_launches`.

Weights arrive quantized per output channel (``ops/qlinear.py::
quantize_weight``) and transposed to ``[N, K]`` with K contiguous — done
once at load for served models.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from dataclasses import dataclass

import torch

from evam_tpu_torch.ops import kernels


#: launches of the CUDA kernel; the wrapper adds one per launch, and a
#: replay of a CUDA graph the launches its capture recorded
#: (:func:`count_replay`), nowhere else (plain-version calls do not
#: count). Callers reset it to 0 before a run whose launches they want
#: to count.
launches = 0
#: the same launches by variant: "aligned" (16-byte asynchronous copies,
#: no edge checks) or "masked" (guarded loads and stores at ragged edges)
variant_launches = {"aligned": 0, "masked": 0}
_count_lock = threading.Lock()
#: per thread: the variant counts a CUDA-graph capture records instead
#: of the global counts (a captured call launches nothing)
_capture = threading.local()


@contextlib.contextmanager
def recording():
    """Record this thread's calls into a fresh ``{variant: n}`` dict
    instead of the launch counts: a call made while a CUDA graph is
    being captured launches nothing then, but once per replay
    (:func:`count_replay`)."""
    counts = {"aligned": 0, "masked": 0}
    prev = getattr(_capture, "counts", None)
    _capture.counts = counts
    try:
        yield counts
    finally:
        _capture.counts = prev


def count_replay(counts: dict[str, int]) -> None:
    """One replay of a graph whose capture recorded ``counts``: its
    launches of the kernel."""
    global launches
    with _count_lock:
        for variant, n in counts.items():
            launches += n
            variant_launches[variant] += n


def _count(variant: str) -> None:
    counts = getattr(_capture, "counts", None)
    if counts is not None:
        counts[variant] += 1
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("qgemm captured into a CUDA graph outside "
                           "qgemm.recording(): its replays would go "
                           "uncounted")
    count_replay({variant: 1})

#: (rows, columns) of a block's output tile; the kernel is instantiated
#: for exactly these (csrc/qgemm.cu dispatch)
TILES = ((64, 64), (32, 64), (16, 64), (16, 32), (16, 8))
#: shared memory a block may use on sm_90, the SM's, and the most a
#: plan asks for so that two blocks fit on one SM
SMEM_MAX = 232448
SMEM_SM = 233472
SMEM_SOFT = SMEM_MAX // 2
SMS = 132
#: blocks a plan aims for: one for each of the H100's 132 SMs
TARGET_BLOCKS = SMS
#: bytes of x a row tile aims for: rows enough to amortise the block's
#: weight tile, few enough that several blocks share an SM
X_TILE_BYTES = 16384
#: most column tiles one block takes (its rows quantized once for all)
NSUB_MAX = 4
#: resident blocks per SM the grid is sized for where K is held whole:
#: each block then walks several row tiles, copying the next one in
#: while it quantizes, multiplies and stores the current one
RESIDENT = 4
PAD = 16


@dataclass(frozen=True)
class Plan:
    """How one call is launched: a ``bm`` × ``bn`` output tile, K in
    chunks of ``kc`` (one chunk: a row tile's whole x sits in shared
    memory), a ``grid`` of (row blocks, column blocks) in which row block
    ``i`` takes row tiles ``i, i + grid[0], ...`` and column block ``j``
    the ``nsub`` column tiles from ``j * nsub`` on, ``smem`` bytes of
    dynamic shared memory, and the variant."""

    bm: int
    bn: int
    kc: int
    masked: bool
    grid: tuple[int, int]
    smem: int
    nsub: int = 1

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def variant(self) -> str:
        return "masked" if self.masked else "aligned"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(bm: int, bn: int, kc: int, esize: int, xbufs: int,
               wbufs: int) -> int:
    """Dynamic shared memory of a block: ``xbufs`` x and ``wbufs``
    weight chunk buffers (rows padded by 16 bytes), one int8 codes
    buffer and the row scales — ``Layout`` in csrc/qgemm.cu."""
    x = bm * (kc * esize + PAD)
    w = bn * (kc + PAD)
    return xbufs * x + wbufs * w + bm * (kc + PAD) + 4 * bm


@functools.lru_cache(maxsize=1024)
def plan(m: int, n: int, k: int, x_dtype: torch.dtype,
         pointers_aligned: bool = True, tile: tuple[int, int] | None = None,
         nsub: int | None = None) -> Plan:
    """The launch plan of one call (m ≥ 1).

    Rows: the most (64, 32 or 16) whose x tile holds at most
    :data:`X_TILE_BYTES`. Columns: 64, or 32 then 8 where 64 leaves the
    grid under :data:`TARGET_BLOCKS` blocks. Where K does not fit whole
    in :data:`SMEM_SOFT` of shared memory it is cut into the largest
    chunks of 32 that do, double-buffered, one column tile a block.
    Where it does, a block takes up to :data:`NSUB_MAX` column tiles
    while the grid stays at the target (its rows quantized once for all
    of them, the weight tiles streamed through two buffers), and where
    there are more blocks than :data:`RESIDENT` per SM, each block walks
    several row tiles, the next one's x copied in ahead. The aligned
    variant needs the tile to divide m and n, 32 to divide k, and
    16-byte aligned operands; anything else runs masked. ``tile`` and
    ``nsub`` fix those choices instead (for measuring them). Plans are
    cached: a served model asks for the same few shapes every forward.
    """
    esize = 2 if x_dtype == torch.bfloat16 else 4
    kp = _cdiv(k, 32) * 32
    if tile is None:
        bm = 64
        while bm > 16 and (bm * kp * esize > X_TILE_BYTES or bm // 2 >= m):
            bm //= 2
        target = min(TARGET_BLOCKS, _cdiv(m, 16) * _cdiv(n, 8))
        bn = next((c for c in (64, 32, 8) if (bm, c) in TILES
                   and _cdiv(m, bm) * _cdiv(n, c) >= target), 8)
        if bn == 8:
            bm = 16
    else:
        bm, bn = tile
    mtiles, ntiles = _cdiv(m, bm), _cdiv(n, bn)
    aligned = (m % bm == 0 and n % bn == 0 and k % 32 == 0
               and pointers_aligned)
    if smem_bytes(bm, bn, kp, esize, 1, 1) > SMEM_SOFT:
        kc = 32
        while (kc + 32 < kp
               and smem_bytes(bm, bn, kc + 32, esize, 2, 2) <= SMEM_SOFT):
            kc += 32
        return Plan(bm=bm, bn=bn, kc=kc, masked=not aligned,
                    grid=(mtiles, ntiles),
                    smem=smem_bytes(bm, bn, kc, esize, 2, 2))
    if nsub is None:
        nsub = 1
        while (nsub < min(ntiles, NSUB_MAX)
               and mtiles * _cdiv(ntiles, nsub + 1) >= TARGET_BLOCKS
               and smem_bytes(bm, bn, kp, esize, 1, 2) <= SMEM_SOFT):
            nsub += 1
    grid_n = _cdiv(ntiles, nsub)
    nsub = _cdiv(ntiles, grid_n)
    wbufs = 2 if nsub > 1 else 1
    smem1 = smem_bytes(bm, bn, kp, esize, 1, wbufs)
    smem2 = smem_bytes(bm, bn, kp, esize, 2, wbufs)
    resident = min(RESIDENT, SMEM_SM // (smem1 + 1024))
    grid_m = _cdiv(SMS * resident, grid_n)
    if grid_m >= mtiles or SMEM_SM // (smem2 + 1024) < resident:
        # one row tile per block: a second x buffer would cost residency
        return Plan(bm=bm, bn=bn, kc=kp, masked=not aligned,
                    grid=(mtiles, grid_n), smem=smem1, nsub=nsub)
    return Plan(bm=bm, bn=bn, kc=kp, masked=not aligned, grid=(grid_m, grid_n),
                smem=smem2, nsub=nsub)


def _lib():
    lib = kernels.load("qgemm")
    if lib.evam_qgemm.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.evam_qgemm.argtypes = [p, i, p, p, p, p, p, p, i, i, i,
                                   i, i, i, i, i, i, i, p]
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
    ptrs = [t.data_ptr() for t in (x, wq, w_scale, bias_f, out, codes)
            if t is not None]
    p = plan(m, n, k, x.dtype, all(q % 16 == 0 for q in ptrs))
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
            m, n, k, p.bm, p.bn, p.kc, p.grid[0], p.nsub, int(p.masked),
            p.smem, stream)
    kernels.check(lib, rc, "qgemm")
    _count(p.variant)
    if return_codes:
        return out, codes, scales
    return out
