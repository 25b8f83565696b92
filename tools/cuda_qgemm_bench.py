#!/usr/bin/env python3
"""Time builds of the port's int8 GEMM kernel against each other on the card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/cuda_qgemm_bench.py [--baseline SRC] [--variant NAME=SRC ...]
                                      [--tiles plan|all] [--rounds 2]

Times ``evam_tpu_torch/csrc/qgemm.cu`` ("current", launched by
``ops/qgemm.py::qgemm`` with its launch plan) at the ten shapes of one
8-image SSD-512 forward (``chip_smoke.py`` MAIN_SHAPES, bf16), beside:

- ``--baseline SRC``: a source with the first design's C entry,
  ``evam_qgemm(x, x_is_bf16, wq, w_scale, bias, out, codes, scales, M, N,
  K, stream)``, which picks its own grid;
- ``--variant NAME=SRC``: a source with the current C entry (launch-plan
  arguments), launched through the same wrapper and plan.

Each source is built with ``ops/kernels.py``'s nvcc flags under its own
library name in ``build/kernels/``. Every build's output must equal
``qgemm_reference`` before it is timed. ``--tiles all`` also times every
tile of ``ops/qgemm.py::TILES`` with 1, 2, 4 and 8 column tiles a block
at every shape (current and variants).
The builds run in turns, in reversed order every other round (A B, B A).
Device time is the profiler's sum over kernels named ``qgemm``, per call:
back to back, and with the L2 flushed before each call (the figure set
against the bound). Prints one JSON line per measurement, one summary
line per build and round, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (stdlib-only at import)


def _build(sources: dict[str, Path]) -> dict[str, Path]:
    """One nvcc per source, all in parallel; returns name → library."""
    from evam_tpu_torch.ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for name, src in sources.items():
        digest = hashlib.sha256(src.read_bytes() + " ".join(
            kernels.NVCC_FLAGS).encode()).hexdigest()[:12]
        lib = kernels.BUILD_DIR / f"libbench_{name}_{digest}.so"
        libs[name] = lib
        if not lib.exists():
            procs[name] = subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return libs


def _load(path: Path, baseline: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.evam_qgemm.argtypes = ([p, i, p, p, p, p, p, p, i, i, i, p] if baseline
                               else [p, i, p, p, p, p, p, p, i, i, i,
                                     i, i, i, i, i, i, i, p])
    lib.evam_qgemm.restype = i
    lib.evam_cuda_error_string.argtypes = [i]
    lib.evam_cuda_error_string.restype = ctypes.c_char_p
    return lib


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=SRC")
    ap.add_argument("--tiles", choices=("plan", "all"), default="plan")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("cuda_qgemm_bench: no CUDA device", file=sys.stderr)
        return 1
    from evam_tpu_torch.ops import kernels, qlinear
    from evam_tpu_torch.ops import qgemm as qg

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke._nvidia_smi()
    sources = {"current": kernels.CSRC / kernels.SOURCES["qgemm"]}
    for spec in args.variant:
        name, src = spec.split("=", 1)
        sources[name] = Path(src)
    if args.baseline is not None:
        sources["baseline"] = args.baseline
    libs = {name: _load(path, name == "baseline")
            for name, path in _build(sources).items()}
    wrapper_lib, wrapper_plan = qg._lib, qg.plan

    def call(name, choice, x, wq, w_scale, bias):
        """One launch of build ``name`` (choice None: the plan's, else
        the plan with this (tile, nsub))."""
        lib = libs[name]
        m, k = x.shape
        n = wq.shape[0]
        if name == "baseline":
            out = torch.empty((m, n), dtype=torch.float32, device="cuda")
            rc = lib.evam_qgemm(
                x.data_ptr(), int(x.dtype == torch.bfloat16), wq.data_ptr(),
                w_scale.data_ptr(), bias.data_ptr(), out.data_ptr(), None,
                None, m, n, k, torch.cuda.current_stream().cuda_stream)
            kernels.check(lib, rc, "baseline qgemm")
            return out
        qg._lib = lambda: lib
        if choice is not None:
            qg.plan = lambda *a, **kw: wrapper_plan(
                *a, **kw, tile=choice[0], nsub=choice[1])
        try:
            return qg.qgemm(x, wq, w_scale, bias)
        finally:
            qg._lib, qg.plan = wrapper_lib, wrapper_plan

    gen = torch.Generator(device="cuda").manual_seed(0)
    scratch = torch.ones(chip_smoke.FLUSH_BYTES // 4, device="cuda")
    flush = lambda: scratch.sum()
    shapes = []
    for m, k, n in chip_smoke.MAIN_SHAPES:
        m *= chip_smoke.IMAGES
        x = (torch.randn((m, k), generator=gen, device="cuda") * 2).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.2
        wq, w_scale = qlinear.quantize_weight(w)
        wq = wq.T.contiguous()
        bias = torch.randn((n,), generator=gen, device="cuda") * 0.1
        shapes.append((x, wq, w_scale, bias))

    names = list(libs)
    sums: dict[tuple[str, int], list[float]] = {}
    for rnd in range(args.rounds):
        order = names if rnd % 2 == 0 else names[::-1]
        for x, wq, w_scale, bias in shapes:
            m, k = x.shape
            n = wq.shape[0]
            ref = qg.qgemm_reference(x, wq, w_scale, bias)
            nbytes = x.numel() * 2 + wq.numel() + 8 * n + 4 * m * n
            bound_ms = max(1e3 * nbytes / chip_smoke.HBM_BYTES_S,
                           1e3 * 2.0 * m * n * k / chip_smoke.INT8_OPS_S)
            for name in order:
                choices = [None]
                if args.tiles == "all" and name != "baseline":
                    choices += [(t, s) for t in qg.TILES if t[0] <= m and t[1] <= n
                                for s in (1, 2, 4, 8) if s <= -(-n // t[1])]
                for choice in choices:
                    fn = lambda: call(name, choice, x, wq, w_scale, bias)
                    if not torch.equal(fn(), ref):
                        raise AssertionError(
                            f"{name} {choice} differs at {m}x{k}x{n}")
                    _, device_ms = chip_smoke._time_ms(torch, fn)
                    flushed = chip_smoke._flushed_device_ms(torch, fn, flush)
                    p = qg.plan(m, n, k, x.dtype, *(
                        (True, *choice) if choice else ()))
                    row = {"round": rnd, "build": name, "m": m, "k": k, "n": n,
                           "plan": None if name == "baseline" else {
                               "bm": p.bm, "bn": p.bn, "nsub": p.nsub,
                               "grid": list(p.grid), "smem": p.smem},
                           "chosen": choice is None,
                           "device_ms": device_ms, "device_ms_flushed": flushed,
                           "bound_ms": bound_ms,
                           "bound_share": bound_ms / flushed}
                    print(json.dumps(row), flush=True)
                    if choice is None:
                        acc = sums.setdefault((name, rnd), [0.0, 0.0])
                        acc[0] += device_ms
                        acc[1] += flushed
    bound = sum(
        max(1e3 * (x.numel() * 2 + wq.numel() + 8 * wq.shape[0]
                   + 4 * x.shape[0] * wq.shape[0]) / chip_smoke.HBM_BYTES_S,
            1e3 * 2.0 * x.shape[0] * wq.shape[0] * x.shape[1]
            / chip_smoke.INT8_OPS_S)
        for x, wq, _, _ in shapes)
    for (name, rnd), (dev, fl) in sorted(sums.items()):
        print(json.dumps({"summary": name, "round": rnd, "device_ms": dev,
                          "device_ms_flushed": fl, "bound_ms": bound,
                          "bound_share": bound / fl}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
