#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``evam_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and prints no result line:

1. device   — a CUDA device of compute capability 9.0; prints its name
              and power limit as ``nvidia-smi`` gives them.
2. build    — compiles every kernel under ``evam_tpu_torch/csrc`` with
              nvcc (one process per source, in parallel) into
              ``build/kernels/``, and prints the seconds it took.
3. qgemm    — the int8 GEMM kernel against its plain version at the ten
              shapes one SSD-512 forward gives it (8 images, bf16), the
              three of one classifier forward on 8 × 8 and on 8 crops
              (72², width 32: the largest and smallest engine bucket,
              aligned and masked), the ragged shapes (bf16 and float32:
              every edge of the tiling, K = 2048 whole and in chunks)
              and M = 0: identical int8 codes and row scales, identical
              outputs; the ten SSD shapes must take the aligned variant. Kernel,
              plain-version and library times — wall: median of
              CUDA-event timings of 20 back-to-back calls; device:
              kernel time from torch.profiler, back to back and with
              the L2 flushed before every call — the bound, and
              ``bound_share`` = bound / flushed device time.
              The library yardstick is torch's cheapest correct
              quantize (float32 division by a tensor), ``torch._int_mm``
              and the dequantize; ``_int_mm`` on its own is timed too.
              One JSON line per shape, then the sums over one SSD
              forward, one classifier forward (each bucket) and one
              fused forward (SSD + classifier at 8 × 8 crops).
4. reference — the INT8 detector at a small size (64×64, width 8) and
              the INT8 classifier (width 8) on the card with the kernel
              against the same weights on the CPU through the plain
              version: outputs within 1e-2 of the reference's max
              magnitude.
5. slice    — the port's main path at full width: EVAM_PRECISION=int8,
              EVAM_QGEMM=pallas, person_vehicle_bike at 512×512, width
              32, seeded random weights. STREAMS (8) synthetic 512×512
              streams × FRAMES (32) frames go StreamRunner →
              DetectStage → EngineHub's shared BatchEngine →
              metaconvert → publish. Every frame
              must be published once, in order; the kernel must have
              launched exactly 10 times per forward, all of them on the
              aligned variant; one batch's packed
              output and loc/conf must agree with the same step run with
              the plain qgemm on the card. Prints fps, occupancy, p50/p99
              frame latency and the engine's stage times.
6. classify — the detect+classify pipeline (pipelines/
              object_classification/vehicle_attributes, built as the
              server builds it) at full width: SSD 512² width 32, the
              classifier 72² width 32 with heads color 7 and type 4,
              INT8, pallas. First one batch of 8 frames through the fused
              step with the kernel and with the plain qgemm on the card:
              detections matched (≥ 95 % at IoU ≥ 0.9), the same rows
              unclassified, probabilities within 1e-2. Then STREAMS ×
              FRAMES frames fused (13 launches per forward: the SSD's 10
              and the classifier's 3) and unfused (reclassify-interval
              3: 10 per detect and 3 per classify forward); every frame
              published in order, stream 0's objects carrying color and
              type; masked launches only where the classifier's M is
              ragged. Prints fps, p50/p99, occupancy and unit occupancy.
7. rest     — the same path through the port's REST server
              (``evam_tpu_torch.server.app``) on a free 127.0.0.1 port, in
              a thread: STREAMS POSTs to
              /pipelines/object_detection/person_vehicle_bike, each a
              synthetic 512×512 stream of FRAMES frames into a file
              destination, polled on /pipelines/status until COMPLETED.
              Every file must hold FRAMES lines in timestamp order, each
              of the shape of tests/golden/message_eva_metadata.json;
              /engines must show one shared detect engine; the kernel
              must have launched 10 times per forward, all aligned; stream
              0's objects must match the slice phase's (≥ 95 % at IoU ≥
              0.9); one vehicle_attributes stream of FRAMES frames must
              complete on a fused engine with 13 launches per forward and
              objects carrying color and type; DELETE on a long stream
              must give ABORTED; an unknown pipeline, a body without a
              source and a pipeline of a later slice (object tracking)
              must answer 404, 400 and 501.
              The engine is built and warmed before the clock starts.
8. serve    — the real entry point, ``python3 -m
              evam_tpu_torch.cli.main serve``, as a subprocess on a free
              REST_PORT: /healthz answers 200, one 8-frame
              person_vehicle_bike stream completes with 10 aligned
              launches per forward (the child's counts, read from its
              /metrics), then one 8-frame vehicle_attributes stream with
              13 per fused forward and objects carrying color and type,
              and SIGTERM ends the process with 0 in 30 s.

Then the ``{"kernels": [...]}`` line (times: one fused forward's 13
calls; ``launches`` sums the slice, classify, rest and serve phases,
split by variant in ``launches_by_variant``), the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.

``--phases`` runs a subset (for a quick first check of a new kernel);
``--profile`` adds a shorter profiled run (device busy share, kernel
time by name).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "qgemm", "reference", "slice", "classify", "rest",
          "serve")
KEY = "object_detection/person_vehicle_bike"
CLS_KEY = "object_classification/vehicle_attributes"
#: the detect+classify pipeline (pipelines/<name>/<version>)
CLS_PIPELINE = ("object_classification", "vehicle_attributes")
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense int8 ops/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
#: (M per image, K, N) of the 10 qgemm calls of one SSD-512 forward
MAIN_SHAPES = [
    (16384, 32, 64), (16384, 64, 64), (4096, 64, 128), (4096, 128, 128),
    (1024, 128, 256), (1024, 256, 256), (256, 256, 512), (256, 512, 512),
    (256, 512, 256), (64, 512, 256),
]
IMAGES = 8
#: ROIs a frame's classifier forward takes (the classify stages' budget)
ROI_BUDGET = 8
#: (M per ROI, K, N) of the 3 qgemm calls of one classifier forward
#: (72×72 crops, width 32: the three pointwise convs at 18², 9², 5²)
CLS_SHAPES = [(324, 32, 64), (81, 64, 128), (25, 128, 256)]
#: per-forward sums the qgemm phase prints: the SSD's 10 calls on IMAGES
#: frames, the classifier's 3 on IMAGES × ROI_BUDGET and on ROI_BUDGET
#: crops (the largest and the smallest engine bucket)
FORWARD_GROUPS = ("ssd", f"classifier_b{IMAGES}", "classifier_b1")
#: (M, K, N, x dtype) off the main path: ragged edges, float32 x, M = 0,
#: K = 2048 (the zoo's largest) held whole and in chunks, and a ragged M
#: large enough that each block walks several row tiles
RAGGED_SHAPES = [(130, 32, 130, "bfloat16"), (130, 32, 130, "float32"),
                 (1, 32, 64, "bfloat16"), (77, 40, 3, "bfloat16"),
                 (0, 64, 64, "bfloat16"), (200, 100, 600, "bfloat16"),
                 (5, 2048, 520, "float32"), (1000, 64, 64, "bfloat16"),
                 (3000, 64, 200, "bfloat16"), (512, 2048, 256, "bfloat16"),
                 (2048, 2048, 256, "bfloat16"), (96, 2048, 64, "float32"),
                 (64, 2048, 64, "bfloat16"), (100000, 32, 64, "float32")]
#: bytes read between flushed calls (clean lines, no write-back left
#: for the timed call): five times the H100's 50 MB L2
FLUSH_BYTES = 256 << 20
#: the slice phase's traffic: synthetic 512×512 streams × frames each
STREAMS = 8
FRAMES = 32


def _print(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _import_port():
    """The port's modules this script drives (imports nothing of JAX)."""
    from evam_tpu_torch.engine.hub import EngineHub
    from evam_tpu_torch.engine.steps import build_detect_step
    from evam_tpu_torch.media.source import SyntheticSource
    from evam_tpu_torch.models.registry import ModelRegistry
    from evam_tpu_torch.ops import kernels, qgemm, qlinear
    from evam_tpu_torch.ops.preprocess import preprocess_wire
    from evam_tpu_torch.stages.infer import (
        ENGINE_SCORE_FLOOR,
        DetectStage,
        _wire_frame,
    )
    from evam_tpu_torch.config.settings import Settings
    from evam_tpu_torch.graph import PipelineLoader, resolve_parameters
    from evam_tpu_torch.server.app import App, make_server
    from evam_tpu_torch.server.registry import PipelineRegistry
    from evam_tpu_torch.stages.build import build_stages
    from evam_tpu_torch.stages.meta import MetaconvertStage, PublishStage
    from evam_tpu_torch.stages.runner import StreamRunner

    return dict(
        Settings=Settings, App=App, make_server=make_server,
        PipelineRegistry=PipelineRegistry, PipelineLoader=PipelineLoader,
        resolve_parameters=resolve_parameters, build_stages=build_stages,
        EngineHub=EngineHub, build_detect_step=build_detect_step,
        SyntheticSource=SyntheticSource, ModelRegistry=ModelRegistry,
        kernels=kernels, qgemm=qgemm, qlinear=qlinear,
        DetectStage=DetectStage, wire_frame=_wire_frame,
        ENGINE_SCORE_FLOOR=ENGINE_SCORE_FLOOR,
        MetaconvertStage=MetaconvertStage, PublishStage=PublishStage,
        StreamRunner=StreamRunner, preprocess_wire=preprocess_wire)


def _time_ms(torch, fn, calls: int = 20, rounds: int = 7) -> tuple[float, float]:
    """(wall ms, device ms) per call of ``fn``.

    Wall: the median over ``rounds`` of CUDA-event time around
    ``calls`` back-to-back calls, divided by ``calls`` — what a caller
    issuing them in a row gets, host launch cost included. Device: the
    summed time of the kernels the calls ran (torch.profiler), per call
    — the card's own work, without the gaps the host leaves."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    device_us = 0.0
    for _ in range(3):  # the profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device_us = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        if device_us > 0:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device time")
    return statistics.median(times), device_us / 1e3 / calls


def _flushed_device_ms(torch, fn, flush, calls: int = 20) -> float:
    """Device time per call of the qgemm kernel alone when every call
    finds the L2 cache cold: ``flush`` reads FLUSH_BYTES before each
    call, and only kernels named ``qgemm`` are summed."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        flush()
        fn()
    for _ in range(3):  # the profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "qgemm" in e.key]
        if sum(e.count for e in events) == calls:
            return sum(e.self_device_time_total for e in events) / 1e3 / calls
    raise RuntimeError("torch.profiler did not record every qgemm launch")


def phase_qgemm(torch, port) -> dict:
    """Kernel vs plain version at the main-path and ragged shapes."""
    qg, ql = port["qgemm"], port["qlinear"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    sums = {g: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                "device_ms": 0.0, "device_ms_flushed": 0.0,
                "plain_device_ms": 0.0, "library_device_ms": 0.0,
                "int_mm_ms": 0.0, "int_mm_device_ms": 0.0, "calls": 0,
                "variants": {"aligned": 0, "masked": 0}}
            for g in FORWARD_GROUPS}
    max_err = 0.0
    scratch = torch.ones(FLUSH_BYTES // 4, device="cuda")
    flush = lambda: scratch.sum()
    shapes = [(m * IMAGES, k, n, "ssd", "bfloat16") for m, k, n in MAIN_SHAPES]
    shapes += [(m * b * ROI_BUDGET, k, n, f"classifier_b{b}", "bfloat16")
               for b in (IMAGES, 1) for m, k, n in CLS_SHAPES]
    shapes += [(m, k, n, None, dt) for m, k, n, dt in RAGGED_SHAPES]
    for m, k, n, group, dtype in shapes:
        main = group == "ssd"
        x = torch.randn((m, k), generator=gen, device="cuda").mul_(2.0)
        x = x.to(getattr(torch, dtype))
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.2
        wq, w_scale = ql.quantize_weight(w)
        wq = wq.T.contiguous()
        bias = torch.randn((n,), generator=gen, device="cuda") * 0.1
        before = dict(qg.variant_launches)
        out, codes, scales = qg.qgemm(x, wq, w_scale, bias, return_codes=True)
        variant = [v for v, c in qg.variant_launches.items() if c != before[v]]
        if main and variant != ["aligned"]:
            raise AssertionError(
                f"qgemm {m}x{k}x{n}: main-path shape ran {variant}, not the "
                "aligned tensor-core variant")
        ref = qg.qgemm_reference(x, wq, w_scale, bias)
        torch.cuda.synchronize()
        if m:
            ref_codes, ref_scales = qg.quantize_rows(x)
            if not torch.equal(scales, ref_scales):
                raise AssertionError(f"qgemm {m}x{k}x{n}: row scales differ")
            if not torch.equal(codes, ref_codes):
                bad = (codes != ref_codes).nonzero()[:5].tolist()
                examples = [{
                    "x": x[i, j].item(), "scale": scales[i].item(),
                    "kernel": codes[i, j].item(), "plain": ref_codes[i, j].item(),
                    "quotient_f64": x[i, j].double().item() / scales[i].double().item(),
                } for i, j in bad]
                raise AssertionError(
                    f"qgemm {m}x{k}x{n}: int8 codes differ in "
                    f"{(codes != ref_codes).sum().item()} places: {examples}")
        err = (out - ref).abs().max().item() if m else 0.0
        scale = ref.abs().max().item() if m else 0.0
        if not m and tuple(out.shape) != (0, n):
            raise AssertionError(f"qgemm M = 0: output {tuple(out.shape)}")
        if m and not torch.equal(out, ref):
            raise AssertionError(
                f"qgemm {m}x{k}x{n}: outputs differ, max abs err {err} "
                f"(max |ref| {scale})")
        max_err = max(max_err, err)
        row = {"phase": "qgemm", "m": m, "k": k, "n": n, "dtype": dtype,
               "group": group, "max_abs_err": err, "codes_equal": True,
               "variant": variant[0] if variant else None}
        if m:
            p = qg.plan(m, n, k, x.dtype)
            row["plan"] = {"bm": p.bm, "bn": p.bn, "kc": p.kc,
                           "blocks": p.blocks, "smem": p.smem}
            row["ms"], row["device_ms"] = _time_ms(
                torch, lambda: qg.qgemm(x, wq, w_scale, bias))
            row["device_ms_flushed"] = _flushed_device_ms(
                torch, lambda: qg.qgemm(x, wq, w_scale, bias), flush)
            row["plain_ms"], row["plain_device_ms"] = _time_ms(
                torch, lambda: qg.qgemm_reference(x, wq, w_scale, bias))
            nbytes = x.numel() * x.element_size() + wq.numel() + 4 * n * 2 + 4 * m * n
            bytes_ms = 1e3 * nbytes / HBM_BYTES_S
            ops_ms = 1e3 * 2.0 * m * n * k / INT8_OPS_S
            row.update(bytes=nbytes, ops=2 * m * n * k,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            # set against the flushed time: back-to-back calls on a
            # working set under 50 MB can be served from L2
            row["bound_share"] = row["bound_ms"] / row["device_ms_flushed"]
            row["library_ms"] = None
            if m > 16 and k % 8 == 0 and n % 8 == 0:
                wq_t = wq.T  # [K, N] column-major view of the [N, K] codes

                def quantize():
                    # the row scale rounded exactly (M divisions), then
                    # x / scale as float32 division by a CUDA tensor
                    xf = x.float()
                    sc = torch.clamp(qg.div_rn(
                        xf.abs().amax(1, keepdim=True), 127.0), min=1e-8)
                    return torch.round(xf / sc).clamp_(-127, 127).to(torch.int8), sc

                def library():
                    xc, sc = quantize()
                    acc = torch._int_mm(xc, wq_t)
                    return acc.float() * sc * w_scale + bias

                lib_codes, _ = quantize()
                row["library_codes_equal"] = bool(torch.equal(lib_codes, codes))
                lib_err = (library() - ref).abs().max().item()
                if not row["library_codes_equal"] or lib_err > 1e-6 * max(scale, 1e-30):
                    raise AssertionError(
                        f"library yardstick disagrees at {m}x{k}x{n}: codes "
                        f"{(lib_codes != codes).sum().item()} differ, err {lib_err}")
                row["library_ms"], row["library_device_ms"] = _time_ms(
                    torch, library)
                row["int_mm_ms"], row["int_mm_device_ms"] = _time_ms(
                    torch, lambda: torch._int_mm(lib_codes, wq_t))
                # torch divides by a CPU scalar as a product with its
                # reciprocal: the rows whose scale that rounds otherwise
                amax = x.float().abs().amax(1)
                row["scalar_div_scale_rows_off"] = int(
                    (amax / 127.0 != qg.div_rn(amax, 127.0)).sum())
            if group is not None:
                tot = sums[group]
                for key in ("ms", "plain_ms", "device_ms", "device_ms_flushed",
                            "plain_device_ms", "bound_ms"):
                    tot[key] += row[key]
                tot["bytes_ms"] += bytes_ms
                tot["ops_ms"] += ops_ms
                tot["calls"] += 1
                tot["variants"][row["variant"]] += 1
                lib_keys = ("library_ms", "library_device_ms", "int_mm_ms",
                            "int_mm_device_ms")
                if row["library_ms"] is None:
                    tot.update(dict.fromkeys(lib_keys))
                elif tot["library_ms"] is not None:
                    for key in lib_keys:
                        tot[key] += row[key]
        _print(row)
    del scratch
    # one fused detect+classify forward of IMAGES frames: the SSD's
    # calls and the classifier's on IMAGES × ROI_BUDGET crops
    sums["fused"] = {
        key: (None if sums["ssd"][key] is None
              or sums[f"classifier_b{IMAGES}"][key] is None
              else sums["ssd"][key] + sums[f"classifier_b{IMAGES}"][key])
        for key in sums["ssd"] if key != "variants"}
    for group, tot in sums.items():
        tot["max_abs_err"] = max_err
        tot["bound_share"] = tot["bound_ms"] / tot["device_ms_flushed"]
        tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                           else "operations")
        _print({"phase": "qgemm-forward", "forward": group, **tot})
    return sums


def phase_reference(torch, port) -> None:
    """Small INT8 detector: card (kernel) against CPU (plain version)."""
    kw = dict(dtype="int8", allow_random_weights=True,
              input_overrides={KEY: (64, 64)}, width_overrides={KEY: 8})
    cpu = port["ModelRegistry"](device="cpu", **kw).get(KEY)
    gpu = port["ModelRegistry"](device="cuda", **kw).get(KEY)
    gen = torch.Generator().manual_seed(1)
    x = (torch.rand((4, 64, 64, 3), generator=gen) * 255).to(torch.bfloat16)
    with torch.inference_mode():
        ref = cpu.forward(x)
        got = gpu.forward(x.cuda())
    for name in ("loc", "conf"):
        r = ref[name].float()
        g = got[name].float().cpu()
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"reference phase: bad {name} {tuple(g.shape)}")
        diff = (g - r).abs().max().item()
        scale = r.abs().max().item()
        _print({"phase": "reference", "output": name, "max_abs_diff": diff,
                "max_abs_ref": scale})
        if diff > 1e-2 * scale:
            raise AssertionError(
                f"reference phase: {name} differs by {diff} > 1e-2 x {scale}")
    # the INT8 classifier (width 8) on 72×72 crops, the same way
    kw["width_overrides"] = {CLS_KEY: 8}
    cpu = port["ModelRegistry"](device="cpu", **kw).get(CLS_KEY)
    gpu = port["ModelRegistry"](device="cuda", **kw).get(CLS_KEY)
    x = (torch.rand((16, 72, 72, 3), generator=gen) * 255).to(torch.bfloat16)
    with torch.inference_mode():
        ref = cpu.forward(x)
        got = gpu.forward(x.cuda())
    for name in ("color", "type"):
        r, g = ref[name].float(), got[name].float().cpu()
        diff = (g - r).abs().max().item()
        scale = r.abs().max().item()
        _print({"phase": "reference", "output": name, "max_abs_diff": diff,
                "max_abs_ref": scale})
        if g.shape != r.shape or not torch.isfinite(g).all() \
                or diff > 1e-2 * scale:
            raise AssertionError(
                f"reference phase: {name} differs by {diff} > 1e-2 x {scale}")


def _match_rate(ref, got, iou_min=0.9) -> float:
    """Share of ref's valid detections matched by a got detection of the
    same label with IoU ≥ iou_min (packed rows, one frame)."""
    import numpy as np

    r = ref[ref[:, 6] > 0.5]
    g = got[got[:, 6] > 0.5]
    if len(r) == 0:
        return 1.0
    hit = 0
    for row in r:
        same = g[g[:, 5] == row[5]]
        if len(same) == 0:
            continue
        lt = np.maximum(row[:2], same[:, :2])
        rb = np.minimum(row[2:4], same[:, 2:4])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
        area = lambda b: np.prod(np.clip(b[..., 2:4] - b[..., :2], 0, None), axis=-1)
        iou = inter / np.maximum(area(row) + area(same) - inter, 1e-9)
        hit += bool((iou >= iou_min).any())
    return hit / len(r)


def _detect_stages(port, hub):
    """Stage factory of the slice phase: detect → metaconvert → publish."""
    def make(uri, publish):
        return [port["DetectStage"]("detect", KEY, {"threshold": 0.2}, hub),
                port["MetaconvertStage"]("meta", source_uri=uri),
                port["PublishStage"]("publish", publish)]
    return make


def _serve(port, make_stages, streams: int, frames: int, h: int, w: int,
           objects: dict | None = None):
    """Serve ``streams`` synthetic streams of ``frames`` frames each,
    one thread per stream, through the stages ``make_stages(uri,
    publish)`` builds for each (their engines shared). Returns
    (runners, published seqs per stream, wall seconds, threads); stream
    s0's published objects land in ``objects`` (seq → list), if given."""
    published: dict[str, list[int]] = {}
    lock = threading.Lock()

    def publish(ctx):
        with lock:
            published.setdefault(ctx.stream_id, []).append(ctx.seq)
            if objects is not None and ctx.stream_id == "s0":
                objects[ctx.seq] = ctx.metadata["objects"]

    runners = []
    for s in range(streams):
        uri = f"synthetic://{w}x{h}@30?count={frames}&seed={s}"
        stages = make_stages(uri, publish)
        runners.append((port["StreamRunner"](f"s{s}", stages, uri),
                        port["SyntheticSource"].from_uri(uri)))
    t0 = time.perf_counter()
    threads = [threading.Thread(target=r.run, args=(src.frames(),))
               for r, src in runners]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return [r for r, _ in runners], published, time.perf_counter() - t0, threads


def _profile_serve(torch, port, hub, streams, frames, h, w) -> dict:
    """Device busy share and kernel time by name over a served run
    (torch.profiler; a second, shorter run — the profiler slows the
    host that issues the launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall, _ = _serve(port, _detect_stages(port, hub), streams,
                               frames, h, w)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:  # names cut to 80 characters can collide: sum them
        name = e.key[:80]
        by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"phase": "slice-profile", "wall_s": wall,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels_ms": dict(top)}


def _warm_engine(torch, port, hub):
    """Build the hub's shared detect engine (the one a detect stage
    takes) and run every bucket a run of STREAMS streams can use once,
    through its step alone (cuDNN and allocator set-up; the engine's
    batch counts do not move)."""
    model = hub.model(KEY)
    h, w = model.preprocess.height, model.preprocess.width
    engine = hub.engine("detect", KEY,
                        score_threshold=port["ENGINE_SCORE_FLOOR"])
    wire = port["wire_frame"](
        next(port["SyntheticSource"](w, h, count=1).frames()).frame,
        (h, w), "i420")
    for b in engine.buckets:
        if b <= STREAMS * 4:
            engine.step_fn(torch.from_numpy(
                wire[None].repeat(b, 0)).cuda()).cpu()
    torch.cuda.synchronize()
    return engine


def phase_slice(torch, port, profile: bool = False) -> dict:
    """The main path at full width, served to STREAMS streams."""
    import numpy as np

    qg, ql = port["qgemm"], port["qlinear"]
    if ql.QGEMM_BACKEND != "pallas":
        raise AssertionError("EVAM_QGEMM=pallas did not reach ops/qlinear.py")
    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    if registry.precision != "INT8":
        raise AssertionError("EVAM_PRECISION=int8 did not select INT8")
    hub = port["EngineHub"](registry, device="cuda")
    try:
        model = hub.model(KEY)
        h, w = model.preprocess.height, model.preprocess.width
        # warm every bucket the run can use, then count from zero
        engine = _warm_engine(torch, port, hub)

        qg.launches = 0
        qg.variant_launches.update(aligned=0, masked=0)
        batches0 = engine.stats_row()["batches"]
        s0_objects: dict[int, list] = {}
        runners, published, wall, threads = _serve(
            port, _detect_stages(port, hub), STREAMS, FRAMES, h, w, s0_objects)
        launches = qg.launches
        masked = qg.variant_launches["masked"]
        stats = engine.stats_row()
        forwards = stats["batches"] - batches0

        if any(t.is_alive() for t in threads):
            raise AssertionError("slice phase: a stream did not finish")
        errors = sum(r.errors for r in runners)
        if errors:
            raise AssertionError(f"slice phase: {errors} frame errors")
        for s in range(STREAMS):
            seqs = published.get(f"s{s}", [])
            if seqs != list(range(FRAMES)):
                raise AssertionError(
                    f"slice phase: stream s{s} published {len(seqs)} of "
                    f"{FRAMES} frames (in order: {seqs == sorted(seqs)})")
        if launches != 10 * forwards or forwards == 0:
            raise AssertionError(
                f"slice phase: {launches} qgemm launches for {forwards} "
                "forwards, expected 10 per forward")
        if masked:
            raise AssertionError(
                f"slice phase: {masked} qgemm launches took the masked variant")

        # one batch again, kernel against plain qgemm on the card
        batch = torch.from_numpy(np.stack([
            port["wire_frame"](ev.frame, (h, w), "i420")
            for s in range(IMAGES)
            for ev in port["SyntheticSource"](w, h, count=1, seed=s).frames()
        ])).cuda()
        step = engine.step_fn
        with torch.inference_mode():
            x = port["preprocess_wire"](batch, dataclasses.replace(
                model.preprocess, wire_format="i420"))
            packed_k = step(batch).cpu().numpy()
            raw_k = {k: v.float().cpu() for k, v in model.forward(x).items()}
            ql.qgemm = qg.qgemm_reference
            try:
                packed_p = step(batch).cpu().numpy()
                raw_p = {k: v.float().cpu() for k, v in model.forward(x).items()}
            finally:
                ql.qgemm = qg.qgemm
        check = {"phase": "slice-check"}
        for name in ("loc", "conf"):
            d = (raw_k[name] - raw_p[name]).abs().max().item()
            scale = raw_p[name].abs().max().item()
            check[f"{name}_max_abs_diff"] = d
            check[f"{name}_max_abs_ref"] = scale
            if not torch.isfinite(raw_k[name]).all() or d > 1e-2 * scale:
                raise AssertionError(f"slice check: {name} differs by {d}")
        rates = [_match_rate(packed_p[i], packed_k[i]) for i in range(IMAGES)]
        check["packed_equal"] = bool((packed_k == packed_p).all())
        check["detections_matched"] = min(rates)
        check["valid_per_frame"] = float((packed_p[..., 6] > 0.5).sum(-1).mean())
        if packed_k.shape != (IMAGES, 32, 7) or min(rates) < 0.95:
            raise AssertionError(f"slice check failed: {check}")
        _print(check)

        lat = sorted(x for r in runners for x in r.latencies)
        q = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]
        row = {"phase": "slice", "streams": STREAMS, "frames_per_stream": FRAMES,
               "frames": len(lat), "wall_s": wall, "fps": len(lat) / wall,
               "forwards": forwards, "qgemm_launches": launches,
               "mean_occupancy": stats["mean_occupancy"],
               "bucket_batches": stats["bucket_batches"],
               "p50_ms": 1e3 * q(0.50), "p99_ms": 1e3 * q(0.99),
               "stage_ms": stats["stage_ms"],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        _print(row)
        if profile:
            _print(_profile_serve(torch, port, hub, STREAMS, 8, h, w))
        return {"launches": launches, "input_hw": (h, w),
                "width": model.spec.width, "s0_objects": s0_objects}
    finally:
        hub.stop()


def _pipeline_stages(port, hub, params: dict):
    """Stage factory of the classify phase: the vehicle_attributes
    pipeline, its parameters bound and its stages built as the REST
    server builds them (``stages/build.py``, fusion pass included)."""
    spec = port["PipelineLoader"](ROOT / "pipelines").get(*CLS_PIPELINE)
    stage_specs, _ = port["resolve_parameters"](spec, params)

    def make(uri, publish):
        return port["build_stages"](stage_specs, hub, source_uri=uri,
                                    publish_fn=publish)
    return make


def _crop_boxes(torch, gen, b: int):
    """[b, ROI_BUDGET, 4] valid normalized boxes on the card."""
    p = torch.rand((b, ROI_BUDGET, 2, 2), generator=gen, device="cuda")
    return torch.cat([p.amin(2), p.amax(2)], -1)


def _warm_stage_engines(torch, port, stages) -> None:
    """Run every bucket a run of STREAMS streams can use once through
    the step of each engine the stages hold (cuDNN and allocator
    set-up; the engines' batch counts do not move)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    for stage in stages:
        engine = getattr(stage, "engine", None)
        if engine is None:
            continue
        h, w = stage.ingest_size
        wire = torch.from_numpy(port["wire_frame"](
            next(port["SyntheticSource"](w, h, count=1).frames()).frame,
            (h, w), "i420")).cuda()
        for b in engine.buckets:
            if b > STREAMS * 4:
                break
            frames = wire[None].repeat(b, 1, 1)
            args = ((frames,) if engine.input_names == ("frames",)
                    else (frames, _crop_boxes(torch, gen, b)))
            engine.step_fn(*args).cpu()
    torch.cuda.synchronize()


def _attributed(objects: list[dict]) -> int:
    """Objects that carry both vehicle attributes, each with a finite
    confidence and a label."""
    n = 0
    for obj in objects:
        if all(isinstance(obj.get(a), dict) for a in ("color", "type")):
            for a in ("color", "type"):
                if not (math.isfinite(obj[a]["confidence"])
                        and isinstance(obj[a]["label"], str)):
                    raise AssertionError(f"bad attribute {a}: {obj[a]}")
            n += 1
    return n


def _check_fused_kernel_path(torch, port, stage) -> None:
    """One batch of IMAGES frames through the fused step, with the
    kernel and with the plain qgemm on the card: the same detections
    (≥ 95 % matched at IoU ≥ 0.9), the same rows left unclassified, and
    probability blocks within 1e-2 (bf16 activations; cuDNN may take
    another algorithm between the two calls)."""
    import numpy as np

    qg, ql = port["qgemm"], port["qlinear"]
    h, w = stage.ingest_size
    batch = torch.from_numpy(np.stack([
        port["wire_frame"](ev.frame, (h, w), "i420")
        for s in range(IMAGES)
        for ev in port["SyntheticSource"](w, h, count=1, seed=s).frames()
    ])).cuda()
    step = stage.engine.step_fn
    before = qg.launches
    packed_k = step(batch).cpu().numpy()
    if qg.launches - before != 13:
        raise AssertionError(f"classify check: {qg.launches - before} qgemm "
                             "launches in one fused forward, expected 13")
    ql.qgemm = qg.qgemm_reference
    try:
        packed_p = step(batch).cpu().numpy()
    finally:
        ql.qgemm = qg.qgemm
    if packed_k.shape != (IMAGES, 32, 18) or not np.isfinite(packed_k).all():
        raise AssertionError(f"classify check: output {packed_k.shape}")
    rates = [_match_rate(packed_p[i, :, :7], packed_k[i, :, :7])
             for i in range(IMAGES)]
    same = ((packed_k[..., 6] == packed_p[..., 6])
            & (packed_k[..., 5] == packed_p[..., 5])
            & (np.abs(packed_k[..., :4] - packed_p[..., :4]).max(-1) <= 1e-3))
    cls_k = packed_k[..., 7:].sum(-1) > 0.5
    cls_p = packed_p[..., 7:].sum(-1) > 0.5
    diff = float(np.abs(packed_k[..., 7:] - packed_p[..., 7:])[same].max())
    check = {"phase": "classify-check", "packed_equal":
             bool((packed_k == packed_p).all()),
             "detections_matched": min(rates),
             "rows_same": float(same.mean()),
             "classified_per_frame": float(cls_p.sum(-1).mean()),
             "unclassified_rows_equal": bool((cls_k[same] == cls_p[same]).all()),
             "prob_max_abs_diff": diff}
    unclassified_zero = bool((packed_k[~cls_k][:, 7:] == 0).all())
    if (min(rates) < 0.95 or not check["unclassified_rows_equal"]
            or diff > 1e-2 or not cls_p.any() or not unclassified_zero):
        raise AssertionError(f"classify check failed: {check}")
    _print(check)


def phase_classify(torch, port) -> dict:
    """The detect+classify pipeline at full width, served to STREAMS
    streams in this process: fused, then unfused."""
    qg = port["qgemm"]
    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    hub = port["EngineHub"](registry, device="cuda")
    total = {"aligned": 0, "masked": 0}
    try:
        det, cls = hub.model(KEY), hub.model(CLS_KEY)
        for mode, extra in (("fused", {}),
                            ("unfused", {"reclassify-interval": 3})):
            make = _pipeline_stages(port, hub, {"detection-threshold": 0.2,
                                                **extra})
            stages = make("warm", None)
            kinds = [type(st).__name__ for st in stages]
            engines = {e.name.split(":")[0]: e for e in
                       (getattr(st, "engine", None) for st in stages) if e}
            want = (["detect_classify"] if mode == "fused"
                    else ["detect", "classify"])
            if list(engines) != want:
                raise AssertionError(f"classify {mode}: stages {kinds}")
            _warm_stage_engines(torch, port, stages)
            if mode == "fused":
                _check_fused_kernel_path(torch, port, stages[0])
            batches0 = {k: e.stats_row()["batches"] for k, e in engines.items()}
            qg.launches = 0
            qg.variant_launches.update(aligned=0, masked=0)
            s0_objects: dict[int, list] = {}
            runners, published, wall, threads = _serve(
                port, make, STREAMS, FRAMES, 512, 512, s0_objects)
            launches = qg.launches
            variants = dict(qg.variant_launches)
            rows = {k: e.stats_row() for k, e in engines.items()}
            fwd = {k: rows[k]["batches"] - batches0[k] for k in engines}

            if any(t.is_alive() for t in threads):
                raise AssertionError(f"classify {mode}: a stream did not finish")
            errors = sum(r.errors for r in runners)
            if errors:
                raise AssertionError(f"classify {mode}: {errors} frame errors")
            for s in range(STREAMS):
                if published.get(f"s{s}", []) != list(range(FRAMES)):
                    raise AssertionError(
                        f"classify {mode}: stream s{s} published "
                        f"{len(published.get(f's{s}', []))} of {FRAMES}")
            per = ({"detect_classify": 13} if mode == "fused"
                   else {"detect": 10, "classify": 3})
            want_launches = sum(per[k] * fwd[k] for k in per)
            # only the classifier's calls can be ragged: at small buckets
            # its M (bucket × 8 × {324, 81, 25}) leaves the tiling
            cls_fwd = fwd.get("detect_classify", 0) + fwd.get("classify", 0)
            if (not all(fwd.values()) or launches != want_launches
                    or variants["masked"] > 3 * cls_fwd):
                raise AssertionError(
                    f"classify {mode}: {launches} qgemm launches {variants} "
                    f"for forwards {fwd}, expected {per} per forward")
            objects = [o for objs in s0_objects.values() for o in objs]
            attributed = _attributed(objects)
            if not attributed:
                raise AssertionError(f"classify {mode}: no object of stream 0 "
                                     f"carries color and type ({len(objects)})")
            lat = sorted(x for r in runners for x in r.latencies)
            q = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]
            _print({"phase": "classify", "mode": mode, "streams": STREAMS,
                    "frames": len(lat), "wall_s": wall, "fps": len(lat) / wall,
                    "p50_ms": 1e3 * q(0.50), "p99_ms": 1e3 * q(0.99),
                    "forwards": fwd, "qgemm_launches": launches,
                    "variants": variants,
                    "s0_objects": len(objects), "s0_attributed": attributed,
                    "occupancy": {k: r["mean_occupancy"] for k, r in rows.items()},
                    "unit_occupancy": {k: r["unit_occupancy"]
                                       for k, r in rows.items()},
                    "bucket_batches": {k: r["bucket_batches"]
                                       for k, r in rows.items()},
                    "stage_ms": {k: r["stage_ms"] for k, r in rows.items()}})
            for v in total:
                total[v] += variants[v]
        return {"variants": total, "models": (
            det.preprocess.height, det.preprocess.width, det.spec.width,
            cls.preprocess.height, cls.preprocess.width, cls.spec.width,
            cls.spec.heads)}
    finally:
        hub.stop()


#: published-metadata golden (read only) and the routes the rest phase
#: drives
GOLDEN = ROOT / "tests" / "golden" / "message_eva_metadata.json"
PIPELINE = "/pipelines/" + KEY
_UUID_RE = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")
_ENUM_RE = re.compile(r"^[A-Za-z0-9_\-/. :=,]{1,64}$")


def canonical(obj):
    """The golden files' canonical form (a copy of
    ``tests/test_golden.py::canonical``): keys and enum strings
    literal, volatile values as typed placeholders, a list as its first
    element."""
    if isinstance(obj, dict):
        return {k: canonical(obj[k]) for k in sorted(obj)}
    if isinstance(obj, list):
        return [canonical(obj[0])] if obj else []
    if isinstance(obj, bool):
        return "<bool>"
    if isinstance(obj, (int, float)):
        return "<num>"
    if isinstance(obj, str):
        if _UUID_RE.match(obj):
            return "<uuid>"
        if _ENUM_RE.match(obj):
            return obj
        return "<str>"
    if obj is None:
        return None
    return f"<{type(obj).__name__}>"


def _shape_errors(got, want, path="$") -> list[str]:
    """Where a canonical message ``got`` leaves the golden's shape
    ``want``: the same keys, ``<num>`` where it has one, and a string
    where it has a string — a label is data, so any label passes."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [f"{path}: {got}"]
        return [e for k in want for e in _shape_errors(got[k], want[k],
                                                       f"{path}.{k}")]
    if isinstance(want, list):
        if not isinstance(got, list):
            return [f"{path}: not a list"]
        return [e for g in got for e in _shape_errors(g, want[0], path + "[]")]
    if want == "<num>":
        return [] if got == "<num>" else [f"{path}: {got!r}"]
    return [] if isinstance(got, str) and not got.startswith("<") or \
        got == "<str>" else [f"{path}: {got!r}"]


#: the attribute keys a classified object adds to the golden's shape
ATTRIBUTES = ("color", "type")


def _line_errors(msg: dict, golden: dict) -> list[str]:
    """A published line against the golden, object by object (the
    canonical form keeps only a list's first element), with finite
    numbers; vehicle attributes are checked apart (``_attributed``)."""
    msg = dict(msg, objects=[{k: v for k, v in o.items() if k not in ATTRIBUTES}
                             for o in msg.get("objects", [])])
    errors = _shape_errors(canonical(msg), golden)
    for obj in msg["objects"]:
        errors += _shape_errors(canonical(obj), golden["objects"][0],
                                "$.objects[]")
        numbers = [obj["detection"]["confidence"],
                   *obj["detection"]["bounding_box"].values()]
        if not all(math.isfinite(x) for x in numbers):
            errors.append(f"not finite: {numbers}")
    return errors


def _http(base: str, method: str, path: str, body=None):
    """(status, JSON body) of one request to the port's server."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _wait_states(base: str, ids, states, timeout: float) -> dict:
    """Poll /pipelines/status until every id is in one of ``states``."""
    deadline = time.perf_counter() + timeout
    while True:
        _, rows = _http(base, "GET", "/pipelines/status")
        by_id = {r["id"]: r for r in rows if r["id"] in ids}
        if len(by_id) == len(ids) and all(
                r["state"] in states for r in by_id.values()):
            return by_id
        if time.perf_counter() > deadline:
            raise AssertionError(
                f"instances not {states} after {timeout} s: "
                f"{[(r['id'][:8], r['state'], r.get('message')) for r in by_id.values()]}")
        time.sleep(0.05)


def _stream_body(out: Path, count: int | None, seed: int,
                 threshold: str = "threshold") -> dict:
    """A synthetic 512² stream into a file; ``threshold`` names the
    pipeline's detection-threshold parameter."""
    query = f"seed={seed}" if count is None else f"count={count}&seed={seed}"
    return {"source": {"uri": f"synthetic://512x512@30?{query}",
                       "type": "uri"},
            "destination": {"metadata": {"type": "file", "path": str(out)}},
            "parameters": {threshold: 0.2}}


CLS_PATH = "/pipelines/{}/{}".format(*CLS_PIPELINE)


def _classify_stream(base: str, out: Path, count: int, golden: dict,
                     where: str) -> tuple[str, int]:
    """POST one vehicle_attributes stream and wait for it: ``count``
    lines of the golden's shape, in order, some objects classified.
    Returns (its fused engine's name, its objects with attributes)."""
    status, iid = _http(base, "POST", CLS_PATH, _stream_body(
        out, count, 0, "detection-threshold"))
    if status != 200:
        raise AssertionError(f"{where}: vehicle_attributes POST gave {status} "
                             f"{iid}")
    state = _wait_states(base, [iid], ("COMPLETED", "ERROR", "ABORTED"),
                         300)[iid]
    lines = ([json.loads(x) for x in out.read_text().splitlines()]
             if out.exists() else [])
    stamps = [m["timestamp"] for m in lines]
    if state["state"] != "COMPLETED" or len(lines) != count \
            or stamps != sorted(stamps):
        raise AssertionError(f"{where}: vehicle_attributes {state['state']}, "
                             f"{len(lines)} lines")
    for m in lines:
        errors = _line_errors(m, golden)
        if errors:
            raise AssertionError(f"{where}: vehicle_attributes line off the "
                                 f"golden's shape: {errors[:3]}")
    attributed = sum(_attributed(m["objects"]) for m in lines)
    if not attributed:
        raise AssertionError(f"{where}: no vehicle_attributes object carries "
                             "color and type")
    engine = state["weights"]["detection+classification"]["engine"]
    return engine, attributed


def _rows(objects: list[dict]):
    """Published objects → packed detect rows (x0, y0, x1, y1, score,
    label_id, valid) for ``_match_rate``."""
    import numpy as np

    return np.asarray([[o["detection"]["bounding_box"][k] for k in
                        ("x_min", "y_min", "x_max", "y_max")]
                       + [o["detection"]["confidence"],
                          o["detection"]["label_id"], 1.0]
                       for o in objects], np.float64).reshape(-1, 7)


def phase_rest(torch, port, slice_objects: dict[int, list]) -> dict[str, int]:
    """The main path through the port's REST server, in this process,
    then one vehicle_attributes stream. Returns the qgemm launches by
    variant."""
    qg = port["qgemm"]
    golden = json.loads(GOLDEN.read_text())  # canonical already
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        settings = port["Settings"].from_env(env={
            "EVAM_PRECISION": "int8", "EVAM_ALLOW_RANDOM_WEIGHTS": "1",
            "PIPELINES_DIR": str(ROOT / "pipelines"),
            "MODELS_DIR": str(tmp / "models")})
        registry = port["PipelineRegistry"](settings)
        server = port["make_server"](port["App"](registry), "127.0.0.1", 0)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            # the model and engine are built and warmed before the clock
            # starts, as in the slice phase
            t_warm = time.perf_counter()
            engine = _warm_engine(torch, port, registry.hub)
            warm_s = time.perf_counter() - t_warm
            batches0 = engine.stats_row()["batches"]
            qg.launches = 0
            qg.variant_launches.update(aligned=0, masked=0)
            t0 = time.perf_counter()
            ids = []
            for s in range(STREAMS):
                status, iid = _http(base, "POST", PIPELINE, _stream_body(
                    tmp / f"s{s}.jsonl", FRAMES, s))
                if status != 200:
                    raise AssertionError(f"rest: POST {s} gave {status} {iid}")
                ids.append(iid)
            done = _wait_states(base, ids, ("COMPLETED", "ERROR", "ABORTED"),
                                timeout=600)
            wall = time.perf_counter() - t0
            launches = qg.launches
            masked = qg.variant_launches["masked"]
            bad = {i[:8]: (r["state"], r.get("message"))
                   for i, r in done.items() if r["state"] != "COMPLETED"}
            if bad:
                raise AssertionError(f"rest: instances did not complete: {bad}")
            _, engines = _http(base, "GET", "/engines")
            _, health = _http(base, "GET", "/healthz")
            if list(engines) != [f"detect:{KEY}"]:
                raise AssertionError(f"rest: engines {list(engines)}, "
                                     "expected one shared detect engine")
            row = engines[f"detect:{KEY}"]
            forwards = row["batches"] - batches0
            if forwards == 0 or launches != 10 * forwards or masked:
                raise AssertionError(
                    f"rest: {launches} qgemm launches ({masked} masked) for "
                    f"{forwards} forwards, expected 10 aligned per forward")

            frames = 0
            n_objects = 0
            for s in range(STREAMS):
                lines = [json.loads(x) for x in
                         (tmp / f"s{s}.jsonl").read_text().splitlines()]
                stamps = [m["timestamp"] for m in lines]
                if len(lines) != FRAMES or stamps != sorted(stamps):
                    raise AssertionError(
                        f"rest: stream {s} published {len(lines)} lines, "
                        f"in timestamp order: {stamps == sorted(stamps)}")
                for m in lines:
                    errors = _line_errors(m, golden)
                    if errors:
                        raise AssertionError(f"rest: stream {s} line off the "
                                             f"golden's shape: {errors[:3]}")
                    n_objects += len(m["objects"])
                frames += len(lines)
                if s == 0:
                    rates = [_match_rate(_rows(slice_objects[i]),
                                         _rows(m["objects"]))
                             for i, m in enumerate(lines)]
            if not any(slice_objects.values()) or min(rates) < 0.95:
                raise AssertionError(
                    f"rest: stream 0 matches the slice run at {min(rates)} "
                    f"({sum(map(len, slice_objects.values()))} objects)")

            # one detect+classify stream: the fused engine, 13 launches
            # per forward, some of them masked at small buckets
            qg.launches = 0
            qg.variant_launches.update(aligned=0, masked=0)
            fused, attributed = _classify_stream(
                base, tmp / "cls.jsonl", FRAMES, golden, "rest")
            _, engines = _http(base, "GET", "/engines")
            cls_fwd = engines[fused]["batches"]
            cls_variants = dict(qg.variant_launches)
            if (cls_fwd == 0 or qg.launches != 13 * cls_fwd
                    or cls_variants["masked"] > 3 * cls_fwd):
                raise AssertionError(
                    f"rest: {qg.launches} qgemm launches {cls_variants} for "
                    f"{cls_fwd} fused forwards, expected 13 per forward")

            # a long ninth stream, deleted while it runs
            status, long_id = _http(base, "POST", PIPELINE, _stream_body(
                tmp / "long.jsonl", None, 9))
            if status != 200:
                raise AssertionError(f"rest: long POST gave {status} {long_id}")
            deadline = time.perf_counter() + 120
            while not (tmp / "long.jsonl").exists() or \
                    not (tmp / "long.jsonl").read_text():
                if time.perf_counter() > deadline:
                    raise AssertionError("rest: the long stream published nothing")
                time.sleep(0.05)
            status, _ = _http(base, "DELETE", f"{PIPELINE}/{long_id}")
            final = _wait_states(base, [long_id],
                                 ("COMPLETED", "ERROR", "ABORTED"), 60)
            if status != 200 or final[long_id]["state"] != "ABORTED":
                raise AssertionError(f"rest: DELETE gave {status}, state "
                                     f"{final[long_id]['state']}")

            errors = {
                "404": _http(base, "GET", "/pipelines/object_detection/nope"),
                "400": _http(base, "POST", PIPELINE, {"destination": {}}),
                "501": _http(base, "POST",
                             "/pipelines/object_tracking/person_vehicle_bike",
                             {"source": {"uri": "synthetic://512x512@30?count=4",
                                         "type": "uri"}}),
            }
            for want, (status, body) in errors.items():
                if str(status) != want or "error" not in body:
                    raise AssertionError(f"rest: expected {want}, got "
                                         f"{status} {body}")
            _, engines_after = _http(base, "GET", "/engines")
            if sorted(engines_after) != sorted([f"detect:{KEY}", fused]):
                raise AssertionError(f"rest: engines {list(engines_after)} "
                                     "after the error requests")
            result = {
                "phase": "rest", "streams": STREAMS, "frames": frames,
                "objects": n_objects, "warm_s": warm_s, "wall_s": wall,
                "fps": frames / wall,
                "avg_fps": [done[i]["avg_fps"] for i in ids],
                "forwards": forwards, "qgemm_launches": launches,
                "mean_occupancy": row["mean_occupancy"],
                "bucket_batches": row["bucket_batches"],
                "host_stages_ms": health["host_stages_ms"],
                "match_rate_s0": min(rates),
                "vehicle_attributes": {
                    "engine": fused, "forwards": cls_fwd,
                    "qgemm_launches": sum(cls_variants.values()),
                    "variants": cls_variants, "attributed_objects": attributed,
                    "occupancy": engines[fused]["mean_occupancy"]},
                "errors": {k: v[1]["error"] for k, v in errors.items()}}
            _print(result)
            return {"aligned": launches + cls_variants["aligned"],
                    "masked": cls_variants["masked"]}
        finally:
            server.shutdown()
            server.server_close()
            registry.stop_all()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _kernel_launches(base: str) -> dict[str, int]:
    """The server's qgemm launches by variant, read from /metrics."""
    with urllib.request.urlopen(base + "/metrics", timeout=120) as resp:
        text = resp.read().decode()
    found = dict(re.findall(
        r'^evam_kernel_launches\{kernel="qgemm",variant="(\w+)"\} (\S+)$',
        text, re.M))
    if set(found) != {"aligned", "masked"}:
        raise AssertionError(f"/metrics has no qgemm launch counts: {found}")
    return {k: int(float(v)) for k, v in found.items()}


def phase_serve() -> dict[str, int]:
    """``python3 -m evam_tpu_torch.cli.main serve`` as a user starts it:
    a person_vehicle_bike stream, then a vehicle_attributes stream.
    Returns the child's qgemm launches by variant."""
    golden = json.loads(GOLDEN.read_text())
    rest_port = _free_port()
    base = f"http://127.0.0.1:{rest_port}"
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, REST_PORT=str(rest_port),
                   EVAM_PRECISION="int8", EVAM_QGEMM="pallas",
                   EVAM_ALLOW_RANDOM_WEIGHTS="1",
                   MODELS_DIR=str(Path(tmp) / "models"))
        log_path = Path(tmp) / "serve.log"
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve"],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        try:
            while True:
                try:
                    status, _ = _http(base, "GET", "/healthz")
                    if status == 200:
                        break
                except OSError:
                    pass
                if proc.poll() is not None or time.perf_counter() - t0 > 120:
                    raise AssertionError(
                        f"serve: no /healthz (exit {proc.poll()}): "
                        f"{log_path.read_text()[-2000:]}")
                time.sleep(0.2)
            up_s = time.perf_counter() - t0
            out = Path(tmp) / "serve.jsonl"
            status, iid = _http(base, "POST", PIPELINE,
                                _stream_body(out, 8, 0))
            if status != 200:
                raise AssertionError(f"serve: POST gave {status} {iid}")
            state = _wait_states(base, [iid], ("COMPLETED", "ERROR",
                                               "ABORTED"), 300)[iid]
            lines = out.read_text().splitlines() if out.exists() else []
            if state["state"] != "COMPLETED" or len(lines) != 8:
                raise AssertionError(f"serve: {state}, {len(lines)} lines")
            # the child's forwards show on /engines, its kernel
            # launches (as its wrapper counts them) on /metrics
            _, engines = _http(base, "GET", "/engines")
            forwards = sum(v["batches"] for v in engines.values())
            launches = _kernel_launches(base)
            if forwards == 0 or launches["aligned"] != 10 * forwards \
                    or launches["masked"]:
                raise AssertionError(
                    f"serve: qgemm launches {launches} for {forwards} "
                    "forwards, expected 10 aligned per forward")
            # then the detect+classify pipeline through the same server
            fused, attributed = _classify_stream(
                base, Path(tmp) / "cls.jsonl", 8, golden, "serve")
            _, engines = _http(base, "GET", "/engines")
            total = _kernel_launches(base)
            cls_fwd = engines[fused]["batches"]
            det_fwd = engines[f"detect:{KEY}"]["batches"]
            if (cls_fwd == 0 or det_fwd != forwards
                    or sum(total.values()) != 10 * det_fwd + 13 * cls_fwd
                    or total["masked"] > 3 * cls_fwd):
                raise AssertionError(
                    f"serve: qgemm launches {total} for {det_fwd} detect and "
                    f"{cls_fwd} fused forwards, expected 10 and 13 per forward")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=30)
            if code != 0:
                raise AssertionError(f"serve: exit {code} on SIGTERM: "
                                     f"{log_path.read_text()[-2000:]}")
            _print({"phase": "serve", "up_s": up_s,
                    "streams_s": t1 - t0 - up_s, "frames": len(lines),
                    "forwards": {k: v["batches"] for k, v in engines.items()},
                    "qgemm_launches": total, "avg_fps": state["avg_fps"],
                    "attributed_objects": attributed,
                    "exit_code": code, "stop_s": time.perf_counter() - t1})
            return total
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="after the slice run, profile a shorter one")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if "rest" in phases and "slice" not in phases:
        ap.error("the rest phase checks its objects against the slice phase")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "evam_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # the slice's configuration, set before the port reads its knobs
    os.environ["EVAM_PRECISION"] = "int8"
    os.environ["EVAM_QGEMM"] = "pallas"
    port = _import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs a compute capability 9.0 device, got {cap}",
              file=sys.stderr)
        return 1
    smi = _nvidia_smi()
    _print({"phase": "device", "name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = port["kernels"].build()
    _print({"phase": "build", "seconds": time.perf_counter() - t0,
            "kernels": {k: v["seconds"] for k, v in built.items()}})

    kernel = {"name": "qgemm", "route": "cuda",
              "source": "evam_tpu_torch/csrc/qgemm.cu",
              "replaces": "evam_tpu/ops/pallas_qgemm.py:33",
              "launches": None, "max_abs_err": None, "ms": None,
              "plain_ms": None, "bound_ms": None, "bound_by": None,
              "library_ms": None, "device_ms": None, "bound_share": None,
              "launches_by_variant": None, "forward": None}
    if "qgemm" in phases:
        fused = phase_qgemm(torch, port)["fused"]
        kernel.update({k: fused[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "bound_share")})
        kernel["forward"] = (f"one fused detect+classify forward of {IMAGES} "
                             f"frames: {len(MAIN_SHAPES)} SSD calls and "
                             f"{len(CLS_SHAPES)} classifier calls on "
                             f"{IMAGES * ROI_BUDGET} crops")
    served = []  # qgemm launches by variant, one entry per serving phase
    if "reference" in phases:
        phase_reference(torch, port)
    if "slice" in phases:
        res = phase_slice(torch, port, profile=args.profile)
        if res["input_hw"] != (512, 512) or res["width"] != 32:
            raise AssertionError(f"slice ran {res['input_hw']} width "
                                 f"{res['width']}, not the full-width model")
        served.append({"aligned": res["launches"], "masked": 0})
    if "classify" in phases:
        res_cls = phase_classify(torch, port)
        if res_cls["models"] != (512, 512, 32, 72, 72, 32,
                                 (("color", 7), ("type", 4))):
            raise AssertionError(f"classify ran {res_cls['models']}, not the "
                                 "full-width models")
        served.append(res_cls["variants"])
    if "rest" in phases:
        served.append(phase_rest(torch, port, res["s0_objects"]))
    if "serve" in phases:
        served.append(phase_serve())
    if served:
        kernel["launches_by_variant"] = {
            v: sum(d[v] for d in served) for v in ("aligned", "masked")}
        kernel["launches"] = sum(kernel["launches_by_variant"].values())
    torch.cuda.synchronize()
    _print({"kernels": [kernel]})
    print(smi, flush=True)
    _print({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
