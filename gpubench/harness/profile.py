"""The traced run's profiler and its reduction to a timeline.

``torch.profiler`` records the device's operations (kernels, copies,
sets) and, on every thread, the host ranges the program opens with
PROFILING_MODE on (``evam.<stage>``, ``evam.step``) and the benchmark's
own ``gpubench.submit``. The Chrome trace it exports is read back into a
:class:`Timeline` and deleted; the per-layer metrics and the breakdown
read the timeline.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import Counter
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_PREFIXES = ("evam.", "gpubench.")


@dataclass
class Timeline:
    """Device operations and host ranges of one profiled window, times
    in seconds from the window's start."""

    #: (name, category, start, duration)
    device: list[tuple[str, str, float, float]]
    #: (name, thread, start, duration)
    host: list[tuple[str, str, float, float]]
    #: the window's length
    seconds: float
    #: events of the exported trace by category
    counts: dict = field(default_factory=dict)

    def kernels(self, contains: str | None = None):
        return [d for d in self.device if d[1] == "kernel"
                and (contains is None or contains in d[0])]


def start():
    """Start a profiler over the device and every host thread."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   **kw)
    prof.start()
    return prof


def warm() -> float:
    """Start and stop an empty profiler: the first start in a process
    initializes the device tracing (seconds), which must not fall inside
    the profiled stretch. Returns its seconds."""
    import time

    t0 = time.perf_counter()
    start().stop()
    return time.perf_counter() - t0


def timeline(prof) -> Timeline:
    """The trace of a stopped ``prof``, reduced."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="gpubench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return reduce(events)


def reduce(events: list[dict]) -> Timeline:
    """Chrome trace events → :class:`Timeline` (the window spans every
    device operation and host range recorded)."""
    dev, host = [], []
    counts = Counter(str(e.get("cat")) for e in events)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            dev.append((name, cat, float(e["ts"]), float(e["dur"])))
        elif cat == "user_annotation" and name.startswith(HOST_PREFIXES):
            host.append((name, str(e.get("tid", "")), float(e["ts"]),
                         float(e["dur"])))
    spans = [(s, s + d) for _, _, s, d in dev] + [(s, s + d)
                                                 for _, _, s, d in host]
    if not spans:
        return Timeline([], [], 0.0, dict(counts))
    t0 = min(s for s, _ in spans)
    t1 = max(e for _, e in spans)
    us = 1e-6
    return Timeline(
        [(n, c, (s - t0) * us, d * us) for n, c, s, d in sorted(
            dev, key=lambda x: x[2])],
        [(n, t, (s - t0) * us, d * us) for n, t, s, d in host],
        (t1 - t0) * us, dict(counts))


def union(intervals) -> list[tuple[float, float]]:
    """Merged (start, end) of (start, duration) intervals."""
    out: list[list[float]] = []
    for s, d in sorted(intervals):
        e = s + d
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(tl: Timeline) -> float:
    """Seconds of the window in which an operation ran on the device."""
    return sum(e - s for s, e in union((s, d) for _, _, s, d in tl.device))


def idle_gaps(tl: Timeline) -> list[tuple[float, float]]:
    """The window's stretches with nothing on the device."""
    busy = union((s, d) for _, _, s, d in tl.device)
    gaps, at = [], 0.0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if tl.seconds > at:
        gaps.append((at, tl.seconds))
    return gaps


#: idle gaps shorter than this (the launch-to-launch gaps inside a
#: step) are summed under one name instead of by host range
SHORT_GAP_S = 20e-6


def breakdown(tl: Timeline, top: int = 10) -> dict:
    """The device operations with most summed time, and the idle gaps
    summed by the host range that covered most of each (``none`` where
    no range did; gaps under :data:`SHORT_GAP_S` as ``short_gaps``),
    each list at most ``top`` long, in seconds."""
    import numpy as np

    by_op: dict[str, float] = {}
    for name, _, _, d in tl.device:
        by_op[name] = by_op.get(name, 0.0) + d
    by_range: dict[str, float] = {}
    names = [h[0] for h in tl.host]
    hs = np.array([h[2] for h in tl.host], dtype=np.float64)
    he = hs + np.array([h[3] for h in tl.host], dtype=np.float64)
    for gs, ge in idle_gaps(tl):
        key = "short_gaps"
        if ge - gs >= SHORT_GAP_S:
            key = "none"
            if names:
                cover = np.minimum(ge, he) - np.maximum(gs, hs)
                i = int(np.argmax(cover))
                if cover[i] > 0:
                    key = names[i]
        by_range[key] = by_range.get(key, 0.0) + (ge - gs)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[k, v] for k, v in rank(by_op)],
            "idle_gaps": [[k, v] for k, v in rank(by_range)]}
