"""The arithmetic of the per-layer metrics, shared by their readers.

Each reader in ``metrics/`` takes the run's context: the configuration
and mix, the window's length and frames resolved in it, the classified
ROIs a frame, the engine's counters over the window (``engine``) and
over the profiled stretch (``sub``: its length, frames resolved in it,
counters), and the profiled stretch's timeline (``timeline``). A reader
with nothing to read returns None, and the run leaves the metric out.
"""

from __future__ import annotations

from gpubench.harness import profile, reckon

#: the name every kernel of K1's library carries
K1_KERNEL = "qgemm_kernel"


def engine_host_ms(ctx) -> float | None:
    """Host milliseconds a batch in the engine's stages, ``submit_wait``
    (time a batch waits to form) left out: Δ stage seconds ÷ Δ batches
    over the window."""
    d = ctx.engine
    if not d["batches"]:
        return None
    host = sum(v for s, v in d["stage_seconds"].items() if s != "submit_wait")
    return 1e3 * host / d["batches"]


def device_ms_per_frame(ctx) -> float | None:
    """Kernel device milliseconds (copies left out) in the profiled
    stretch ÷ frames resolved in it."""
    tl, sub = ctx.timeline, ctx.sub
    if tl is None or sub is None or not sub.frames:
        return None
    kernels = tl.kernels()
    if not kernels:
        return None
    return 1e3 * sum(d for _, _, _, d in kernels) / sub.frames


def step_mfu(ctx) -> float | None:
    """Share (%) of the card's published peak the whole step's layers
    would take for the frames resolved in the window: each layer's
    operations over the peak of the precision it is served in, ROI
    layers once for each ROI a frame really has, × frames ÷ window."""
    if not ctx.frames:
        return None
    layers = ctx.config["layers"]
    per_frame = (reckon.peak_seconds(layers, "frame")
                 + ctx.rois_per_frame * reckon.peak_seconds(layers, "roi"))
    return 100.0 * ctx.frames * per_frame / ctx.window_seconds


def k1_forwards(ctx) -> tuple[int, float] | None:
    """(K1 kernels in the profiled stretch, forwards they make up)."""
    tl = ctx.timeline
    if tl is None:
        return None
    n = len(tl.kernels(K1_KERNEL))
    per = len(reckon.k1_shapes(ctx.config["layers"], 1, 1))
    return (n, n / per) if n and per else None


def k1_roofline(ctx) -> float | None:
    """Share (%) of K1's roofline: the least time of every K1 launch in
    the profiled stretch (operations at the int8 peak or bytes at the
    bandwidth, whichever is longer), its shapes from the frozen layer
    table at the buckets the engine replayed there, ÷ the device time of
    every K1 kernel there."""
    got = k1_forwards(ctx)
    if got is None or ctx.sub is None:
        return None
    buckets = ctx.sub.delta["bucket_batches"]
    total = sum(buckets.values())
    if not total:
        return None
    rois = (ctx.config.get("classifier") or {}).get("roi_budget", 1)
    per_forward = sum(c / total * reckon.forward_bound_seconds(
        ctx.config["layers"], b, rois) for b, c in buckets.items())
    spent = sum(d for _, _, _, d in ctx.timeline.kernels(K1_KERNEL))
    return 100.0 * got[1] * per_forward / spent


def device_idle(ctx) -> float | None:
    """Share (%) of the profiled stretch with no operation on the
    device."""
    tl = ctx.timeline
    if tl is None or not tl.device or tl.seconds <= 0:
        return None
    return 100.0 * (1.0 - profile.busy_seconds(tl) / tl.seconds)
