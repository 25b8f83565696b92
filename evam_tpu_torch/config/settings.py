"""Service settings: file < env < pipeline default < request override.

Counterpart of ``evam_tpu/config/settings.py``, in dataclasses (the
card's machine has no pydantic). The honoured knobs keep the
reference's env names and parse rules:

    RUN_MODE, REST_PORT, DETECTION_DEVICE, CLASSIFICATION_DEVICE,
    MODELS_DIR, PIPELINES_DIR, PY_LOG_LEVEL, DEV_MODE,
    EVAM_DRAIN_TIMEOUT_S, EVAM_PRELOAD, EVAM_MAX_BATCH,
    EVAM_BATCH_DEADLINE_MS, EVAM_PRECISION, EVAM_ALLOW_RANDOM_WEIGHTS,
    EVAM_CONFIG_FILE, and the engine's: EVAM_WARMUP (on),
    EVAM_STALL_TIMEOUT_S (120), EVAM_ENGINE_SUPERVISE (on),
    EVAM_ENGINE_MAX_RESTARTS (3), EVAM_ENGINE_RESTART_WINDOW_S (300),
    EVAM_ENGINE_RESTART_BACKOFF_S (0.5), EVAM_FIRST_BATCH_GRACE (10),
    EVAM_TRANSFER (pipelined), EVAM_TRANSFER_DEPTH (2), EVAM_RAGGED (off),
    EVAM_RAGGED_UNIT_BUDGET (4), the fleet's EVAM_FLEET (off),
    EVAM_FLEET_SHARDS, EVAM_FLEET_SHARD_MAX_BATCH and
    EVAM_FLEET_MAX_SHARDS (0), and the config file's ``tpu.mesh_shape``
    ([-1]) and ``tpu.mesh_axes`` (["data"]); the scheduler's EVAM_SCHED
    and its nine EVAM_SCHED_* (``SchedSettings``), and the control
    plane's EVAM_TUNE and its eight EVAM_TUNE_* (``TuneSettings``);
    tracing's EVAM_TRACE (on) and its seven EVAM_TRACE_*
    (``TraceSettings``), the stream checkpoints' EVAM_CKPT (off),
    EVAM_CKPT_INTERVAL and EVAM_CKPT_RESTORE_TIMEOUT_S
    (``CkptSettings``), PROFILING_MODE and EVAM_STATE_DIR, with the
    config file's ``trace`` and ``ckpt`` blocks; the ingest and egress
    knobs ENABLE_RTSP, RTSP_PORT, EVAM_DECODE_POOL_WORKERS,
    EVAM_RTSP_DEMUX_WORKERS, ENABLE_WEBRTC, WEBRTC_SIGNALING_SERVER and
    EVAM_WEBRTC_VIDEO_MODE (``key`` or ``delta``)

and ``EVAM_PLATFORM`` keeps the reference CLI's meaning: ``cpu`` runs
the port on the CPU, unset means the card (``cuda``). Three knobs the
reference reads from ``os.environ`` in its engine modules are parsed
here as those modules parse them: EVAM_BATCH_ASSEMBLY (slot),
EVAM_STAGING_DEPTH (0: the default depth) and EVAM_SERIALIZE_COMPILE
(off; ``engine/devlock.py`` reads it per call, as the reference does).
The host encode's EVAM_NO_NATIVE, EVAM_NATIVE and EVAM_NATIVE_LIB are
read by ``native.py`` on every call, as the reference's module reads
them, and pass here; so do the IR importer's EVAM_IR_LAYOUT (``nhwc``
unless set to another value; read by ``models/ir.py`` when it builds
a model) and the depthwise-conv variant EVAM_DWCONV (``shift`` in any
case, else the grouped conv; read by ``ops/depthwise.py`` when a
module is built). EII mode's EVAM_EII_CONFIG, EVAM_ETCD_HOST (with
ETCD_HOST, ETCD_CLIENT_PORT, ETCD_PREFIX and CONFIGMGR_*) and
EVAM_SOCKET_DIR are read by ``eii/``, as the reference's modules read
them; fault injection's EVAM_FAULT_INJECT and EVAM_FAULT_SEED by
``obs/faults.py``.

The scheduler is on unless EVAM_SCHED turns it off, as in the
reference: admission, the per-class queues and staleness shedding run
by default. Each block records the fields its config-file keys and
environment variables set (``fields_set``, the reference's pydantic
``model_fields_set``): the control plane keeps its hands off a knob
the operator set.

Every other knob of the reference's table belongs to a subsystem that
comes with a later port slice. Set to anything but the value the port
runs with (the reference's default), it raises ``NotImplementedError``
at :meth:`Settings.from_env`, naming the slice. None is silently
ignored.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Mapping

from evam_tpu_torch import slices


def _parse_bool(value: str) -> bool:
    return value.strip().lower() in ("1", "true", "yes", "on")


@dataclass
class EngineSettings:
    """Batch-engine knobs (the reference's ``TPUSettings`` subset that
    the port's engine honours)."""

    max_batch: int = 128
    batch_deadline_ms: float = 8.0
    precision: str = "bfloat16"
    #: warm every batch bucket in the background once a stage has built
    #: its engine — on the card, capture each as a CUDA graph
    #: (``engine/graphs.py``)
    warmup: bool = True
    #: stall watchdog: one batch's device round trip bound (0 disables)
    stall_timeout_s: float = 120.0
    #: quarantine and rebuild a wedged engine (``engine/supervisor.py``)
    supervise: bool = True
    #: at most this many rebuilds per engine within restart_window_s;
    #: exhausting it is the terminal `degraded` state
    max_restarts: int = 3
    restart_window_s: float = 300.0
    #: base of the exponential backoff between quarantine and rebuild
    restart_backoff_s: float = 0.5
    #: watchdog multiplier for a bucket's first batch
    first_batch_grace: float = 10.0
    #: "pipelined" (a launcher thread; upload overlapped with the
    #: previous launch) or "inline"
    transfer: str = "pipelined"
    #: uploaded batches that may wait for the launcher
    transfer_depth: int = 2
    #: EVAM_BATCH_ASSEMBLY: "slot" (staging ring) or "legacy"
    batch_assembly: str = "slot"
    #: EVAM_STAGING_DEPTH: staging slots; 0 = max in flight + 1
    staging_depth: int = 0
    #: EVAM_SERIALIZE_COMPILE: one process-wide lock over every device
    #: call (forces the inline transfer)
    serialize_compile: bool = False
    #: EVAM_RAGGED: "packed" packs a classify engine's real region rows
    #: into one fixed unit block and thins the bucket ladder
    #: (``engine/ragged.py``); "off" keeps the dense buckets
    ragged: str = "off"
    #: EVAM_RAGGED_UNIT_BUDGET: packed unit rows per batch row
    ragged_unit_budget: int = 4
    #: EVAM_FLEET: "sharded" serves every engine key as one shard per
    #: device of the mesh behind a consistent-hash stream placer, plus a
    #: mesh twin for the batch class (``fleet/``); "off" one engine
    fleet: str = "off"
    #: EVAM_FLEET_SHARDS: shard over the first N devices only (0: all);
    #: with EVAM_FLEET_MAX_SHARDS the boot size instead
    fleet_shards: int = 0
    #: EVAM_FLEET_SHARD_MAX_BATCH: a shard's ladder top (0: max_batch /
    #: shards)
    fleet_shard_max_batch: int = 0
    #: EVAM_FLEET_MAX_SHARDS: the eighth control law's ceiling (0: the
    #: law is inert)
    fleet_max_shards: int = 0
    #: config-file only: the data mesh (``device.mesh_devices``): [-1]
    #: is every visible CUDA device
    mesh_shape: list = field(default_factory=lambda: [-1])
    mesh_axes: list = field(default_factory=lambda: ["data"])
    #: fields the config file or the environment set
    fields_set: set[str] = field(default_factory=set, repr=False,
                                 compare=False)


@dataclass
class SchedSettings:
    """QoS scheduling knobs (``evam_tpu_torch/sched/``): admission
    control, priority classes, load shedding."""

    #: EVAM_SCHED (on, as in the reference)
    enabled: bool = True
    #: projected-utilization ceiling for admission (0 disables it)
    admit_util: float = 0.85
    #: declared serving capacity in frames/s (0: derived from the
    #: engines' stage clock)
    capacity_fps: float = 0.0
    #: assumed per-stream fps when a start request declares none
    default_fps: float = 30.0
    #: per-class batch-formation deadlines (ms); unless set, the
    #: standard class follows EVAM_BATCH_DEADLINE_MS
    deadline_ms_realtime: float = 4.0
    deadline_ms_standard: float = 8.0
    deadline_ms_batch: float = 25.0
    #: per-class staleness budgets (ms); 0 never sheds that class
    staleness_ms_realtime: float = 200.0
    staleness_ms_standard: float = 1000.0
    staleness_ms_batch: float = 5000.0
    fields_set: set[str] = field(default_factory=set, repr=False,
                                 compare=False)


@dataclass
class TuneSettings:
    """Self-tuning control plane knobs (``evam_tpu_torch/control/``)."""

    enabled: bool = False
    #: controller tick period (s)
    interval_s: float = 2.0
    #: bounded log of the last N control actions (/scheduler)
    actions: int = 32
    #: consecutive agreeing ticks before a law's action applies
    damping: int = 3
    #: ticks a knob sits out after an applied action
    cooldown: int = 2
    #: utilization above which the controller tightens, below which it
    #: relaxes
    util_hi: float = 0.80
    util_lo: float = 0.50
    #: the fleet law's bounds (inert unless EVAM_FLEET_MAX_SHARDS)
    scale_up_util: float = 0.90
    scale_down_util: float = 0.30
    fields_set: set[str] = field(default_factory=set, repr=False,
                                 compare=False)


@dataclass
class TraceSettings:
    """Per-frame tracing knobs (``obs/trace.py``): trace ids minted at
    ingest, span trees through engine dispatch, a bounded ring with
    tail-based sampling, and the quarantine flight recorder.
    ``EVAM_TRACE=off`` disables the whole layer."""

    enabled: bool = True
    #: healthy-frame retention: keep 1-in-N (error, shed and
    #: deadline-miss frames and the slow tail are always retained)
    sample_n: int = 16
    #: ring capacity: retained frame traces and completed batch
    #: records each
    ring: int = 1024
    #: frames slower than this end to end are always retained
    slow_ms: float = 250.0
    #: flight-recorder directory; empty = <tmpdir>/evam_flight
    flight_dir: str = ""
    #: most recent records of each kind written per flight dump
    flight_n: int = 256
    #: flight-recorder disk bounds (oldest dumps rotated out after
    #: every dump; 0 = unbounded)
    flight_max_files: int = 64
    flight_max_bytes: int = 67108864
    fields_set: set[str] = field(default_factory=set, repr=False,
                                 compare=False)


@dataclass
class CkptSettings:
    """Crash-consistent stream checkpoints (``state/``): captured at
    the post-resolve and pre-rebalance barriers, restored before the
    first frame after a rebuild, migration or restart. Off by default,
    as in the reference."""

    enabled: bool = False
    #: post-resolve capture every N resolved frames
    interval: int = 30
    #: a restore slower than this cold-starts (loudly)
    restore_timeout_s: float = 2.0
    fields_set: set[str] = field(default_factory=set, repr=False,
                                 compare=False)


@dataclass
class Settings:
    """Flat service settings resolved from env + optional config file."""

    run_mode: str = "EVA"  # EVA (REST) vs EII (msgbus)
    rest_port: int = 8080
    detection_device: str = "GPU"
    classification_device: str = "GPU"
    models_dir: str = "models"
    pipelines_dir: str = "pipelines"
    log_level: str = "INFO"  # PY_LOG_LEVEL
    dev_mode: bool = True  # DEV_MODE: human-readable log lines
    #: shutdown drain: per-instance join budget in seconds
    drain_timeout_s: float = 5.0
    #: build and warm these pipelines' engines before the REST port
    #: opens: comma list of name/version (or bare name), or "all"
    preload: str = ""
    #: EVAM_ALLOW_RANDOM_WEIGHTS: serve seeded random weights when a
    #: model has none on disk (the reference's registry reads it)
    allow_random_weights: bool = False
    #: PROFILING_MODE: named ranges around the engine's stages
    #: (``obs/trace.py`` ``prof_range``)
    profiling_mode: bool = False
    #: EVAM_STATE_DIR: the registry persists its streams to
    #: ``streams.json`` here and resumes them at the next start
    state_dir: str = ""
    #: EVAM_PLATFORM: "cuda" (default) or "cpu"
    device: str = "cuda"
    #: ENABLE_RTSP: ``serve`` starts the RTSP re-stream server on
    #: RTSP_PORT (``destination.frame {"type": "rtsp"}``)
    enable_rtsp: bool = False
    rtsp_port: int = 8554
    #: ENABLE_WEBRTC and WEBRTC_SIGNALING_SERVER (a ws:// URL): a start
    #: with ``destination.frame {"type": "webrtc"}`` registers its stream
    #: with that signalling server; without both, the destination is
    #: ignored, as in the reference
    enable_webrtc: bool = False
    webrtc_signaling_server: str = ""
    #: EVAM_WEBRTC_VIDEO_MODE: "key" (one shared keyframe-only VP8
    #: encoder per stream) or "delta" (a GOP encoder per viewer)
    webrtc_video_mode: str = "key"
    #: >0 routes free-running file sources through a shared DecodePool
    #: of this many workers (``media/pool.py``); 0 decodes per stream
    decode_pool_workers: int = 0
    #: >0 routes rtsp:// sources through the shared RtspDemux (one
    #: selector thread + this many decode workers, ``media/demux.py``);
    #: 0 gives each its own blocking reader
    rtsp_demux_workers: int = 0
    engine: EngineSettings = field(default_factory=EngineSettings)
    sched: SchedSettings = field(default_factory=SchedSettings)
    tune: TuneSettings = field(default_factory=TuneSettings)
    trace: TraceSettings = field(default_factory=TraceSettings)
    ckpt: CkptSettings = field(default_factory=CkptSettings)

    @classmethod
    def from_env(cls, config_file: str | os.PathLike | None = None,
                 env: Mapping[str, str] | None = None) -> "Settings":
        env = os.environ if env is None else env
        data: dict[str, Any] = {}
        if config_file and Path(config_file).exists():
            data = json.loads(Path(config_file).read_text())
        _refuse_unported(data, env)

        settings = cls()
        blocks = {"tpu": (settings.engine, _ENGINE_KEYS),
                  "sched": (settings.sched, _SCHED_KEYS),
                  "trace": (settings.trace, _TRACE_KEYS),
                  "ckpt": (settings.ckpt, _CKPT_KEYS)}
        for key, value in data.items():
            if key in blocks:
                block, keys = blocks[key]
                for k in keys & set(value):
                    _assign(block, k, value[k])
            elif key in _TOP_KEYS:
                setattr(settings, key, value)
        for var, (key, conv) in _TOP_ENV.items():
            if var in env:
                setattr(settings, key, conv(env[var]))
        for table, block in ((_ENGINE_ENV, settings.engine),
                             (_MODULE_ENV, settings.engine),
                             (_SCHED_ENV, settings.sched),
                             (_TRACE_ENV, settings.trace),
                             (_CKPT_ENV, settings.ckpt)):
            for var, (key, conv) in table.items():
                if var in env:
                    _assign(block, key, conv(env[var]))
        settings.tune = tune_from_env(config_file, env)
        if settings.webrtc_video_mode not in ("key", "delta"):
            raise ValueError(f"EVAM_WEBRTC_VIDEO_MODE must be 'key' or "
                             f"'delta', got {settings.webrtc_video_mode!r}")
        _check_engine(settings.engine)
        settings.device = _parse_platform(env.get("EVAM_PLATFORM", ""))
        return settings


def _assign(block, key: str, value) -> None:
    setattr(block, key, value)
    block.fields_set.add(key)


def _parse_platform(value: str) -> str:
    platform = value.strip().lower()
    if platform in ("", "cuda", "gpu"):
        return "cuda"
    if platform == "cpu":
        return "cpu"
    raise ValueError(
        f"EVAM_PLATFORM={value!r}: the port runs on 'cuda' (default) or 'cpu'")


def _check_engine(engine: EngineSettings) -> None:
    """The values the reference's engine refuses at construction."""
    if engine.transfer not in ("pipelined", "inline"):
        raise ValueError(f"EVAM_TRANSFER must be 'pipelined' or 'inline', "
                         f"got {engine.transfer!r}")
    if engine.batch_assembly not in ("slot", "legacy"):
        raise ValueError(f"EVAM_BATCH_ASSEMBLY must be 'slot' or 'legacy', "
                         f"got {engine.batch_assembly!r}")
    if engine.ragged not in ("packed", "off"):
        raise ValueError(f"EVAM_RAGGED must be 'packed' or 'off', "
                         f"got {engine.ragged!r}")
    if engine.fleet not in ("sharded", "off"):
        raise ValueError(f"EVAM_FLEET must be 'sharded' or 'off', "
                         f"got {engine.fleet!r}")


def _parse_depth(value: str) -> int:
    """``int(os.environ.get("EVAM_STAGING_DEPTH", "0")) or default``:
    unset or empty is 0, the default depth."""
    return int(value) if value.strip() else 0


def _parse_serialize(value: str) -> bool:
    """``engine/devlock.py`` ``enabled()``."""
    return value.lower() in ("1", "true", "yes")


#: honoured env knobs: var → (Settings field, parser)
_TOP_ENV: dict[str, tuple[str, Callable[[str], Any]]] = {
    "RUN_MODE": ("run_mode", str),
    "REST_PORT": ("rest_port", int),
    "DETECTION_DEVICE": ("detection_device", str),
    "CLASSIFICATION_DEVICE": ("classification_device", str),
    "MODELS_DIR": ("models_dir", str),
    "PIPELINES_DIR": ("pipelines_dir", str),
    "PY_LOG_LEVEL": ("log_level", str),
    "DEV_MODE": ("dev_mode", _parse_bool),
    "EVAM_DRAIN_TIMEOUT_S": ("drain_timeout_s", float),
    "EVAM_PRELOAD": ("preload", str),
    "EVAM_ALLOW_RANDOM_WEIGHTS": ("allow_random_weights", _parse_bool),
    "PROFILING_MODE": ("profiling_mode", _parse_bool),
    "EVAM_STATE_DIR": ("state_dir", str),
    "ENABLE_RTSP": ("enable_rtsp", _parse_bool),
    "RTSP_PORT": ("rtsp_port", int),
    "ENABLE_WEBRTC": ("enable_webrtc", _parse_bool),
    "WEBRTC_SIGNALING_SERVER": ("webrtc_signaling_server", str),
    "EVAM_WEBRTC_VIDEO_MODE": ("webrtc_video_mode", str),
    "EVAM_DECODE_POOL_WORKERS": ("decode_pool_workers", int),
    "EVAM_RTSP_DEMUX_WORKERS": ("rtsp_demux_workers", int),
}
_ENGINE_ENV: dict[str, tuple[str, Callable[[str], Any]]] = {
    "EVAM_MAX_BATCH": ("max_batch", int),
    "EVAM_BATCH_DEADLINE_MS": ("batch_deadline_ms", float),
    "EVAM_PRECISION": ("precision", str),
    "EVAM_WARMUP": ("warmup", _parse_bool),
    "EVAM_STALL_TIMEOUT_S": ("stall_timeout_s", float),
    "EVAM_ENGINE_SUPERVISE": ("supervise", _parse_bool),
    "EVAM_ENGINE_MAX_RESTARTS": ("max_restarts", int),
    "EVAM_ENGINE_RESTART_WINDOW_S": ("restart_window_s", float),
    "EVAM_ENGINE_RESTART_BACKOFF_S": ("restart_backoff_s", float),
    "EVAM_FIRST_BATCH_GRACE": ("first_batch_grace", float),
    "EVAM_TRANSFER": ("transfer", str),
    "EVAM_TRANSFER_DEPTH": ("transfer_depth", int),
    "EVAM_RAGGED": ("ragged", str),
    "EVAM_RAGGED_UNIT_BUDGET": ("ragged_unit_budget", int),
    "EVAM_FLEET": ("fleet", str),
    "EVAM_FLEET_SHARDS": ("fleet_shards", int),
    "EVAM_FLEET_SHARD_MAX_BATCH": ("fleet_shard_max_batch", int),
    "EVAM_FLEET_MAX_SHARDS": ("fleet_max_shards", int),
}
_SCHED_ENV: dict[str, tuple[str, Callable[[str], Any]]] = {
    "EVAM_SCHED": ("enabled", _parse_bool),
    "EVAM_SCHED_ADMIT_UTIL": ("admit_util", float),
    "EVAM_SCHED_CAPACITY_FPS": ("capacity_fps", float),
    "EVAM_SCHED_DEFAULT_FPS": ("default_fps", float),
    "EVAM_SCHED_DEADLINE_MS_REALTIME": ("deadline_ms_realtime", float),
    "EVAM_SCHED_DEADLINE_MS_STANDARD": ("deadline_ms_standard", float),
    "EVAM_SCHED_DEADLINE_MS_BATCH": ("deadline_ms_batch", float),
    "EVAM_SCHED_STALENESS_MS_REALTIME": ("staleness_ms_realtime", float),
    "EVAM_SCHED_STALENESS_MS_STANDARD": ("staleness_ms_standard", float),
    "EVAM_SCHED_STALENESS_MS_BATCH": ("staleness_ms_batch", float),
}
_TUNE_ENV: dict[str, tuple[str, Callable[[str], Any]]] = {
    "EVAM_TUNE": ("enabled", _parse_bool),
    "EVAM_TUNE_INTERVAL_S": ("interval_s", float),
    "EVAM_TUNE_ACTIONS": ("actions", int),
    "EVAM_TUNE_DAMPING": ("damping", int),
    "EVAM_TUNE_COOLDOWN": ("cooldown", int),
    "EVAM_TUNE_UTIL_HI": ("util_hi", float),
    "EVAM_TUNE_UTIL_LO": ("util_lo", float),
    "EVAM_TUNE_SCALE_UP_UTIL": ("scale_up_util", float),
    "EVAM_TUNE_SCALE_DOWN_UTIL": ("scale_down_util", float),
}
_TRACE_ENV: dict[str, tuple[str, Callable[[str], Any]]] = {
    "EVAM_TRACE": ("enabled", _parse_bool),
    "EVAM_TRACE_SAMPLE_N": ("sample_n", int),
    "EVAM_TRACE_RING": ("ring", int),
    "EVAM_TRACE_SLOW_MS": ("slow_ms", float),
    "EVAM_TRACE_FLIGHT_DIR": ("flight_dir", str),
    "EVAM_TRACE_FLIGHT_N": ("flight_n", int),
    "EVAM_TRACE_FLIGHT_MAX_FILES": ("flight_max_files", int),
    "EVAM_TRACE_FLIGHT_MAX_BYTES": ("flight_max_bytes", int),
}
_CKPT_ENV: dict[str, tuple[str, Callable[[str], Any]]] = {
    "EVAM_CKPT": ("enabled", _parse_bool),
    "EVAM_CKPT_INTERVAL": ("interval", int),
    "EVAM_CKPT_RESTORE_TIMEOUT_S": ("restore_timeout_s", float),
}
#: knobs the reference's engine modules read from os.environ (never a
#: config-file key there, nor here)
_MODULE_ENV: dict[str, tuple[str, Callable[[str], Any]]] = {
    # engine/batcher.py:277
    "EVAM_BATCH_ASSEMBLY": ("batch_assembly", str),
    # engine/batcher.py:426-427
    "EVAM_STAGING_DEPTH": ("staging_depth", _parse_depth),
    # engine/devlock.py:41
    "EVAM_SERIALIZE_COMPILE": ("serialize_compile", _parse_serialize),
}
_TOP_KEYS = {key for key, _ in _TOP_ENV.values()} - {"allow_random_weights"}
_ENGINE_KEYS = {key for key, _ in _ENGINE_ENV.values()} | {
    "mesh_shape", "mesh_axes"}
_SCHED_KEYS = {key for key, _ in _SCHED_ENV.values()}
_TUNE_KEYS = {key for key, _ in _TUNE_ENV.values()}
_TRACE_KEYS = {key for key, _ in _TRACE_ENV.values()}
_CKPT_KEYS = {key for key, _ in _CKPT_ENV.values()}

_S7 = slices.ENGINE_DEPTH

#: unported knobs: (env var, or None for a config-file-only key;
#: config-file block, "" for top level; key; parser; the value the port
#: runs with; the slice that brings it)
_UNPORTED: list[tuple[str | None, str, str, Callable[[str], Any] | None,
                      Any, str]] = [
    ("EVAM_COMPILE_CACHE_DIR", "tpu", "compile_cache_dir", str, "", _S7),
    ("EVAM_AOT", "aot", "enabled", _parse_bool, False, _S7),
    ("EVAM_AOT_DIR", "aot", "dir", str, "", _S7),
    ("EVAM_AOT_MAX_BYTES", "aot", "max_bytes", int, 1073741824, _S7),
    (None, "tpu", "donate_buffers", None, True, _S7),
]

#: reference settings blocks the config file may carry
_BLOCKS = ("tpu", "sched", "trace", "ckpt", "tune", "aot")


def _refuse_unported(data: dict[str, Any], env: Mapping[str, str]) -> None:
    """Raise for the first unported knob — config-file key or env var —
    whose value is not the one the port runs with."""
    for var, block, key, conv, port_value, slice_ in _UNPORTED:
        where = data.get(block, {}) if block else data
        if key in where and where[key] != port_value:
            name = f"{block}.{key}" if block else key
            raise NotImplementedError(
                f"config {name}={where[key]!r}: comes with {slice_}; the "
                f"port runs with {port_value!r}")
        if var is not None and var in env and conv(env[var]) != port_value:
            raise NotImplementedError(
                f"{var}={env[var]!r}: comes with {slice_}; the port runs "
                f"with {port_value!r}")
    known = _TOP_KEYS | set(_BLOCKS) | {
        key for _, block, key, *_ in _UNPORTED if not block}
    unknown = set(data) - known
    if unknown:
        raise ValueError(f"unknown settings keys {sorted(unknown)}")
    for block in _BLOCKS:
        keys = set(data.get(block, {}))
        keys -= {key for _, b, key, *_ in _UNPORTED if b == block}
        keys -= {"tpu": _ENGINE_KEYS, "sched": _SCHED_KEYS,
                 "tune": _TUNE_KEYS, "trace": _TRACE_KEYS,
                 "ckpt": _CKPT_KEYS}.get(block, set())
        if keys:
            raise ValueError(f"unknown settings keys {block}.{sorted(keys)}")


def tune_from_env(config_file: str | os.PathLike | None,
                  env: Mapping[str, str] | None = None) -> TuneSettings:
    """The control plane's block alone (``Settings.from_env`` reads it
    here too): the config file's ``tune`` keys, then the EVAM_TUNE*
    variables. ``control/state.py`` resolves it from hot paths, which
    must not fail on a knob of another block (``Settings.from_env``
    refuses the unported ones)."""
    env = os.environ if env is None else env
    tune = TuneSettings()
    if config_file and Path(config_file).exists():
        block = json.loads(Path(config_file).read_text()).get("tune", {})
        for key in _TUNE_KEYS & set(block):
            _assign(tune, key, block[key])
    for var, (key, conv) in _TUNE_ENV.items():
        if var in env:
            _assign(tune, key, conv(env[var]))
    return tune


_settings: Settings | None = None


def get_settings() -> Settings:
    global _settings
    if _settings is None:
        _settings = Settings.from_env(os.environ.get("EVAM_CONFIG_FILE"))
    return _settings


def reset_settings() -> None:
    """Drop the cached settings (tests / hot reload)."""
    global _settings
    _settings = None
