"""Service settings: file < env < pipeline default < request override.

Counterpart of ``evam_tpu/config/settings.py``, in dataclasses (the
card's machine has no pydantic). The honoured knobs keep the
reference's env names and parse rules:

    RUN_MODE, REST_PORT, DETECTION_DEVICE, CLASSIFICATION_DEVICE,
    MODELS_DIR, PIPELINES_DIR, PY_LOG_LEVEL, DEV_MODE,
    EVAM_DRAIN_TIMEOUT_S, EVAM_MAX_BATCH, EVAM_BATCH_DEADLINE_MS,
    EVAM_PRECISION, EVAM_ALLOW_RANDOM_WEIGHTS, EVAM_CONFIG_FILE

and ``EVAM_PLATFORM`` keeps the reference CLI's meaning: ``cpu`` runs
the port on the CPU, unset means the card (``cuda``).

Every other knob of the reference's table belongs to a subsystem that
comes with a later port slice. Set to anything but the value the port
runs with — the reference's default, or "off" where the reference's
default turns on a subsystem the port lacks (scheduler, tracing,
warmup, supervision, pipelined transfer) — it raises
``NotImplementedError`` at :meth:`Settings.from_env`, naming the slice.
None is silently ignored.
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
    #: EVAM_ALLOW_RANDOM_WEIGHTS: serve seeded random weights when a
    #: model has none on disk (the reference's registry reads it)
    allow_random_weights: bool = False
    #: EVAM_PLATFORM: "cuda" (default) or "cpu"
    device: str = "cuda"
    engine: EngineSettings = field(default_factory=EngineSettings)

    @classmethod
    def from_env(cls, config_file: str | os.PathLike | None = None,
                 env: Mapping[str, str] | None = None) -> "Settings":
        env = os.environ if env is None else env
        data: dict[str, Any] = {}
        if config_file and Path(config_file).exists():
            data = json.loads(Path(config_file).read_text())
        _refuse_unported(data, env)

        settings = cls()
        for key, value in data.items():
            if key == "tpu":
                for k in _ENGINE_KEYS:
                    if k in value:
                        setattr(settings.engine, k, value[k])
            elif key in _TOP_KEYS:
                setattr(settings, key, value)
        for var, (key, conv) in _TOP_ENV.items():
            if var in env:
                setattr(settings, key, conv(env[var]))
        for var, (key, conv) in _ENGINE_ENV.items():
            if var in env:
                setattr(settings.engine, key, conv(env[var]))
        settings.device = _parse_platform(env.get("EVAM_PLATFORM", ""))
        return settings


def _parse_platform(value: str) -> str:
    platform = value.strip().lower()
    if platform in ("", "cuda", "gpu"):
        return "cuda"
    if platform == "cpu":
        return "cpu"
    raise ValueError(
        f"EVAM_PLATFORM={value!r}: the port runs on 'cuda' (default) or 'cpu'")


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
    "EVAM_ALLOW_RANDOM_WEIGHTS": ("allow_random_weights", _parse_bool),
}
_ENGINE_ENV: dict[str, tuple[str, Callable[[str], Any]]] = {
    "EVAM_MAX_BATCH": ("max_batch", int),
    "EVAM_BATCH_DEADLINE_MS": ("batch_deadline_ms", float),
    "EVAM_PRECISION": ("precision", str),
}
_TOP_KEYS = {key for key, _ in _TOP_ENV.values()} - {"allow_random_weights"}
_ENGINE_KEYS = {key for key, _ in _ENGINE_ENV.values()}

_S7 = slices.ENGINE_DEPTH
_S10 = slices.TRACE_STATE
_S11 = slices.INGEST_EGRESS

#: unported knobs: (env var, or None for a config-file-only key;
#: config-file block, "" for top level; key; parser; the value the port
#: runs with; the slice that brings it)
_UNPORTED: list[tuple[str | None, str, str, Callable[[str], Any] | None,
                      Any, str]] = [
    ("ENABLE_RTSP", "", "enable_rtsp", _parse_bool, False, _S11),
    ("RTSP_PORT", "", "rtsp_port", int, 8554, _S11),
    ("ENABLE_WEBRTC", "", "enable_webrtc", _parse_bool, False, _S11),
    ("WEBRTC_SIGNALING_SERVER", "", "webrtc_signaling_server", str, "", _S11),
    ("EVAM_WEBRTC_VIDEO_MODE", "", "webrtc_video_mode", str, "key", _S11),
    ("PROFILING_MODE", "", "profiling_mode", _parse_bool, False, _S10),
    ("EVAM_STATE_DIR", "", "state_dir", str, "", _S10),
    ("EVAM_PRELOAD", "", "preload", str, "", _S7),
    ("EVAM_DECODE_POOL_WORKERS", "", "decode_pool_workers", int, 0, _S11),
    ("EVAM_RTSP_DEMUX_WORKERS", "", "rtsp_demux_workers", int, 0, _S11),
    ("EVAM_COMPILE_CACHE_DIR", "tpu", "compile_cache_dir", str, "", _S7),
    ("EVAM_WARMUP", "tpu", "warmup", _parse_bool, False, _S7),
    ("EVAM_STALL_TIMEOUT_S", "tpu", "stall_timeout_s", float, 120.0, _S7),
    ("EVAM_ENGINE_SUPERVISE", "tpu", "supervise", _parse_bool, False, _S7),
    ("EVAM_ENGINE_MAX_RESTARTS", "tpu", "max_restarts", int, 3, _S7),
    ("EVAM_ENGINE_RESTART_WINDOW_S", "tpu", "restart_window_s",
     float, 300.0, _S7),
    ("EVAM_ENGINE_RESTART_BACKOFF_S", "tpu", "restart_backoff_s",
     float, 0.5, _S7),
    ("EVAM_FIRST_BATCH_GRACE", "tpu", "first_batch_grace", float, 10.0, _S7),
    ("EVAM_TRANSFER", "tpu", "transfer", str, "inline", _S7),
    ("EVAM_TRANSFER_DEPTH", "tpu", "transfer_depth", int, 2, _S7),
    ("EVAM_RAGGED", "tpu", "ragged", str, "off", slices.TRACK_GATE_RAGGED),
    ("EVAM_RAGGED_UNIT_BUDGET", "tpu", "ragged_unit_budget",
     int, 4, slices.TRACK_GATE_RAGGED),
    ("EVAM_FLEET", "tpu", "fleet", str, "off", _S7),
    ("EVAM_FLEET_SHARDS", "tpu", "fleet_shards", int, 0, _S7),
    ("EVAM_FLEET_SHARD_MAX_BATCH", "tpu", "fleet_shard_max_batch",
     int, 0, _S7),
    ("EVAM_FLEET_MAX_SHARDS", "tpu", "fleet_max_shards", int, 0, _S7),
    ("EVAM_SCHED", "sched", "enabled", _parse_bool, False, _S7),
    ("EVAM_SCHED_ADMIT_UTIL", "sched", "admit_util", float, 0.85, _S7),
    ("EVAM_SCHED_CAPACITY_FPS", "sched", "capacity_fps", float, 0.0, _S7),
    ("EVAM_SCHED_DEFAULT_FPS", "sched", "default_fps", float, 30.0, _S7),
    ("EVAM_SCHED_DEADLINE_MS_REALTIME", "sched", "deadline_ms_realtime",
     float, 4.0, _S7),
    ("EVAM_SCHED_DEADLINE_MS_STANDARD", "sched", "deadline_ms_standard",
     float, 8.0, _S7),
    ("EVAM_SCHED_DEADLINE_MS_BATCH", "sched", "deadline_ms_batch",
     float, 25.0, _S7),
    ("EVAM_SCHED_STALENESS_MS_REALTIME", "sched", "staleness_ms_realtime",
     float, 200.0, _S7),
    ("EVAM_SCHED_STALENESS_MS_STANDARD", "sched", "staleness_ms_standard",
     float, 1000.0, _S7),
    ("EVAM_SCHED_STALENESS_MS_BATCH", "sched", "staleness_ms_batch",
     float, 5000.0, _S7),
    ("EVAM_TRACE", "trace", "enabled", _parse_bool, False, _S10),
    ("EVAM_TRACE_SAMPLE_N", "trace", "sample_n", int, 16, _S10),
    ("EVAM_TRACE_RING", "trace", "ring", int, 1024, _S10),
    ("EVAM_TRACE_SLOW_MS", "trace", "slow_ms", float, 250.0, _S10),
    ("EVAM_TRACE_FLIGHT_DIR", "trace", "flight_dir", str, "", _S10),
    ("EVAM_TRACE_FLIGHT_N", "trace", "flight_n", int, 256, _S10),
    ("EVAM_TRACE_FLIGHT_MAX_FILES", "trace", "flight_max_files",
     int, 64, _S10),
    ("EVAM_TRACE_FLIGHT_MAX_BYTES", "trace", "flight_max_bytes",
     int, 67108864, _S10),
    ("EVAM_CKPT", "ckpt", "enabled", _parse_bool, False, _S10),
    ("EVAM_CKPT_INTERVAL", "ckpt", "interval", int, 30, _S10),
    ("EVAM_CKPT_RESTORE_TIMEOUT_S", "ckpt", "restore_timeout_s",
     float, 2.0, _S10),
    ("EVAM_TUNE", "tune", "enabled", _parse_bool, False, _S7),
    ("EVAM_TUNE_INTERVAL_S", "tune", "interval_s", float, 2.0, _S7),
    ("EVAM_TUNE_ACTIONS", "tune", "actions", int, 32, _S7),
    ("EVAM_TUNE_DAMPING", "tune", "damping", int, 3, _S7),
    ("EVAM_TUNE_COOLDOWN", "tune", "cooldown", int, 2, _S7),
    ("EVAM_TUNE_UTIL_HI", "tune", "util_hi", float, 0.80, _S7),
    ("EVAM_TUNE_UTIL_LO", "tune", "util_lo", float, 0.50, _S7),
    ("EVAM_TUNE_SCALE_UP_UTIL", "tune", "scale_up_util", float, 0.90, _S7),
    ("EVAM_TUNE_SCALE_DOWN_UTIL", "tune", "scale_down_util", float, 0.30, _S7),
    ("EVAM_AOT", "aot", "enabled", _parse_bool, False, _S7),
    ("EVAM_AOT_DIR", "aot", "dir", str, "", _S7),
    ("EVAM_AOT_MAX_BYTES", "aot", "max_bytes", int, 1073741824, _S7),
    (None, "tpu", "mesh_shape", None, [-1], _S7),
    (None, "tpu", "mesh_axes", None, ["data"], _S7),
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
        if block == "tpu":
            keys -= _ENGINE_KEYS
        if keys:
            raise ValueError(f"unknown settings keys {block}.{sorted(keys)}")


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
