"""The port's graph and settings layers against the reference's.

* Every pipeline JSON under ``pipelines/`` and ``eii/pipelines/`` loads
  through both ``PipelineLoader``s and resolves to the same stage specs
  (kind, name, model, properties) — with the default parameters and
  with each documented parameter set — or fails with the same
  ``ParameterError``.
* ``gst_compat.parse_template`` agrees on the templates of
  ``tests/test_graph.py``.
* ``Settings.from_env`` parses each knob the port honours as the
  reference does — its settings table, and the engine knobs its
  modules read from ``os.environ`` (batch assembly, staging depth,
  compile serialization), read there through a reference engine; the
  native host library's EVAM_NO_NATIVE / EVAM_NATIVE / EVAM_NATIVE_LIB
  as the reference's ``native`` module decides on them; tracing's,
  the stream checkpoints', PROFILING_MODE and EVAM_STATE_DIR from the
  environment and the config file, with the same defaults (trace on,
  ckpt off); the fault injector's EVAM_FAULT_INJECT / EVAM_FAULT_SEED
  into the same injector — and raises ``NotImplementedError`` naming a
  slice for each unported knob set to a value the port does not run
  with (the rest of the table).

Exact equality throughout: these layers are copies.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from evam_tpu.config import settings as ref_settings
from evam_tpu.graph import PipelineLoader as RefLoader
from evam_tpu.graph import ParameterError as RefParameterError
from evam_tpu.graph import resolve_parameters as ref_resolve
from evam_tpu.graph.gst_compat import parse_template as ref_parse_template
from evam_tpu.graph.loader import parse_pipeline_json as ref_parse_json
from evam_tpu.models import registry as ref_models
from evam_tpu_torch.config import settings as port_settings
from evam_tpu_torch.graph import ParameterError, PipelineLoader, resolve_parameters
from evam_tpu_torch.graph.gst_compat import parse_template
from evam_tpu_torch.graph.loader import parse_pipeline_json

REPO = Path(__file__).resolve().parent.parent
DIRS = ("pipelines", "eii/pipelines")
PIPELINES = [(d, n, v) for d in DIRS for n, v in RefLoader(REPO / d).names()]
_PIPE_IDS = [f"{d}:{n}/{v}" for d, n, v in PIPELINES]


def _specs(stages) -> list[tuple]:
    return [(s.kind.value, s.name, s.model, s.properties) for s in stages]


def _resolve_both(d, name, version, params):
    ref = RefLoader(REPO / d).get(name, version)
    got = PipelineLoader(REPO / d).get(name, version)
    try:
        want = ref_resolve(ref, params)
    except RefParameterError as exc:
        with pytest.raises(ParameterError) as info:
            resolve_parameters(got, params)
        assert str(info.value) == str(exc)
        return None
    stages, pipeline_level = resolve_parameters(got, params)
    assert _specs(stages) == _specs(want[0])
    assert pipeline_level == want[1]
    return stages


def test_every_pipeline_loads_in_both():
    for d in DIRS:
        assert PipelineLoader(REPO / d).names() == RefLoader(REPO / d).names()
    assert len(PIPELINES) == 13


@pytest.mark.parametrize("d,name,version", PIPELINES, ids=_PIPE_IDS)
def test_defaults_resolve_to_the_reference_stages(d, name, version):
    ref = RefLoader(REPO / d).get(name, version)
    got = PipelineLoader(REPO / d).get(name, version)
    assert _specs(got.stages) == _specs(ref.stages)
    assert (got.description, got.parameters, got.raw) == (
        ref.description, ref.parameters, ref.raw)
    assert got.validate() == ref.validate() == []
    assert _resolve_both(d, name, version, {}) is not None


def _sample(schema: dict):
    """A value of the parameter's declared type."""
    element = schema.get("element")
    if isinstance(element, dict) and element.get("format") == "element-properties":
        return {"threshold": 0.25}
    if "enum" in schema:
        return schema["enum"][-1]
    kind = schema.get("type", "string")
    kind = kind[0] if isinstance(kind, list) else kind
    return {"string": "CPU", "integer": 3, "number": 0.35, "boolean": True,
            "object": {"k": 1}, "array": [1, 2]}[kind]


_PARAMS = [
    (d, n, v, p)
    for d, n, v in PIPELINES
    for p in sorted(RefLoader(REPO / d).get(n, v).parameters.get(
        "properties", {}))
]


@pytest.mark.parametrize("d,name,version,param", _PARAMS,
                         ids=[f"{d}:{n}/{v}:{p}" for d, n, v, p in _PARAMS])
def test_each_documented_parameter_binds_as_in_the_reference(
        d, name, version, param):
    schema = RefLoader(REPO / d).get(name, version).parameters[
        "properties"][param]
    stages = _resolve_both(d, name, version, {param: _sample(schema)})
    assert stages is not None


_BAD = {
    "unknown parameter": {"no-such-parameter": 1},
    "string for a number": {"threshold": "high"},
    "bool for an integer": {"inference-interval": True},
    "element-properties not an object": {"detection-properties": 3},
    "list for an integer": {"inference-interval": [2]},
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_parameter_errors_match(case):
    _resolve_both("pipelines", "object_detection", "person_vehicle_bike",
                  _BAD[case])
    with pytest.raises(ParameterError):
        got = PipelineLoader(REPO / "pipelines").get(
            "object_detection", "person_vehicle_bike")
        resolve_parameters(got, _BAD[case])


def test_enum_and_unknown_stage_binding_errors_match():
    data = {
        "type": "tpu",
        "stages": [{"kind": "source"},
                   {"kind": "detect", "name": "det", "model": "a/b"}],
        "parameters": {"properties": {
            "mode": {"element": "det", "type": "string",
                     "enum": ["fast", "slow"]},
            "ghost": {"element": "nowhere", "type": "integer"},
        }},
    }
    ref = ref_parse_json(data, "x", "1")
    got = parse_pipeline_json(data, "x", "1")
    for params in ({"mode": "turbo"}, {"ghost": 1}, {"mode": "fast"}):
        try:
            want = ref_resolve(ref, params)
        except RefParameterError as exc:
            with pytest.raises(ParameterError, match=str(exc)[:20]):
                resolve_parameters(got, params)
        else:
            assert _specs(resolve_parameters(got, params)[0]) == _specs(want[0])


def test_env_interpolation_in_defaults(monkeypatch):
    monkeypatch.setenv("DETECTION_DEVICE", "GPU.1")
    stages = _resolve_both("pipelines", "object_detection",
                           "person_vehicle_bike", {})
    det = [s for s in stages if s.name == "detection"][0]
    assert det.properties["device"] == "GPU.1"


_TEMPLATES = [
    ["{auto_source} ! decodebin",
     " ! gvadetect model={models[object_detection][person_vehicle_bike][network]} name=detection",
     " ! gvatrack name=tracking",
     " ! gvaclassify model={models[object_classification][vehicle_attributes][network]} name=classification",
     " ! gvametaconvert name=metaconvert ! gvametapublish name=destination",
     " ! appsink name=appsink"],
    "{auto_source} ! decodebin ! videoconvert ! video/x-raw,format=BGRx"
    " ! gvadetect model={models[a][b][network]} name=d threshold=0.5"
    " inference-interval=3 ! appsink name=destination",
    "{auto_source} ! decodebin ! audioresample ! audioconvert"
    " ! audio/x-raw, channels=1,format=S16LE,rate=16000 ! audiomixer name=mix"
    " ! level name=level ! gvaaudiodetect model={models[audio_detection][environment][network]}"
    " name=detection ! appsink",
]


@pytest.mark.parametrize("template", _TEMPLATES, ids=["chain", "caps", "audio"])
def test_parse_template_agrees(template):
    assert _specs(parse_template(template)) == _specs(ref_parse_template(template))


def test_parse_template_rejects_what_the_reference_rejects():
    for bad in ("{auto_source} ! nosuchelement", "{auto_source} ! gvadetect x"):
        with pytest.raises(ValueError) as ref_exc:
            ref_parse_template(bad)
        with pytest.raises(ValueError) as exc:
            parse_template(bad)
        assert str(exc.value) == str(ref_exc.value)


# ---------------------------------------------------------------- settings

#: honoured knob → (sample value, reference reader, port reader)
_HONOURED = {
    "RUN_MODE": ("EII", lambda s: s.run_mode, lambda s: s.run_mode),
    "REST_PORT": ("18081", lambda s: s.rest_port, lambda s: s.rest_port),
    "DETECTION_DEVICE": ("GPU.1", lambda s: s.detection_device,
                         lambda s: s.detection_device),
    "CLASSIFICATION_DEVICE": ("CPU", lambda s: s.classification_device,
                              lambda s: s.classification_device),
    "MODELS_DIR": ("/srv/models", lambda s: s.models_dir,
                   lambda s: s.models_dir),
    "PIPELINES_DIR": ("/srv/pipes", lambda s: s.pipelines_dir,
                      lambda s: s.pipelines_dir),
    "PY_LOG_LEVEL": ("DEBUG", lambda s: s.log_level, lambda s: s.log_level),
    "DEV_MODE": ("no", lambda s: s.dev_mode, lambda s: s.dev_mode),
    "EVAM_DRAIN_TIMEOUT_S": ("2.5", lambda s: s.drain_timeout_s,
                             lambda s: s.drain_timeout_s),
    # slice 11a's ingest and re-stream knobs
    "ENABLE_RTSP": ("true", lambda s: s.enable_rtsp,
                    lambda s: s.enable_rtsp),
    "RTSP_PORT": ("18554", lambda s: s.rtsp_port, lambda s: s.rtsp_port),
    "EVAM_DECODE_POOL_WORKERS": ("3", lambda s: s.decode_pool_workers,
                                 lambda s: s.decode_pool_workers),
    "EVAM_RTSP_DEMUX_WORKERS": ("2", lambda s: s.rtsp_demux_workers,
                                lambda s: s.rtsp_demux_workers),
    "EVAM_MAX_BATCH": ("64", lambda s: s.tpu.max_batch,
                       lambda s: s.engine.max_batch),
    "EVAM_BATCH_DEADLINE_MS": ("12.5", lambda s: s.tpu.batch_deadline_ms,
                               lambda s: s.engine.batch_deadline_ms),
    "EVAM_PRECISION": ("int8", lambda s: s.tpu.precision,
                       lambda s: s.engine.precision),
    "EVAM_ALLOW_RANDOM_WEIGHTS": (
        "Yes", lambda s: ref_models._env_allows_random(),
        lambda s: s.allow_random_weights),
    "EVAM_PRELOAD": ("object_detection/person_vehicle_bike",
                     lambda s: s.preload, lambda s: s.preload),
    "EVAM_WARMUP": ("0", lambda s: s.tpu.warmup,
                    lambda s: s.engine.warmup),
    "EVAM_STALL_TIMEOUT_S": ("2.5", lambda s: s.tpu.stall_timeout_s,
                             lambda s: s.engine.stall_timeout_s),
    "EVAM_ENGINE_SUPERVISE": ("off", lambda s: s.tpu.supervise,
                              lambda s: s.engine.supervise),
    "EVAM_ENGINE_MAX_RESTARTS": ("5", lambda s: s.tpu.max_restarts,
                                 lambda s: s.engine.max_restarts),
    "EVAM_ENGINE_RESTART_WINDOW_S": (
        "60", lambda s: s.tpu.restart_window_s,
        lambda s: s.engine.restart_window_s),
    "EVAM_ENGINE_RESTART_BACKOFF_S": (
        "0.05", lambda s: s.tpu.restart_backoff_s,
        lambda s: s.engine.restart_backoff_s),
    "EVAM_FIRST_BATCH_GRACE": ("4", lambda s: s.tpu.first_batch_grace,
                               lambda s: s.engine.first_batch_grace),
    "EVAM_TRANSFER": ("inline", lambda s: s.tpu.transfer,
                      lambda s: s.engine.transfer),
    "EVAM_TRANSFER_DEPTH": ("3", lambda s: s.tpu.transfer_depth,
                            lambda s: s.engine.transfer_depth),
    # slice 7b: ragged packing, the scheduler and the control plane
    "EVAM_RAGGED": ("packed", lambda s: s.tpu.ragged,
                    lambda s: s.engine.ragged),
    "EVAM_RAGGED_UNIT_BUDGET": ("2", lambda s: s.tpu.ragged_unit_budget,
                                lambda s: s.engine.ragged_unit_budget),
    # slice 7c: the fleet
    "EVAM_FLEET": ("sharded", lambda s: s.tpu.fleet,
                   lambda s: s.engine.fleet),
    "EVAM_FLEET_SHARDS": ("2", lambda s: s.tpu.fleet_shards,
                          lambda s: s.engine.fleet_shards),
    "EVAM_FLEET_SHARD_MAX_BATCH": (
        "16", lambda s: s.tpu.fleet_shard_max_batch,
        lambda s: s.engine.fleet_shard_max_batch),
    "EVAM_FLEET_MAX_SHARDS": ("4", lambda s: s.tpu.fleet_max_shards,
                              lambda s: s.engine.fleet_max_shards),
    **{var: (value, (lambda k: lambda s: getattr(s.sched, k))(key),
             (lambda k: lambda s: getattr(s.sched, k))(key))
       for var, value, key in [
           # the scheduler is on by default in both packages: "off"
           # is the value that differs from the default
           ("EVAM_SCHED", "off", "enabled"),
           ("EVAM_SCHED_ADMIT_UTIL", "0.7", "admit_util"),
           ("EVAM_SCHED_CAPACITY_FPS", "120", "capacity_fps"),
           ("EVAM_SCHED_DEFAULT_FPS", "20", "default_fps"),
           ("EVAM_SCHED_DEADLINE_MS_REALTIME", "2", "deadline_ms_realtime"),
           ("EVAM_SCHED_DEADLINE_MS_STANDARD", "6", "deadline_ms_standard"),
           ("EVAM_SCHED_DEADLINE_MS_BATCH", "40", "deadline_ms_batch"),
           ("EVAM_SCHED_STALENESS_MS_REALTIME", "100",
            "staleness_ms_realtime"),
           ("EVAM_SCHED_STALENESS_MS_STANDARD", "500",
            "staleness_ms_standard"),
           ("EVAM_SCHED_STALENESS_MS_BATCH", "9000", "staleness_ms_batch"),
       ]},
    **{var: (value, (lambda k: lambda s: getattr(s.tune, k))(key),
             (lambda k: lambda s: getattr(s.tune, k))(key))
       for var, value, key in [
           ("EVAM_TUNE", "1", "enabled"),
           ("EVAM_TUNE_INTERVAL_S", "0.25", "interval_s"),
           ("EVAM_TUNE_ACTIONS", "8", "actions"),
           ("EVAM_TUNE_DAMPING", "1", "damping"),
           ("EVAM_TUNE_COOLDOWN", "0", "cooldown"),
           ("EVAM_TUNE_UTIL_HI", "0.9", "util_hi"),
           ("EVAM_TUNE_UTIL_LO", "0.3", "util_lo"),
           ("EVAM_TUNE_SCALE_UP_UTIL", "0.95", "scale_up_util"),
           ("EVAM_TUNE_SCALE_DOWN_UTIL", "0.2", "scale_down_util"),
       ]},
    # the reference reads these in its engine modules, per engine
    # (the port's engines built from the settings, as the hub builds
    # them)
    "EVAM_BATCH_ASSEMBLY": ("legacy", lambda s: _ref_engine(
        lambda e: e.assembly), lambda s: _port_engine(
        s, lambda e: e.assembly)),
    "EVAM_STAGING_DEPTH": ("5", lambda s: _ref_engine(
        lambda e: e._ring.depth), lambda s: _port_engine(
        s, lambda e: e._ring.depth)),
    # (read per call by both devlock modules: the settings mirror it)
    "EVAM_SERIALIZE_COMPILE": ("yes", lambda s: _ref_engine(
        lambda e: not e._pipelined), lambda s: s.engine.serialize_compile),
}


def _ref_engine(read):
    """``read`` applied to a reference BatchEngine built under the
    current environment."""
    from evam_tpu.engine.batcher import BatchEngine as RefEngine

    eng = RefEngine("knob", lambda params, x: x, params=None,
                    input_names=("x",), stall_timeout_s=0)
    try:
        return read(eng)
    finally:
        eng.stop()


def _port_engine(settings, read):
    """``read`` applied to the port's BatchEngine built from
    ``settings`` as the hub builds it (the environment hidden: the
    settings alone carry the knob)."""
    import os

    from evam_tpu_torch.engine.batcher import BatchEngine

    saved = {k: os.environ.pop(k) for k in ("EVAM_BATCH_ASSEMBLY",
                                            "EVAM_STAGING_DEPTH")
             if k in os.environ}
    try:
        eng = BatchEngine("knob", lambda x: x, "cpu", input_names=("x",),
                          stall_timeout_s=0,
                          assembly=settings.engine.batch_assembly,
                          staging_depth=settings.engine.staging_depth or None,
                          transfer=settings.engine.transfer)
    finally:
        os.environ.update(saved)
    try:
        return read(eng)
    finally:
        eng.stop()


@pytest.mark.parametrize("var", sorted(_HONOURED))
def test_honoured_knob_parses_as_in_the_reference(var, monkeypatch):
    value, ref_read, port_read = _HONOURED[var]
    monkeypatch.setenv(var, value)
    ref = ref_settings.Settings.from_env()
    got = port_settings.Settings.from_env()
    assert port_read(got) == ref_read(ref)
    assert port_read(got) != port_read(port_settings.Settings())


@pytest.mark.parametrize("env", [
    {},
    {"EVAM_TRANSFER_DEPTH": "2", "EVAM_SCHED_ADMIT_UTIL": "0.85"},
    {"EVAM_MAX_BATCH": "64", "EVAM_BATCH_DEADLINE_MS": "8",
     "EVAM_SCHED": "1", "EVAM_SCHED_STALENESS_MS_BATCH": "10"},
], ids=["none", "defaults-set", "mixed"])
def test_fields_set_is_the_references_model_fields_set(env, monkeypatch):
    """The control plane pins the knobs the operator set: the port
    records them as pydantic's ``model_fields_set`` does, default
    values included."""
    for var in env:
        monkeypatch.setenv(var, env[var])
    ref = ref_settings.Settings.from_env()
    got = port_settings.Settings.from_env()
    assert got.engine.fields_set == set(ref.tpu.model_fields_set)
    assert got.sched.fields_set == set(ref.sched.model_fields_set)
    assert got.tune.fields_set == set(ref.tune.model_fields_set)


def test_config_file_then_env(monkeypatch, tmp_path):
    path = tmp_path / "evam.json"
    path.write_text(json.dumps({"rest_port": 9000, "models_dir": "/m",
                                "tpu": {"max_batch": 32, "precision": "int8"},
                                "sched": {"enabled": False}}))
    monkeypatch.setenv("EVAM_CONFIG_FILE", str(path))
    monkeypatch.setenv("REST_PORT", "9001")
    ref_settings.reset_settings()
    port_settings.reset_settings()
    try:
        ref = ref_settings.get_settings()
        got = port_settings.get_settings()
    finally:
        ref_settings.reset_settings()
        port_settings.reset_settings()
    assert (got.rest_port, got.models_dir, got.engine.max_batch,
            got.engine.precision) == (ref.rest_port, ref.models_dir,
                                      ref.tpu.max_batch, ref.tpu.precision)
    assert got.rest_port == 9001


def test_platform_selects_the_device(monkeypatch):
    assert port_settings.Settings.from_env(env={}).device == "cuda"
    assert port_settings.Settings.from_env(
        env={"EVAM_PLATFORM": "cpu"}).device == "cpu"
    with pytest.raises(ValueError, match="EVAM_PLATFORM"):
        port_settings.Settings.from_env(env={"EVAM_PLATFORM": "tpu"})


def _other_value(var: str, conv, port_value) -> str:
    special = {"EVAM_FLEET": "sharded"}
    if var in special:
        return special[var]
    if conv is port_settings._parse_bool:
        return "off" if port_value else "on"
    if conv is int:
        return str(port_value + 1)
    if conv is float:
        return str(port_value + 1.5)
    return "/srv/elsewhere"


_ENV_UNPORTED = [u for u in port_settings._UNPORTED if u[0] is not None]


@pytest.mark.parametrize("knob", _ENV_UNPORTED, ids=[u[0] for u in _ENV_UNPORTED])
def test_unported_knob_raises_naming_its_slice(knob, monkeypatch):
    var, block, key, conv, port_value, slice_ = knob
    # the port's own value is accepted, and it is what the reference
    # runs with
    port_settings.Settings.from_env(env={var: str(port_value)})
    ref_default = getattr(getattr(ref_settings.Settings(), block)
                          if block else ref_settings.Settings(), key)
    assert ref_default == port_value
    value = _other_value(var, conv, port_value)
    monkeypatch.setenv(var, value)
    ref_settings.Settings.from_env()  # a value the reference accepts
    with pytest.raises(NotImplementedError, match=r"port slice \d+") as info:
        port_settings.Settings.from_env()
    assert var in str(info.value)
    assert slice_ in str(info.value)


@pytest.mark.parametrize("var,values", [
    ("ENABLE_WEBRTC", ["1", "true", "0", "off"]),
    ("WEBRTC_SIGNALING_SERVER", ["ws://127.0.0.1:8443", ""]),
    ("EVAM_WEBRTC_VIDEO_MODE", ["key", "delta"]),
])
def test_webrtc_knobs_parse_as_the_reference(var, values, monkeypatch):
    """The three WebRTC knobs (slice 11b) are honoured: each value gives
    the reference's setting, and the defaults are the reference's."""
    key = port_settings._TOP_ENV[var][0]
    assert getattr(port_settings.Settings.from_env(env={}), key) == \
        getattr(ref_settings.Settings(), key)
    for value in values:
        monkeypatch.setenv(var, value)
        assert getattr(port_settings.Settings.from_env(), key) == \
            getattr(ref_settings.Settings.from_env(), key)


def test_webrtc_video_mode_refuses_what_the_reference_refuses(monkeypatch):
    monkeypatch.setenv("EVAM_WEBRTC_VIDEO_MODE", "gop")
    with pytest.raises(ValueError):
        ref_settings.Settings.from_env()
    with pytest.raises(ValueError, match="EVAM_WEBRTC_VIDEO_MODE"):
        port_settings.Settings.from_env()


def test_unported_config_file_keys_raise(tmp_path):
    path = tmp_path / "evam.json"
    path.write_text(json.dumps({"tpu": {"donate_buffers": False}}))
    with pytest.raises(NotImplementedError, match="tpu.donate_buffers"):
        port_settings.Settings.from_env(path, env={})
    path.write_text(json.dumps({"aot": {"enabled": True}}))
    with pytest.raises(NotImplementedError, match="aot.enabled"):
        port_settings.Settings.from_env(path, env={})
    path.write_text(json.dumps({"no_such_key": 1}))
    with pytest.raises(ValueError, match="no_such_key"):
        port_settings.Settings.from_env(path, env={})


#: the tracing, checkpoint, profiling and state-dir knobs, honoured
#: since slice 10: (env var, config-file block or "" for top level, key)
_SLICE10_KNOBS = (
    [(var, "trace", key) for var, (key, _) in port_settings._TRACE_ENV.items()]
    + [(var, "ckpt", key) for var, (key, _) in port_settings._CKPT_ENV.items()]
    + [("PROFILING_MODE", "", "profiling_mode"),
       ("EVAM_STATE_DIR", "", "state_dir")])


def _field(settings, block: str, key: str):
    return getattr(getattr(settings, block) if block else settings, key)


def _conv(var: str):
    for table in (port_settings._TOP_ENV, port_settings._TRACE_ENV,
                  port_settings._CKPT_ENV):
        if var in table:
            return table[var][1]
    raise KeyError(var)


@pytest.mark.parametrize("var,block,key", _SLICE10_KNOBS,
                         ids=[k[0] for k in _SLICE10_KNOBS])
def test_slice10_knob_parses_as_the_reference(var, block, key, monkeypatch):
    """Each knob has the reference's default (trace on, ckpt off), and
    a value the reference accepts reaches the same field with the same
    value in the port."""
    default = _field(port_settings.Settings.from_env(env={}), block, key)
    assert default == _field(ref_settings.Settings(), block, key)
    value = _other_value(var, _conv(var), default)
    monkeypatch.setenv(var, value)
    want = _field(ref_settings.Settings.from_env(), block, key)
    got = _field(port_settings.Settings.from_env(env={var: value}), block,
                 key)
    assert got == want != default


@pytest.mark.parametrize("var,block,key", _SLICE10_KNOBS,
                         ids=[k[0] for k in _SLICE10_KNOBS])
def test_slice10_config_file_key_parses_as_the_reference(var, block, key,
                                                         tmp_path):
    """The config file's ``trace`` and ``ckpt`` blocks and its top-level
    keys reach the same fields as the reference's."""
    default = _field(port_settings.Settings(), block, key)
    value = _conv(var)(_other_value(var, _conv(var), default))
    data = {block: {key: value}} if block else {key: value}
    path = tmp_path / "evam.json"
    path.write_text(json.dumps(data))
    want = _field(ref_settings.Settings.from_env(path), block, key)
    got = _field(port_settings.Settings.from_env(path, env={}), block, key)
    assert got == want == value


#: knobs the reference's modules read: (var, a value the port now runs
#: with, other values it accepts, and what it once raised naming — None
#: for all since slice 10)
_MODULE_CASES = [
    ("EVAM_DWCONV", "shift", ["lax", "LAX"], None),  # since slice 6
    ("EVAM_DWCONV", "SHIFT", ["lax"], None),
    ("EVAM_FAULT_INJECT", "drop=0.1", [""], None),  # since slice 10
    ("EVAM_FAULT_SEED", "7", [""], None),
]


@pytest.mark.parametrize("var,refused,accepted,slice_", _MODULE_CASES,
                         ids=[f"{c[0]}={c[1]}" for c in _MODULE_CASES])
def test_module_read_knob_raises_naming_its_slice(var, refused, accepted,
                                                  slice_, monkeypatch):
    """Every module-read knob is honoured now: the settings pass each
    value, and the port's module parses it as the reference's does."""
    assert slice_ is None
    for value in [refused, *accepted]:
        port_settings.Settings.from_env(env={var: value})
    if var == "EVAM_DWCONV":
        from evam_tpu.ops import depthwise as ref_dw
        from evam_tpu_torch.ops import depthwise as port_dw

        for value in [refused, *accepted]:
            monkeypatch.setenv(var, value)
            assert port_dw.use_shift_depthwise() \
                == ref_dw.use_shift_depthwise()
        assert port_dw.use_shift_depthwise() is False
        monkeypatch.setenv(var, refused)
        assert port_dw.use_shift_depthwise() is True
        return
    # the fault knobs: obs/faults.py's from_env, the same injector
    from evam_tpu.obs import faults as ref_faults
    from evam_tpu_torch.obs import faults as port_faults

    other = {"EVAM_FAULT_INJECT": ("EVAM_FAULT_SEED", "3"),
             "EVAM_FAULT_SEED": ("EVAM_FAULT_INJECT", "error=0.5")}[var]
    monkeypatch.setenv(*other)
    for value in [refused, *accepted]:
        monkeypatch.setenv(var, value)
        ref_faults.reset_cache()
        port_faults.reset_cache()
        want, got = ref_faults.from_env(), port_faults.from_env()
        assert (want is None) == (got is None)
        if want is not None:
            assert vars(got).keys() == vars(want).keys()
            for k in ("drop_p", "stall_p", "error_p", "corrupt_p"):
                assert getattr(got, k) == getattr(want, k)
            if value or var != "EVAM_FAULT_SEED":  # seeded: one stream
                assert got._rng.getstate() == want._rng.getstate()
    ref_faults.reset_cache()
    port_faults.reset_cache()


#: the native host library's knobs, honoured since slice 7c: (var, value,
#: the policy ``native.py`` reads from it)
_NATIVE_CASES = [
    ("EVAM_NO_NATIVE", "1", "off"),
    ("EVAM_NO_NATIVE", "0", "off"),
    ("EVAM_NATIVE", "1", "on"),
    ("EVAM_NATIVE_LIB", "/srv/libevam_media.so", "auto"),
]


@pytest.mark.parametrize("var,value,mode", _NATIVE_CASES,
                         ids=[f"{c[0]}={c[1]}" for c in _NATIVE_CASES])
def test_module_read_knob_is_honoured(var, value, mode, monkeypatch):
    """The host library's knobs pass ``Settings.from_env``, and mean
    what the reference's ``native`` module makes of them: off for any
    non-empty EVAM_NO_NATIVE ("0" included), on for EVAM_NATIVE whatever
    the host's cores; EVAM_NATIVE_LIB changes the library, not the
    policy (``tests/test_torch_native.py`` loads one through it)."""
    from evam_tpu import native as ref_native
    from evam_tpu_torch import native as port_native

    port_settings.Settings.from_env(env={var: value})
    assert port_native.native_mode({var: value}) == mode
    monkeypatch.setenv(var, value)
    monkeypatch.setattr("os.cpu_count", lambda: 2)
    if var == "EVAM_NO_NATIVE":
        # the reference reads it where it loads its library
        monkeypatch.setattr(ref_native, "_tried", False)
        monkeypatch.setattr(ref_native, "_lib", None)
    else:
        # its library present (a stand-in: only _load's None check
        # matters to the decision)
        monkeypatch.setattr(ref_native, "_load", lambda: object())
    monkeypatch.setattr(port_native, "_load", lambda: None)
    assert port_native._use_native() == ref_native._use_native() == (
        mode == "on")


def test_module_read_knobs_mean_what_the_reference_reads(monkeypatch):
    """The refused values change what the reference runs; the accepted
    ones do not."""
    from evam_tpu import native
    from evam_tpu.engine import devlock
    from evam_tpu.ops import depthwise

    for value, shift in (("shift", True), ("SHIFT", True), ("lax", False)):
        monkeypatch.setenv("EVAM_DWCONV", value)
        assert depthwise.use_shift_depthwise() is shift
    for value, on in (("1", True), ("yes", True), ("0", False), ("", False)):
        monkeypatch.setenv("EVAM_SERIALIZE_COMPILE", value)
        assert devlock.enabled() is on
    # EVAM_NO_NATIVE=0 is a non-empty value: the reference's native
    # library is then not loaded, so "0" turns the port's off too
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("EVAM_NO_NATIVE", "0")
    assert not native.available()
