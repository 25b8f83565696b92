"""The port's graph and settings layers against the reference's.

* Every pipeline JSON under ``pipelines/`` and ``eii/pipelines/`` loads
  through both ``PipelineLoader``s and resolves to the same stage specs
  (kind, name, model, properties) — with the default parameters and
  with each documented parameter set — or fails with the same
  ``ParameterError``.
* ``gst_compat.parse_template`` agrees on the templates of
  ``tests/test_graph.py``.
* ``Settings.from_env`` parses each knob the port honours as the
  reference does, and raises ``NotImplementedError`` naming a slice for
  each unported knob set to a value the port does not run with.

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
    "EVAM_MAX_BATCH": ("64", lambda s: s.tpu.max_batch,
                       lambda s: s.engine.max_batch),
    "EVAM_BATCH_DEADLINE_MS": ("12.5", lambda s: s.tpu.batch_deadline_ms,
                               lambda s: s.engine.batch_deadline_ms),
    "EVAM_PRECISION": ("int8", lambda s: s.tpu.precision,
                       lambda s: s.engine.precision),
    "EVAM_ALLOW_RANDOM_WEIGHTS": (
        "Yes", lambda s: ref_models._env_allows_random(),
        lambda s: s.allow_random_weights),
}


@pytest.mark.parametrize("var", sorted(_HONOURED))
def test_honoured_knob_parses_as_in_the_reference(var, monkeypatch):
    value, ref_read, port_read = _HONOURED[var]
    monkeypatch.setenv(var, value)
    ref = ref_settings.Settings.from_env()
    got = port_settings.Settings.from_env()
    assert port_read(got) == ref_read(ref)
    assert port_read(got) != port_read(port_settings.Settings())


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
    special = {"EVAM_TRANSFER": "pipelined", "EVAM_RAGGED": "packed",
               "EVAM_FLEET": "sharded", "EVAM_WEBRTC_VIDEO_MODE": "delta"}
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
#: knobs whose reference default turns on a subsystem the port lacks
_ON_IN_THE_REFERENCE = {"EVAM_WARMUP", "EVAM_ENGINE_SUPERVISE",
                        "EVAM_TRANSFER", "EVAM_SCHED", "EVAM_TRACE"}


@pytest.mark.parametrize("knob", _ENV_UNPORTED, ids=[u[0] for u in _ENV_UNPORTED])
def test_unported_knob_raises_naming_its_slice(knob, monkeypatch):
    var, block, key, conv, port_value, slice_ = knob
    # the port's own value is accepted, and it is what the reference
    # runs with unless the reference's default turns on a subsystem
    # the port lacks
    port_settings.Settings.from_env(env={var: str(port_value)})
    ref_default = getattr(getattr(ref_settings.Settings(), block)
                          if block else ref_settings.Settings(), key)
    assert ref_default == port_value or var in _ON_IN_THE_REFERENCE
    value = _other_value(var, conv, port_value)
    monkeypatch.setenv(var, value)
    ref_settings.Settings.from_env()  # a value the reference accepts
    with pytest.raises(NotImplementedError, match=r"port slice \d+") as info:
        port_settings.Settings.from_env()
    assert var in str(info.value)
    assert slice_ in str(info.value)


def test_unported_config_file_keys_raise(tmp_path):
    path = tmp_path / "evam.json"
    path.write_text(json.dumps({"tpu": {"mesh_shape": [2, 4]}}))
    with pytest.raises(NotImplementedError, match="tpu.mesh_shape"):
        port_settings.Settings.from_env(path, env={})
    path.write_text(json.dumps({"trace": {"enabled": True}}))
    with pytest.raises(NotImplementedError, match="trace.enabled"):
        port_settings.Settings.from_env(path, env={})
    path.write_text(json.dumps({"no_such_key": 1}))
    with pytest.raises(ValueError, match="no_such_key"):
        port_settings.Settings.from_env(path, env={})
