"""Parameter resolution: schema defaults + request overrides → stage props.

Counterpart of ``evam_tpu/graph/params.py`` (a copy).

Implements the reference's parameter-binding contract (SURVEY.md §2b):
each entry in ``parameters.properties`` binds to one or more elements via

* ``"element": "detection"`` — property name = parameter name
  (reference pipelines/object_detection/person/pipeline.json:19-26);
* ``"element": {"name": n, "property": p}`` — explicit property;
* ``"element": [ {...}, {...} ]`` — multi-element binding (reference
  pipelines/object_classification/vehicle_attributes/pipeline.json:40-48);
* ``"format": "element-properties"`` — the value is a dict of
  properties applied verbatim to the element;
* ``"format": "json"`` — the value is passed as one JSON-typed property
  (the gvapython ``kwarg``, reference
  pipelines/object_detection/object_zone_count/pipeline.json:44-65).

Defaults support ``{env[...]}`` interpolation
(``"default": "{env[DETECTION_DEVICE]}"``, same file :24).
"""

from __future__ import annotations

from typing import Any

from evam_tpu_torch.config.interpolate import interpolate_tree
from evam_tpu_torch.graph.spec import PipelineSpec, StageSpec


class ParameterError(ValueError):
    pass


_JSON_TYPES: dict[str, tuple[type, ...]] = {
    "string": (str,),
    "integer": (int,),
    "number": (int, float),
    "boolean": (bool,),
    "object": (dict,),
    "array": (list,),
}


def _check_type(name: str, value: Any, schema: dict[str, Any]) -> None:
    expected = schema.get("type")
    if expected is None:
        return
    # JSON Schema union, e.g. ["integer", "string"] — used by
    # inference-interval, which takes an int or the "adaptive" mode
    names = expected if isinstance(expected, list) else [expected]
    types: tuple[type, ...] = ()
    for n in names:
        types += _JSON_TYPES.get(n, ())
    if not types:
        return
    if ({"integer", "number"} & set(names) and "boolean" not in names
            and isinstance(value, bool)):
        raise ParameterError(f"parameter '{name}': expected {expected}, got bool")
    if not isinstance(value, types):
        raise ParameterError(
            f"parameter '{name}': expected {expected}, got {type(value).__name__}"
        )
    if "enum" in schema and value not in schema["enum"]:
        raise ParameterError(
            f"parameter '{name}': {value!r} not in enum {schema['enum']}"
        )


def _bindings(name: str, schema: dict[str, Any]) -> list[dict[str, Any]]:
    """Normalize the four binding forms to a list of binding dicts."""
    element = schema.get("element")
    if element is None:
        return []  # declared-but-unbound (e.g. 'bus-messages'): pipeline-level
    if isinstance(element, str):
        return [{"name": element, "property": name, "format": None}]
    if isinstance(element, dict):
        return [
            {
                "name": element["name"],
                "property": element.get("property", name),
                "format": element.get("format"),
            }
        ]
    if isinstance(element, list):
        out = []
        for item in element:
            out.extend(_bindings(name, {"element": item}))
        return out
    raise ParameterError(f"parameter '{name}': bad element binding {element!r}")


def resolve_parameters(
    pipeline: PipelineSpec,
    request_params: dict[str, Any] | None = None,
    env: dict[str, str] | None = None,
) -> tuple[list[StageSpec], dict[str, Any]]:
    """Apply defaults + request params to the pipeline's stages.

    Returns ``(stages, pipeline_level_params)`` where *stages* is a new
    stage list with bound properties merged in, and
    *pipeline_level_params* holds parameters with no element binding.
    """
    request_params = dict(request_params or {})
    schema_props: dict[str, Any] = (pipeline.parameters or {}).get("properties", {})

    unknown = set(request_params) - set(schema_props)
    if unknown:
        raise ParameterError(f"unknown parameters: {sorted(unknown)}")

    updates: dict[str, dict[str, Any]] = {}
    pipeline_level: dict[str, Any] = {}

    for name, schema in schema_props.items():
        if name in request_params:
            value = request_params[name]
        elif "default" in schema:
            value = interpolate_tree(schema["default"], env)
        else:
            continue
        _check_type(name, value, schema)

        bindings = _bindings(name, schema)
        if not bindings:
            pipeline_level[name] = value
            continue
        for b in bindings:
            target = updates.setdefault(b["name"], {})
            if b["format"] == "element-properties":
                if not isinstance(value, dict):
                    raise ParameterError(
                        f"parameter '{name}': element-properties needs an object"
                    )
                target.update(value)
            else:
                # 'json' format values stay structured — our stages take
                # dicts natively; serialization is a transport concern.
                target[b["property"]] = value

    known_stages = {s.name for s in pipeline.stages}
    missing = set(updates) - known_stages
    if missing:
        raise ParameterError(f"parameters bind to unknown stages: {sorted(missing)}")

    stages = [
        s.with_properties(updates[s.name]) if s.name in updates else s
        for s in pipeline.stages
    ]
    return stages, pipeline_level
