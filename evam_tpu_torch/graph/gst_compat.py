"""Compatibility parser for reference-style GStreamer launch templates.

Counterpart of ``evam_tpu/graph/gst_compat.py`` (a copy).

Lets the server serve an unmodified reference pipelines directory: a
``"type": "GStreamer"`` definition's ``template`` (a launch string like
``{auto_source} ! decodebin ! gvadetect model={models[...]} name=detection
! gvametaconvert ! gvametapublish ! appsink``, reference
pipelines/object_detection/person_vehicle_bike/pipeline.json:3-7) is
parsed into the same :class:`~evam_tpu_torch.graph.spec.StageSpec`
chain the native format produces. Element semantics map per SURVEY.md §2b.
"""

from __future__ import annotations

import shlex
from typing import Any

from evam_tpu_torch.graph.spec import StageKind, StageSpec
from evam_tpu_torch.graph.template import AUTO_SOURCE, model_ref_to_key

#: GStreamer/DL Streamer element name → stage kind.
ELEMENT_KINDS: dict[str, StageKind] = {
    "decodebin": StageKind.DECODE,
    "uridecodebin": StageKind.DECODE,
    "videoconvert": StageKind.CONVERT,
    "audioconvert": StageKind.CONVERT,
    "audioresample": StageKind.CONVERT,
    "audiomixer": StageKind.AUDIO_MIX,
    "level": StageKind.LEVEL,
    "gvadetect": StageKind.DETECT,
    "gvaclassify": StageKind.CLASSIFY,
    "gvatrack": StageKind.TRACK,
    "gvaactionrecognitionbin": StageKind.ACTION,
    "gvaaudiodetect": StageKind.AUDIO_DETECT,
    "gvapython": StageKind.UDF,
    "gvametaconvert": StageKind.METACONVERT,
    "gvametapublish": StageKind.PUBLISH,
    "gvawatermark": StageKind.CONVERT,
    "appsink": StageKind.SINK,
    "appsrc": StageKind.SOURCE,
    "urisourcebin": StageKind.SOURCE,
    "queue": StageKind.CONVERT,
}

_AUTO_NAMES = {
    StageKind.SOURCE: "source",
    StageKind.DECODE: "decode",
    StageKind.CONVERT: "convert",
    StageKind.METACONVERT: "metaconvert",
    StageKind.PUBLISH: "destination",
    StageKind.SINK: "appsink",
    StageKind.AUDIO_MIX: "audiomixer",
    StageKind.LEVEL: "level",
}


class TemplateParseError(ValueError):
    pass


def _coerce(value: str) -> Any:
    """GStreamer property strings → python scalars where unambiguous."""
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def parse_template(template: str | list[str]) -> list[StageSpec]:
    """Parse a launch template into an ordered stage chain."""
    if isinstance(template, list):
        template = "".join(template)
    stages: list[StageSpec] = []
    counters: dict[str, int] = {}

    for segment in template.split("!"):
        segment = segment.strip()
        if not segment:
            continue
        if segment == AUTO_SOURCE or segment.startswith("{auto_source}"):
            stages.append(StageSpec(StageKind.SOURCE, "source"))
            continue
        head = segment.split(",")[0].split()[0]
        if "/" in head and "=" not in head:
            # A caps filter like ``video/x-raw,format=BGRx`` or
            # ``audio/x-raw, channels=1,format=S16LE,rate=16000``:
            # becomes a convert stage carrying the format constraints.
            props = _parse_caps(segment)
            stages.append(
                StageSpec(StageKind.CONVERT, _fresh("caps", counters), props)
            )
            continue

        tokens = shlex.split(segment)
        element = tokens[0]
        kind = ELEMENT_KINDS.get(element)
        if kind is None:
            raise TemplateParseError(f"unknown element '{element}' in template")

        props: dict[str, Any] = {}
        model: str | None = None
        for token in tokens[1:]:
            if "=" not in token:
                raise TemplateParseError(f"bad property token '{token}'")
            key, _, value = token.partition("=")
            ref = model_ref_to_key(value)
            if ref is not None:
                if key == "model":
                    model = ref
                else:
                    # enc-model / dec-model / model-proc keep the
                    # symbolic ref for the action stage to resolve.
                    props[key] = ref
            else:
                props[key] = _coerce(value)

        name = props.pop("name", None) or _auto_name(kind, element, counters)
        stages.append(StageSpec(kind, str(name), props, model))

    return stages


def _parse_caps(segment: str) -> dict[str, Any]:
    parts = [p.strip() for p in segment.split(",")]
    props: dict[str, Any] = {"caps": parts[0]}
    for part in parts[1:]:
        if "=" in part:
            key, _, value = part.partition("=")
            props[key.strip()] = _coerce(value.strip())
    return props


def _auto_name(kind: StageKind, element: str, counters: dict[str, int]) -> str:
    base = _AUTO_NAMES.get(kind, element)
    return _fresh(base, counters)


def _fresh(base: str, counters: dict[str, int]) -> str:
    n = counters.get(base, 0)
    counters[base] = n + 1
    return base if n == 0 else f"{base}{n}"
