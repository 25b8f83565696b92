"""Stage factory: resolved StageSpec chain → executable Stage objects.

Counterpart of ``evam_tpu/stages/build.py``. The graph layer
(``evam_tpu_torch.graph``) parses definitions and binds parameters;
this module instantiates the runtime stages, wiring engine-backed
stages to the shared EngineHub. Source/decode specs are handled by the
StreamInstance (they define IO, not per-frame transforms).

This slice builds source, decode, detect, metaconvert, publish and
sink. Every other kind — and the fused detect+classify stage the
reference builds for a detect followed by a classify — raises
``NotImplementedError`` naming the slice that brings it.
"""

from __future__ import annotations

from typing import Callable

from evam_tpu_torch import slices
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.graph.spec import StageKind, StageSpec
from evam_tpu_torch.stages.base import Stage
from evam_tpu_torch.stages.context import FrameContext
from evam_tpu_torch.stages.infer import DetectStage
from evam_tpu_torch.stages.meta import MetaconvertStage, PublishStage, SinkStage

#: stage kinds the reference builds that come with later slices
_LATER_KINDS = {
    StageKind.CLASSIFY: slices.DETECT_CLASSIFY,
    StageKind.TRACK: slices.TRACK_GATE_RAGGED,
    StageKind.UDF: slices.TRACK_GATE_RAGGED,
    StageKind.CONVERT: slices.TRACK_GATE_RAGGED,
    StageKind.ACTION: slices.ACTION_AUDIO,
    StageKind.AUDIO_DETECT: slices.ACTION_AUDIO,
    StageKind.AUDIO_MIX: slices.ACTION_AUDIO,
    StageKind.LEVEL: slices.ACTION_AUDIO,
}


def build_stages(
    specs: list[StageSpec],
    hub: EngineHub,
    source_uri: str = "",
    publish_fn: Callable[[FrameContext], None] | None = None,
    sink_fn: Callable[[FrameContext], None] | None = None,
) -> list[Stage]:
    # refuse before building anything (a half-built chain would have
    # created engines for a pipeline that cannot run), naming every
    # stage that waits and its slice
    later = [f"stage '{spec.name}' ({spec.kind.value}) comes with "
             f"{_LATER_KINDS[spec.kind]}"
             for spec in specs if spec.kind in _LATER_KINDS]
    if later:
        raise NotImplementedError("; ".join(later))
    stages: list[Stage] = []
    for spec in specs:
        kind = spec.kind
        if kind in (StageKind.SOURCE, StageKind.DECODE):
            continue  # handled by the StreamInstance's source
        if kind == StageKind.DETECT:
            stages.append(
                DetectStage(spec.name, spec.model, spec.properties, hub))
        elif kind == StageKind.METACONVERT:
            stages.append(
                MetaconvertStage(spec.name, spec.properties,
                                 source_uri=source_uri))
        elif kind == StageKind.PUBLISH:
            stages.append(PublishStage(spec.name, publish_fn))
        elif kind == StageKind.SINK:
            stages.append(SinkStage(spec.name, sink_fn))
        else:
            raise ValueError(f"no runtime stage for kind {kind}")
    return stages
