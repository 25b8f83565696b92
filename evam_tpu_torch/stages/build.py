"""Stage factory: resolved StageSpec chain → executable Stage objects.

Counterpart of ``evam_tpu/stages/build.py``. The graph layer
(``evam_tpu_torch.graph``) parses definitions and binds parameters;
this module instantiates the runtime stages, wiring engine-backed
stages to the shared EngineHub. Source/decode specs are handled by the
StreamInstance (they define IO, not per-frame transforms).

The port builds source, decode, detect, classify, metaconvert, publish
and sink, and — as the reference does — fuses a detect stage and the
classify stage after it into one ``FusedDetectClassifyStage`` (one
engine round trip) unless ``reclassify-interval`` > 1. Every other kind
raises ``NotImplementedError`` naming the slice that brings it.
"""

from __future__ import annotations

from typing import Callable

from evam_tpu_torch import slices
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.graph.spec import StageKind, StageSpec
from evam_tpu_torch.stages.base import Stage
from evam_tpu_torch.stages.context import FrameContext
from evam_tpu_torch.stages.infer import (
    ClassifyStage,
    DetectStage,
    FusedDetectClassifyStage,
)
from evam_tpu_torch.stages.meta import MetaconvertStage, PublishStage, SinkStage

#: stage kinds the reference builds that come with later slices
_LATER_KINDS = {
    StageKind.TRACK: slices.TRACK_GATE_RAGGED,
    StageKind.UDF: slices.TRACK_GATE_RAGGED,
    StageKind.CONVERT: slices.TRACK_GATE_RAGGED,
    StageKind.ACTION: slices.ACTION_AUDIO,
    StageKind.AUDIO_DETECT: slices.ACTION_AUDIO,
    StageKind.AUDIO_MIX: slices.ACTION_AUDIO,
    StageKind.LEVEL: slices.ACTION_AUDIO,
}


def _fusable(specs: list[StageSpec]) -> tuple[int, int] | None:
    """(detect index, classify index) of a detect stage whose following
    stages up to a classify are only track/convert (host stages whose
    order does not matter). A classify with reclassify-interval > 1 is
    not fusable: reusing attributes between reclassifications is host
    state the one fused step cannot hold."""
    for i, spec in enumerate(specs):
        if spec.kind != StageKind.DETECT:
            continue
        for j in range(i + 1, len(specs)):
            kind = specs[j].kind
            if kind == StageKind.CLASSIFY:
                props = specs[j].properties or {}
                if int(props.get("reclassify-interval", 1) or 1) > 1:
                    return None
                return (i, j)
            if kind not in (StageKind.TRACK, StageKind.CONVERT):
                break
    return None


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
    specs = list(specs)
    fused: FusedDetectClassifyStage | None = None
    fused_det_idx = -1
    pair = _fusable(specs)
    if pair is not None:
        di, ci = pair
        det, cls = specs[di], specs[ci]
        fused = FusedDetectClassifyStage(
            f"{det.name}+{cls.name}", det.model, cls.model,
            det.properties, cls.properties, hub)
        # ci > di, so dropping the classify spec leaves di valid
        specs = [s for k, s in enumerate(specs) if k != ci]
        fused_det_idx = di
    stages: list[Stage] = []
    for idx, spec in enumerate(specs):
        kind = spec.kind
        if kind in (StageKind.SOURCE, StageKind.DECODE):
            continue  # handled by the StreamInstance's source
        if kind == StageKind.DETECT:
            if fused is not None and idx == fused_det_idx:
                stages.append(fused)
            else:
                stages.append(
                    DetectStage(spec.name, spec.model, spec.properties, hub))
        elif kind == StageKind.CLASSIFY:
            stages.append(
                ClassifyStage(spec.name, spec.model, spec.properties, hub))
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
