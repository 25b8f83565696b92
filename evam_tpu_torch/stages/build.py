"""Stage factory: resolved StageSpec chain → executable Stage objects.

Counterpart of ``evam_tpu/stages/build.py``. The graph layer
(``evam_tpu_torch.graph``) parses definitions and binds parameters;
this module instantiates the runtime stages, wiring engine-backed
stages to the shared EngineHub. Source/decode specs are handled by the
StreamInstance (they define IO, not per-frame transforms).

The port builds every stage kind of the reference: source, decode,
detect, classify, action, audio_detect, audio_mix, level, track, udf,
convert, metaconvert, publish and sink, and — as the reference does —
fuses a detect stage and the classify stage after it (with only track
or convert stages between) into one ``FusedDetectClassifyStage`` (one
engine round trip) unless ``reclassify-interval`` > 1.
"""

from __future__ import annotations

from typing import Callable

from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.graph.spec import StageKind, StageSpec
from evam_tpu_torch.stages.base import Stage
from evam_tpu_torch.stages.context import FrameContext
from evam_tpu_torch.stages.infer import (
    ActionStage,
    AudioDetectStage,
    ClassifyStage,
    DetectStage,
    FusedDetectClassifyStage,
)
from evam_tpu_torch.stages.meta import MetaconvertStage, PublishStage, SinkStage
from evam_tpu_torch.stages.misc import AudioMixStage, ConvertStage, LevelStage
from evam_tpu_torch.stages.track import TrackStage
from evam_tpu_torch.stages.udf import UdfStage

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
        elif kind == StageKind.ACTION:
            stages.append(ActionStage(spec.name, spec.properties, hub))
        elif kind == StageKind.AUDIO_DETECT:
            stages.append(
                AudioDetectStage(spec.name, spec.model, spec.properties, hub))
        elif kind == StageKind.AUDIO_MIX:
            stages.append(AudioMixStage(spec.name, spec.properties))
        elif kind == StageKind.LEVEL:
            stages.append(LevelStage(spec.name, spec.properties))
        elif kind == StageKind.TRACK:
            stages.append(TrackStage(spec.name, spec.properties))
        elif kind == StageKind.UDF:
            stages.append(UdfStage(spec.name, spec.properties))
        elif kind == StageKind.METACONVERT:
            stages.append(
                MetaconvertStage(spec.name, spec.properties,
                                 source_uri=source_uri))
        elif kind == StageKind.PUBLISH:
            stages.append(PublishStage(spec.name, publish_fn))
        elif kind == StageKind.SINK:
            stages.append(SinkStage(spec.name, sink_fn))
        elif kind == StageKind.CONVERT:
            stages.append(ConvertStage(spec.name, spec.properties))
        else:
            raise ValueError(f"no runtime stage for kind {kind}")
    return stages
