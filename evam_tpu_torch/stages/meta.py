"""Metadata serialization and delivery stages (counterpart of ``evam_tpu/stages/meta.py``).

``MetaconvertStage`` renders a frame's regions/tensors/messages into the
reference's published JSON schema:

    {"objects": [{"detection": {"bounding_box": {"x_min": ..,
     "y_min": .., "x_max": .., "y_max": ..}, "confidence": ..,
     "label": "vehicle", "label_id": 2}, "h": 101, "w": 66, "x": 1,
     "y": 56, "roi_type": "vehicle"}],
     "resolution": {"height": 432, "width": 768},
     "source": "<uri>", "timestamp": 49000000000}

``PublishStage`` hands the metadata to a destination callback;
``SinkStage`` is the appsink.
"""

from __future__ import annotations

from typing import Any, Callable

from evam_tpu_torch.stages.base import Stage
from evam_tpu_torch.stages.context import FrameContext, Region


def region_to_object(region: Region, width: int, height: int) -> dict[str, Any]:
    x, y, w, h = region.rect(width, height)
    obj: dict[str, Any] = {
        "detection": {
            "bounding_box": {
                "x_min": region.x0,
                "y_min": region.y0,
                "x_max": region.x1,
                "y_max": region.y1,
            },
            "confidence": region.confidence,
            "label": region.label,
            "label_id": region.label_id,
        },
        "x": x,
        "y": y,
        "w": w,
        "h": h,
        "roi_type": region.label,
    }
    if region.object_id is not None:
        obj["id"] = region.object_id
    for tensor in region.tensors:
        if tensor.is_detection:
            continue
        obj[tensor.name] = {
            "label": tensor.label,
            "label_id": tensor.label_id,
            "confidence": tensor.confidence,
        }
    return obj


class MetaconvertStage(Stage):
    def __init__(self, name: str, properties: dict | None = None,
                 source_uri: str = ""):
        self.name = name
        props = properties or {}
        self.add_tensor_data = bool(props.get("add-tensor-data", False))
        self.source_uri = source_uri

    def process(self, ctx: FrameContext) -> list[FrameContext]:
        meta: dict[str, Any] = {
            "objects": [
                region_to_object(r, ctx.width, ctx.height) for r in ctx.regions
            ],
            "resolution": {"height": ctx.height, "width": ctx.width},
            "source": ctx.source_uri or self.source_uri,
            "timestamp": ctx.pts_ns,
        }
        if ctx.tensors:
            tensors = []
            for t in ctx.tensors:
                entry: dict[str, Any] = {
                    "name": t.name,
                    "label": t.label,
                    "label_id": t.label_id,
                    "confidence": t.confidence,
                }
                if self.add_tensor_data and t.data is not None:
                    entry["data"] = t.data
                tensors.append(entry)
            meta["tensors"] = tensors
        for message in ctx.messages:
            # UDF-attached messages merge at top level
            meta.update(message)
        ctx.metadata = meta
        return [ctx]


class PublishStage(Stage):
    def __init__(self, name: str,
                 publish_fn: Callable[[FrameContext], None] | None = None):
        self.name = name
        self.publish_fn = publish_fn

    def process(self, ctx: FrameContext) -> list[FrameContext]:
        if self.publish_fn is not None and ctx.metadata is not None:
            self.publish_fn(ctx)
        return [ctx]


class SinkStage(Stage):
    def __init__(self, name: str,
                 sink_fn: Callable[[FrameContext], None] | None = None):
        self.name = name
        self.sink_fn = sink_fn

    def process(self, ctx: FrameContext) -> list[FrameContext]:
        if self.sink_fn is not None:
            self.sink_fn(ctx)
        return [ctx]
