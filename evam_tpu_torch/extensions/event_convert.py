"""Event-convert UDF: normalizes UDF events after metaconvert (a copy of
``evam_tpu/extensions/event_convert.py``).

Counterpart of the reference's gva_event_convert extension
(pipelines/object_detection/object_zone_count/pipeline.json:7): runs
after metaconvert and lifts events attached by analytics UDFs into
the serialized metadata's top-level ``events`` list.
"""

from __future__ import annotations

from evam_tpu_torch.stages.context import FrameContext


def process_frame(ctx: FrameContext) -> bool:
    if ctx.metadata is None:
        return True
    events = ctx.metadata.get("events")
    if events is None:
        return True
    # normalize: every event carries an event-type string
    ctx.metadata["events"] = [
        e if "event-type" in e else {**e, "event-type": "unknown"} for e in events
    ]
    return True
