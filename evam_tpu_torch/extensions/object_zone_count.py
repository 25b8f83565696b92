"""Zone-count spatial analytics UDF (a copy of
``evam_tpu/extensions/object_zone_count.py``).

Counterpart of the reference's gvapython extension wired by
pipelines/object_detection/object_zone_count/pipeline.json:5-9 with
``object-zone-count-config`` ``{zones: [{name, polygon}],
enable_watermark, log_level}`` (same file :44-65). For each frame it
counts detections whose bounding-box corners fall inside each zone
polygon and attaches a zone-counting event per occupied zone.
"""

from __future__ import annotations

import numpy as np

from evam_tpu_torch.stages.context import FrameContext


def _point_in_polygon(x: float, y: float, poly: np.ndarray) -> bool:
    """Ray-casting point-in-polygon (poly: [N,2] normalized coords)."""
    inside = False
    n = len(poly)
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        if (yi > y) != (yj > y) and x < (xj - xi) * (y - yi) / (yj - yi + 1e-12) + xi:
            inside = not inside
        j = i
    return inside


class ObjectZoneCount:
    def __init__(self, zones: list[dict] | None = None,
                 enable_watermark: bool = False, log_level: str = "INFO",
                 **_ignored):
        self.zones = []
        for zone in zones or []:
            self.zones.append(
                (zone.get("name", "zone"), np.asarray(zone["polygon"], np.float32))
            )
        self.enable_watermark = enable_watermark

    def process_frame(self, ctx: FrameContext) -> bool:
        events = []
        for name, poly in self.zones:
            statuses = []
            count = 0
            for region in ctx.regions:
                corners = [
                    (region.x0, region.y0), (region.x1, region.y0),
                    (region.x0, region.y1), (region.x1, region.y1),
                ]
                inside = [_point_in_polygon(x, y, poly) for x, y in corners]
                if all(inside):
                    status = "within"
                elif any(inside):
                    status = "intersects"
                else:
                    continue
                count += 1
                statuses.append({"roi_type": region.label, "status": status})
            if count:
                events.append(
                    {
                        "event-type": "zone-count",
                        "zone-name": name,
                        "zone-count": count,
                        "related-objects": statuses,
                    }
                )
        if events:
            ctx.messages.append({"events": events})
        return True
