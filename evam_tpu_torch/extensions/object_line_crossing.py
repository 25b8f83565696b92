"""Line-crossing spatial analytics UDF (a copy of
``evam_tpu/extensions/object_line_crossing.py``).

Counterpart of the reference's gvapython extension wired by
pipelines/object_tracking/object_line_crossing/pipeline.json:7 with
``object-line-crossing-config`` ``{lines: [{name, line: [[x1,y1],
[x2,y2]]}], ...}`` (same file :34-55). Requires tracked regions
(object_id from the track stage): an event fires when an object's
anchor point (bottom-center) crosses a line segment between
consecutive frames, with the crossing direction.
"""

from __future__ import annotations

import numpy as np

from evam_tpu_torch.stages.context import FrameContext


def _side(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> float:
    # explicit 2-D cross product: np.cross on 2-D vectors is
    # deprecated (NumPy 2.0) and will be removed
    u, v = b - a, p - a
    return float(u[0] * v[1] - u[1] * v[0])


def _segments_intersect(p1, p2, a, b) -> bool:
    d1 = _side(a, p1, p2)
    d2 = _side(b, p1, p2)
    d3 = _side(p1, a, b)
    d4 = _side(p2, a, b)
    return (d1 * d2 < 0) and (d3 * d4 < 0)


class ObjectLineCrossing:
    def __init__(self, lines: list[dict] | None = None,
                 enable_watermark: bool = False, log_level: str = "INFO",
                 **_ignored):
        self.lines = []
        for line in lines or []:
            pts = np.asarray(line["line"], np.float32)
            self.lines.append((line.get("name", "line"), pts[0], pts[1]))
        self._history: dict[int, np.ndarray] = {}
        self._last_seen: dict[int, int] = {}

    @staticmethod
    def _anchor(region) -> np.ndarray:
        # bottom-center of the box — the conventional footfall anchor
        return np.asarray([(region.x0 + region.x1) / 2.0, region.y1], np.float32)

    MAX_IDLE_FRAMES = 300  # prune anchors for objects gone this long

    def process_frame(self, ctx: FrameContext) -> bool:
        events = []
        # prune history of ids absent from recent frames (bounded memory
        # on 24/7 streams)
        seen_now = {r.object_id for r in ctx.regions if r.object_id is not None}
        for oid in seen_now:
            self._last_seen[oid] = ctx.seq
        stale = [
            oid for oid, s in self._last_seen.items()
            if ctx.seq - s > self.MAX_IDLE_FRAMES
        ]
        for oid in stale:
            self._last_seen.pop(oid, None)
            self._history.pop(oid, None)
        for region in ctx.regions:
            if region.object_id is None:
                continue
            anchor = self._anchor(region)
            prev = self._history.get(region.object_id)
            self._history[region.object_id] = anchor
            if prev is None:
                continue
            for name, a, b in self.lines:
                if _segments_intersect(prev, anchor, a, b):
                    direction = (
                        "clockwise" if _side(anchor, a, b) > 0 else "counterclockwise"
                    )
                    events.append(
                        {
                            "event-type": "object-line-crossing",
                            "line-name": name,
                            "related-objects": [
                                {"id": region.object_id, "roi_type": region.label}
                            ],
                            "directions": [direction],
                        }
                    )
        if events:
            ctx.messages.append({"events": events})
        return True
