"""Host-side multi-object tracker (gvatrack counterpart) and the reuse
of the last inferred detections on skipped frames.

Counterpart of ``evam_tpu/stages/track.py`` (a copy, numpy only).
``TrackStage`` assigns persistent ``object_id``s (the published
objects' ``id``) with an ``IouTracker`` whose ``tracking-type`` sets
its behaviour:

* ``zero-term`` / ``zero-term-imageless`` — ids persist only across
  consecutive detections: an unmatched track is dropped at once;
* ``short-term`` / ``short-term-imageless`` — unmatched tracks coast
  for ``max-age`` frames with constant-velocity extrapolation;
* ``iou`` — greedy IoU with age-based expiry, no motion model.

The arithmetic is the reference's, float32 numpy in the same order, so
the same regions get the same ids (the greedy match walks
``np.argsort(-iou, axis=None)``: equal IoUs resolve in numpy's order in
both). ``RegionCoaster`` serves the detect stages' skip paths.
Tracking state is per-stream host state; it never enters a step.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from evam_tpu_torch.stages.base import Stage
from evam_tpu_torch.stages.context import FrameContext, Region

log = logging.getLogger("evam_tpu_torch.stages.track")


def _iou_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


@dataclass
class _Track:
    track_id: int
    box: np.ndarray
    label_id: int
    age: int = 0
    hits: int = 1
    vel: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))


class IouTracker:
    def __init__(self, iou_threshold: float = 0.3, max_age: int = 10,
                 extrapolate: bool = False):
        self.iou_threshold = iou_threshold
        self.max_age = max_age
        self.extrapolate = extrapolate
        self.tracks: list[_Track] = []
        self._next_id = 1

    def update(self, regions: list[Region]) -> None:
        """Assign object_ids to regions in place."""
        if self.tracks and regions:
            det_boxes = np.stack([r.box for r in regions])
            trk_boxes = np.stack([t.box for t in self.tracks])
            iou = _iou_matrix_np(trk_boxes, det_boxes)
            # class-gated: a person detection never continues a car track
            for ti, t in enumerate(self.tracks):
                for di, r in enumerate(regions):
                    if r.label_id != t.label_id:
                        iou[ti, di] = 0.0
        else:
            iou = np.zeros((len(self.tracks), len(regions)), np.float32)

        matched_tracks: set[int] = set()
        matched_dets: set[int] = set()
        if iou.size:
            order = np.dstack(
                np.unravel_index(np.argsort(-iou, axis=None), iou.shape))[0]
            for ti, di in order:
                if iou[ti, di] < self.iou_threshold:
                    break
                if ti in matched_tracks or di in matched_dets:
                    continue
                matched_tracks.add(int(ti))
                matched_dets.add(int(di))
                track = self.tracks[ti]
                new_box = np.asarray(regions[di].box, np.float32)
                old_box = np.asarray(track.box, np.float32)
                if track.age == 0:
                    # velocity from consecutive hits only: a coasted box
                    # already has it applied
                    track.vel = new_box - old_box
                track.box = new_box
                track.age = 0
                track.hits += 1
                regions[di].object_id = track.track_id

        for di, region in enumerate(regions):
            if di in matched_dets:
                continue
            track = _Track(self._next_id, np.asarray(region.box, np.float32),
                           region.label_id)
            self._next_id += 1
            self.tracks.append(track)
            region.object_id = track.track_id

        survivors = []
        assigned = {r.object_id for r in regions}
        for ti, track in enumerate(self.tracks):
            if ti not in matched_tracks and track.track_id not in assigned:
                track.age += 1
                if self.extrapolate:
                    # constant-velocity coast: the next match gates
                    # against the predicted position
                    track.box = track.box + track.vel
            if track.age <= self.max_age:
                survivors.append(track)
        self.tracks = survivors

    def state_dict(self) -> dict:
        """Serializable tracker state (live tracks and the id counter)
        for a stream checkpoint: a restored stream keeps its ids."""
        return {
            "next_id": int(self._next_id),
            "tracks": [
                {
                    "track_id": int(t.track_id),
                    "box": [float(v) for v in t.box],
                    "label_id": int(t.label_id),
                    "age": int(t.age),
                    "hits": int(t.hits),
                    "vel": [float(v) for v in t.vel],
                }
                for t in self.tracks
            ],
        }

    def load_state(self, state: dict) -> None:
        self._next_id = max(int(state.get("next_id", 1)), self._next_id)
        tracks = []
        for row in state.get("tracks", []):
            try:
                tracks.append(_Track(
                    track_id=int(row["track_id"]),
                    box=np.asarray(row["box"], np.float32),
                    label_id=int(row["label_id"]),
                    age=int(row.get("age", 0)),
                    hits=int(row.get("hits", 1)),
                    vel=np.asarray(row.get("vel", [0, 0, 0, 0]), np.float32),
                ))
            except (KeyError, TypeError, ValueError):
                continue  # a malformed track row is dropped, not fatal
        self.tracks = tracks


class RegionCoaster:
    """Copy-on-write reuse + constant-velocity coasting of the last
    inferred detections.

    * ``observe(regions)`` records each real inference and estimates
      per-region velocity by class-gated greedy IoU match against the
      previous inference;
    * ``reuse()`` returns fresh Region objects (later stages set
      ``object_id`` and append to ``tensors``) sharing the immutable
      Tensor payloads, value-equal to the last detections;
    * ``coast(steps)`` returns the same clones advanced ``steps``
      frames along the estimated velocity, clipped to [0, 1] (the
      motion gate's skip path).
    """

    def __init__(self) -> None:
        self._regions: list[Region] = []
        self._vels: list[np.ndarray] = []

    def observe(self, regions: list[Region]) -> None:
        vels = [np.zeros(4, np.float32) for _ in regions]
        if self._regions and regions:
            prev_boxes = np.stack([r.box for r in self._regions])
            cur_boxes = np.stack([r.box for r in regions])
            iou = _iou_matrix_np(prev_boxes, cur_boxes)
            for pi, p in enumerate(self._regions):
                for ci, c in enumerate(regions):
                    if p.label_id != c.label_id:
                        iou[pi, ci] = 0.0
            used_prev: set[int] = set()
            used_cur: set[int] = set()
            order = np.dstack(
                np.unravel_index(np.argsort(-iou, axis=None), iou.shape))[0]
            for pi, ci in order:
                if iou[pi, ci] < 0.05:
                    break
                if pi in used_prev or ci in used_cur:
                    continue
                used_prev.add(int(pi))
                used_cur.add(int(ci))
                vels[ci] = cur_boxes[ci] - prev_boxes[pi]
        self._regions = regions
        self._vels = vels

    @staticmethod
    def _clone(region: Region, delta: np.ndarray) -> Region:
        box = np.clip(region.box + delta, 0.0, 1.0)
        return Region(
            x0=float(box[0]), y0=float(box[1]),
            x1=float(box[2]), y1=float(box[3]),
            confidence=region.confidence,
            label_id=region.label_id,
            label=region.label,
            object_id=region.object_id,
            # fresh list, shared (never-mutated) Tensor payloads: a
            # later stage's append touches only this frame's clone
            tensors=list(region.tensors),
        )

    def reuse(self) -> list[Region]:
        """Value-equal stand-ins for the last detections."""
        zero = np.zeros(4, np.float32)
        return [self._clone(r, zero) for r in self._regions]

    def coast(self, steps: int) -> list[Region]:
        """The last detections advanced ``steps`` frames along their
        estimated velocities."""
        if steps <= 0:
            return self.reuse()
        return [self._clone(r, v * float(steps))
                for r, v in zip(self._regions, self._vels)]

    def state_dict(self) -> dict:
        """Serializable coaster state (the last detections' geometry and
        identity, and their velocities) for a stream checkpoint.
        Classifier tensors are not carried: a restored coast serves
        boxes and ids until the next inference."""
        return {
            "regions": [
                {
                    "box": [r.x0, r.y0, r.x1, r.y1],
                    "confidence": float(r.confidence),
                    "label_id": int(r.label_id),
                    "label": r.label,
                    "object_id": r.object_id,
                }
                for r in self._regions
            ],
            "vels": [[float(v) for v in vel] for vel in self._vels],
        }

    def load_state(self, state: dict) -> None:
        regions, vels = [], []
        raw_vels = state.get("vels", [])
        for i, row in enumerate(state.get("regions", [])):
            try:
                box = row["box"]
                regions.append(Region(
                    x0=float(box[0]), y0=float(box[1]),
                    x1=float(box[2]), y1=float(box[3]),
                    confidence=float(row.get("confidence", 0.0)),
                    label_id=int(row.get("label_id", 0)),
                    label=str(row.get("label", "")),
                    object_id=row.get("object_id"),
                ))
            except (KeyError, TypeError, ValueError, IndexError):
                continue
            vel = raw_vels[i] if i < len(raw_vels) else [0, 0, 0, 0]
            vels.append(np.asarray(vel, np.float32))
        self._regions = regions
        self._vels = vels


class TrackStage(Stage):
    """gvatrack counterpart. Properties: tracking-type, max-age,
    iou-threshold."""

    #: tracking-type → (max-age override, motion extrapolation)
    _TYPES = {
        "iou": (None, False),
        "zero-term": (0, False),
        "zero-term-imageless": (0, False),
        "short-term": (None, True),
        "short-term-imageless": (None, True),
    }

    def __init__(self, name: str, properties: dict):
        self.name = name
        ttype = properties.get("tracking-type", "iou")
        if ttype not in self._TYPES:
            raise ValueError(f"unsupported tracking-type '{ttype}'")
        max_age_override, extrapolate = self._TYPES[ttype]
        max_age = int(properties.get("max-age", 10))
        if max_age_override is not None:
            max_age = max_age_override
        self.tracker = IouTracker(
            iou_threshold=float(properties.get("iou-threshold", 0.3)),
            max_age=max_age,
            extrapolate=extrapolate,
        )
        log.info("tracker %s: type=%s coasting max_age=%d extrapolate=%s",
                 name, ttype, max_age, extrapolate)

    def process(self, ctx: FrameContext) -> list[FrameContext]:
        self.tracker.update(ctx.regions)
        return [ctx]

    def snapshot(self) -> dict | None:
        # id monotonicity is the invariant across restarts; the live
        # tracks re-associate within a few frames and ride along only
        # with EVAM_CKPT on, where a migration resumes mid-scene
        from evam_tpu_torch import state as stream_state

        if stream_state.active() is not None:
            return {"next_id": self.tracker._next_id,
                    "tracker": self.tracker.state_dict()}
        return {"next_id": self.tracker._next_id}

    def restore(self, state: dict) -> None:
        self.tracker._next_id = int(state.get("next_id", 1))
        if state.get("tracker"):
            self.tracker.load_state(state["tracker"])
