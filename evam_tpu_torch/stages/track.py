"""Reuse of the last inferred detections on skipped frames.

Counterpart of ``RegionCoaster`` in ``evam_tpu/stages/track.py`` (a
copy, numpy only). The tracker (``IouTracker``, ``TrackStage``) comes
with a later slice.
"""

from __future__ import annotations

import numpy as np

from evam_tpu_torch.stages.context import Region


def _iou_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


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
      motion gate's skip path, which comes with a later slice).
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
