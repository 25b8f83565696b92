"""Ragged batching: masked packing and bucket consolidation
(counterpart of ``evam_tpu/engine/ragged.py``).

Engines bucket by batch size and zero-pad each block's tail, and a
classify engine also pads every item to a fixed ROI budget: a frame with
one vehicle still costs ``roi_budget`` crops. ``EVAM_RAGGED=packed``
turns on two mechanisms:

* **masked packing** (classify engines): each item carries its real
  region rows (``boxes`` of shape ``(k, 4)``, k in [0, max_units]); the
  staging ring packs them end to end into one fixed unit block with a
  segment-id vector (``seg[j]`` = the batch row that owns unit j, −1 on
  the pad tail), the step computes per unit with the pad rows masked to
  zero (``steps.build_classify_step_ragged``), and the completer hands
  item i the rows ``row_offset[i] : row_offset[i] + row_len[i]``.
  Unit occupancy becomes Σk / unit_rows(bucket) instead of the dense
  path's Σk / (bucket × max_units);
* **bucket consolidation** (every engine): adjacent buckets share a
  program — the ladder keeps the floor, the top and every other rung
  from the top, so fewer graphs are captured.

``EVAM_RAGGED=off`` (the default) keeps the dense bucketed path as it
was. The mode comes from ``Settings`` (``EVAM_RAGGED``), never from the
environment here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: valid EVAM_RAGGED values
RAGGED_MODES = ("packed", "off")


def ragged_mode(value: str | None = None) -> str:
    """Validate a ragged mode (None: ``off``)."""
    mode = value or "off"
    if mode not in RAGGED_MODES:
        raise ValueError(
            f"EVAM_RAGGED must be one of {'|'.join(RAGGED_MODES)}, "
            f"got {mode!r}")
    return mode


@dataclasses.dataclass(frozen=True)
class RaggedSpec:
    """Declares one engine input as ragged (variable leading dim).

    The spec rides the engine in both modes, so the occupancy accounting
    stays honest (a dense classify batch computes ``bucket × max_units``
    unit rows whatever the real region counts were); packing itself only
    happens in ``packed`` mode."""

    #: name of the ragged input ("boxes" for classify engines)
    input: str
    #: per-unit trailing shape ((4,): one normalized box)
    unit_shape: tuple[int, ...]
    #: unit dtype
    dtype: np.dtype = np.float32
    #: per-item unit cap (the stage's ROI budget)
    max_units: int = 8
    #: packed unit rows budgeted per batch row in the device shape,
    #: floored at max_units so a lone full item always fits
    unit_budget: int = 4

    def unit_rows(self, bucket: int) -> int:
        """Packed unit rows in the device shape for ``bucket`` items."""
        return max(self.max_units, bucket * self.unit_budget)


def consolidate_buckets(buckets: list[int], align: int = 1) -> list[int]:
    """Thin a power-of-two bucket ladder so adjacent shapes share a
    program: keep the floor, the top, and every other rung walking down
    from the top. A batch that would have used a dropped rung rounds up
    one rung; its pad rows are masked or discarded as before. ``align``
    (the reference's mesh data-axis size; 1 on one card) rounds every
    kept rung at or above it up to a multiple of it."""
    if len(buckets) <= 2:
        kept = list(buckets)
    else:
        keep = {buckets[0], buckets[-1]}
        for i in range(len(buckets) - 1, -1, -2):
            keep.add(buckets[i])
        kept = sorted(keep)
    if align > 1:
        kept = sorted({
            -(-b // align) * align if b >= align else b for b in kept
        })
    return kept
