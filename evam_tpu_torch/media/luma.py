"""Downsampled luma grid for the motion gate: the numpy copy.

A copy of the numpy path of ``luma_grid`` in ``evam_tpu/native.py``,
bit-identical to the native kernel (``csrc/evam_media.cpp``): the same
sample lattice, BT.601 integer luma and floor-divided box mean, so the
port's gate scores — and so its run/skip decisions — equal the
reference's on every frame. The gate calls ``native.luma_grid``, which
runs the library or, when the policy turns it off, this copy.
"""

from __future__ import annotations

import numpy as np

#: sample points per grid-cell edge (the native kernel's lattice)
LUMA_SAMPLES = 4


def luma_grid(frame: np.ndarray, gh: int = 16, gw: int = 16) -> np.ndarray:
    """BT.601 luma of a BGR uint8 ``[H, W, 3]`` frame, averaged over a
    ``gh × gw`` grid of ``LUMA_SAMPLES²`` point samples per cell: uint8
    ``[gh, gw]``, O(gh·gw·16) work whatever the frame's size."""
    h, w = frame.shape[:2]
    s = LUMA_SAMPLES
    n, m = gh * s, gw * s
    ys = ((2 * np.arange(n, dtype=np.int64) + 1) * h) // (2 * n)
    xs = ((2 * np.arange(m, dtype=np.int64) + 1) * w) // (2 * m)
    px = frame[np.ix_(ys, xs)].astype(np.int32)  # [n, m, 3] BGR
    luma = ((66 * px[..., 2] + 129 * px[..., 1] + 25 * px[..., 0] + 128)
            >> 8) + 16
    luma = np.clip(luma, 0, 255)
    return (
        luma.reshape(gh, s, gw, s).transpose(0, 2, 1, 3)
        .reshape(gh, gw, s * s).sum(axis=2) // (s * s)
    ).astype(np.uint8)
