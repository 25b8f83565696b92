"""The traffic generator: frames from the seed alone."""

from __future__ import annotations

import time
from concurrent.futures import Future

import numpy as np
import pytest

from gpubench.harness import load


def test_frame_seeds_are_the_seeds_alone():
    a = [load.frame_seed(3_000_000_017, s, i) for s in range(4)
         for i in range(8)]
    b = [load.frame_seed(3_000_000_017, s, i) for s in range(4)
         for i in range(8)]
    c = [load.frame_seed(3_000_000_018, s, i) for s in range(4)
         for i in range(8)]
    assert a == b and a != c
    assert all(0 <= x < 2**32 for x in a)
    assert len(set(a)) == len(a)


def test_the_kept_sample_is_one_in_n_from_the_seed():
    kept = [load.kept(5, s, i, 16) for s in range(64) for i in range(256)]
    assert kept == [load.kept(5, s, i, 16) for s in range(64)
                    for i in range(256)]
    assert 0.04 < np.mean(kept) < 0.09


class _Engine:
    """Resolves every submit at once with the frame's seed as its row."""

    def __init__(self):
        self.seen = []

    def submit(self, frames):
        fut = Future()
        self.seen.append(int(frames))
        fut.set_result(np.array([[float(frames)]]))
        return fut


def test_a_closed_loop_sends_the_same_frames_for_a_seed():
    mix = {"loop": "closed", "streams": 3, "outstanding": 2}
    runs = []
    for seed in (7, 7, 8):
        eng = _Engine()
        t0 = time.perf_counter()
        rec = load.Client(eng, mix, seed, keep_one_in=1).run(t0, 0.0, 1.0)
        runs.append(eng.seen)
        assert rec.seed == eng.seen
        assert all(d is not None for d in rec.done)
        assert sorted(rec.rows) == list(range(len(rec.seed)))
    assert runs[0] == runs[1] != runs[2]
    assert runs[0] == [load.frame_seed(7, s, 0) for s in range(3)] + \
        [load.frame_seed(7, s, 1) for s in range(3)]


def test_an_unknown_loop_is_refused():
    with pytest.raises(ValueError):
        load.Client(_Engine(), {"loop": "open"}, 1, 1).run(0.0, 0.0, 0.0)
