"""Whole runs on the CPU at a toy size: the program's fused and detect
engines held to the reference, the control (the reference at int4 in
the program's place) refused, and the program with a fault planted
under the timed path refused.

The toy cuts the real configurations to 128×128 frames with their
widths kept, holds them to the real configurations' limits, and skips
the harness's look for a card."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from gpubench.harness import cell, spec
from gpubench.tests.toy import make_root, toy_config

SEED = 3_000_000_019
CLOSED = {"loop": "closed", "streams": 4, "outstanding": 2}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """Run a toy cell of ``base`` (a real configuration's name); returns
    (exit code, the result line)."""
    from evam_tpu_torch.ops import qlinear

    monkeypatch.setattr(qlinear, "QGEMM_BACKEND", "pallas")
    saved = dict(os.environ)

    def go(base, traffic=CLOSED, trace=0, seconds=2.0):
        bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
        root, bench_dir = make_root(
            tmp_path / f"{base}-{trace}-{len(os.listdir(tmp_path))}",
            {base: toy_config(base)}, {"mix": traffic},
            [{"name": "toy.cell", "config": base, "traffic": "mix",
              "chips": 1, "why": "toy"}], bench)
        args = cell.parse(["--workload", "toy.cell", "--seed", str(SEED),
                           "--seconds", str(seconds), "--trace", str(trace)])
        rc = cell.run(args, device="cpu", require_cuda=False, root=root,
                      bench_dir=bench_dir)
        return rc, root, bench_dir

    yield go
    os.environ.clear()
    os.environ.update(saved)


def _last(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("base", ["pvb_attrs_int8", "pvb_detect_int8"])
def test_the_program_is_correct_at_toy_size(toy, capsys, base):
    rc, _, _ = toy(base)
    out = _last(capsys)
    assert rc == 0
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) >= {"setup_s"}
    assert list(out)[-1] == "checks"


def test_a_traced_run_reads_the_engine_counters(toy, capsys):
    rc, _, _ = toy("pvb_attrs_int8", trace=1)
    out = _last(capsys)
    assert rc == 0 and out["correct"] is True
    assert out["metrics"]["engine_host_ms.sat"]["value"] > 0


def _plant(monkeypatch, fault):
    from evam_tpu_torch.engine import steps

    real = steps.wrap_device_synth

    def wrap(step_fn, wire_shape):
        inner = real(step_fn, wire_shape)

        def broken(seeds, *rest):
            return fault(inner(seeds, *rest))

        broken.libraries = inner.libraries
        return broken

    monkeypatch.setattr(steps, "wrap_device_synth", wrap)


def _half_left_out(out):
    out = out.clone()
    half = out.shape[0] // 2
    out[half:] = 0.0
    out[half:, :, 5] = -1.0
    return out


def _answer_moved(out):
    """Every frame's first row: its box moved right by 0.03."""
    out = out.clone()
    out[:, 0, 0:4:2] = torch.clamp(out[:, 0, 0:4:2] + 0.03, max=1.0)
    return out


@pytest.mark.parametrize("fault", [_half_left_out, _answer_moved],
                         ids=["half_of_the_batch_left_out",
                              "an_answer_altered"])
@pytest.mark.parametrize("base", ["pvb_attrs_int8", "pvb_detect_int8"])
def test_a_fault_under_the_timed_path_is_not_correct(toy, capsys,
                                                     monkeypatch, fault,
                                                     base):
    _plant(monkeypatch, fault)
    rc, _, _ = toy(base)
    out = _last(capsys)
    assert rc == 0
    assert out["correct"] is False, out["checks"]


def _plant_nms(monkeypatch, fault):
    """Replace the detect step's NMS by ``fault(real, boxes, scores,
    **kwargs)``."""
    from evam_tpu_torch.engine import steps

    real = steps.batched_nms
    monkeypatch.setattr(
        steps, "batched_nms",
        lambda boxes, scores, **kw: fault(real, boxes, scores, **kw))


def _nms_skipped(real, boxes, scores, **kw):
    """The top-k rows served with no suppression."""
    return real(boxes, scores, **{**kw, "iou_threshold": 1.5})


def _nms_too_eager(real, boxes, scores, **kw):
    return real(boxes, scores, **{**kw, "iou_threshold": 0.05})


def _top_k_of_the_first_level_alone(real, boxes, scores, **kw):
    """The top-k cut drawn from the first level's anchors alone (three
    quarters of the anchors, at four anchors a cell)."""
    first = boxes.shape[1] * 3 // 4
    scores = scores.clone()
    scores[:, first:, 1:] = 0.0
    return real(boxes, scores, **kw)


def _first_row_lost(real, boxes, scores, **kw):
    """Each frame's first valid row dropped after NMS, the others moved
    up as the contract packs them."""
    bx, sc, lb, valid = real(boxes, scores, **kw)
    drop = valid[:, :1]

    def up(t, fill):
        moved = torch.cat([t[:, 1:], torch.full_like(t[:, :1], fill)], 1)
        shape = drop.shape + (1,) * (t.dim() - 2)
        return torch.where(drop.reshape(shape), moved, t)

    return up(bx, 0), up(sc, 0), up(lb, -1), up(valid, False)


@pytest.mark.parametrize("fault", [_nms_skipped, _nms_too_eager,
                                   _top_k_of_the_first_level_alone,
                                   _first_row_lost],
                         ids=["nms_skipped", "nms_too_eager",
                              "top_k_of_one_level", "a_row_lost"])
@pytest.mark.parametrize("base", ["pvb_attrs_int8", "pvb_detect_int8"])
def test_a_fault_in_the_top_k_cut_or_nms_is_not_correct(
        toy, capsys, monkeypatch, fault, base):
    _plant_nms(monkeypatch, fault)
    rc, _, _ = toy(base)
    out = _last(capsys)
    assert rc == 0
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("base", ["pvb_attrs_int8", "pvb_detect_int8"])
def test_the_control_is_not_correct(tmp_path, base):
    """The reference at int4 in the program's place, on three seeds:
    at least one number over its limit on each."""
    from gpubench.tools import control

    root, bench_dir = make_root(
        tmp_path, {base: toy_config(base)}, {"mix": CLOSED},
        [{"name": "toy.cell", "config": base, "traffic": "mix", "chips": 1,
          "why": "toy"}])
    c = spec.load_cell("toy.cell", root, bench_dir)
    limits = c.config["check"]["limits"]
    for seed in (SEED, SEED + 1, SEED + 2):
        numbers, _ = control.readings(c, seed, 4, 16, "cpu")
        assert any(numbers[k] > limits[k] for k in limits), numbers
        sane, _ = control.readings(c, seed, 0, 16, "cpu")
        assert all(sane[k] <= limits[k] for k in limits), sane
        assert np.isfinite(list(numbers.values())).all()
