"""K1's operation and byte reckoning against hand counts, and the
frozen layer tables against the reference's layer lists."""

from __future__ import annotations

import math

import pytest

from gpubench.harness import reckon, spec


def test_k1_at_the_first_pointwise_layer_one_frame():
    # SeparableConv_0.Conv_1 at bucket 1: x [128·128, 32] bf16, w [64, 32]
    ops, nbytes = reckon.k1_launch(16384, 32, 64)
    assert ops == 67_108_864
    assert nbytes == 16384 * 32 * 2 + 64 * 32 + 256 + 256 + 16384 * 64 * 4
    assert nbytes == 5_245_440
    assert reckon.k1_bound_seconds(16384, 32, 64) == pytest.approx(
        5_245_440 / 3.35e12)


def test_k1_at_the_last_pointwise_layer_top_bucket():
    # SeparableConv_7.Conv_1 at bucket 128: x [128·16·16, 512], w [512, 512]
    ops, nbytes = reckon.k1_launch(32768, 512, 512)
    assert ops == 17_179_869_184
    assert nbytes == 100_929_536
    assert reckon.k1_bound_seconds(32768, 512, 512) == pytest.approx(
        max(ops / 1979e12, nbytes / 3.35e12))


@pytest.mark.parametrize("name,launches", [("pvb_attrs_int8", 13),
                                           ("pvb_detect_int8", 10)])
def test_the_tables_launch_k1_as_the_engines_do(name, launches):
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")
    shapes = reckon.k1_shapes(cfg["layers"], 128, 8)
    assert len(shapes) == launches
    # the first launch of a forward: 128 frames of 256·256 pixels
    assert shapes[0] == (128 * 256 * 256, 32, 64)
    if launches == 13:
        # the classifier's last: 128 frames × 8 ROIs of 5·5 pixels
        assert shapes[-1] == (128 * 8 * 25, 128, 256)


def test_the_detector_table_counts_its_operations():
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "pvb_detect_int8.json")
    det = [l for l in cfg["layers"] if l["model"] == "detector"]
    # the stem: 512·512 outputs × 32 channels × 3·3·3 taps, twice
    assert reckon.layer_ops(det[0]) == 2 * 512 * 512 * 32 * 27
    total = sum(reckon.layer_ops(l) for l in det)
    assert 6e9 < total < 9e9
    int8 = sum(reckon.layer_ops(l) for l in det if l["precision"] == "int8")
    assert reckon.peak_seconds(det, "frame") == pytest.approx(
        int8 / 1979e12 + (total - int8) / 989e12)
    assert math.isclose(sum(reckon.layer_ops(l) for l in det if reckon.is_k1(l))
                        / total, 0.55, abs_tol=0.15)
