"""The port's OpenVINO IR importer against ``evam_tpu.models.ir``.

The same IR files (written by the IR builder, inline as
``tests/test_ir.py`` writes them, or by ``tests/test_ir_fuzz.py``'s
random graph generator) go through both importers:

* parser and constant folder: equal exactly — layers, edges, the layer
  order, every const (values and dtypes, folded ones included), the
  weight dict, anchors, variances, ``output_is_prob`` and
  ``yolo_specs``;
* single-op and small-graph forwards: ``rtol = atol = 1e-5``;
* the fuzz graphs (the reference's seeds) and TensorIterator
  sequences: ``1e-4``;
* bfloat16: ``2e-2``;
* ``EVAM_IR_LAYOUT=nchw`` against ``nhwc`` and ``EVAM_DWCONV=shift``
  against ``lax``: ``1e-5`` in the port, and each against the
  reference's own variant.

The guards raise where the reference's raise.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from evam_tpu.models import ir as jir
from evam_tpu_torch.models import ir as tir
from evam_tpu_torch.models.ir_build import (
    IRBuilder,
    build_aclnet_like_ir,
    build_action_decoder_like_ir,
    build_attributes_like_ir,
    build_crossroad_like_ir,
)
from test_ir import (  # the reference's fixtures
    _build_classifier_ir,
    _build_ssd_ir,
    _build_yolo_ir,
    _identity_ti_ir,
)
from test_ir_fuzz import FuzzGraph, _compress_to_fp16, moify

torch.set_num_threads(1)


def _run_both(xml, x, layout=None):
    """The reference's and the port's outputs on ``x`` (numpy)."""
    jm = jir.build_ir_model(jir.parse_ir(xml), layout=layout)
    tm = tir.load_ir(xml, layout=layout)
    ref = jm.forward(jm.params, x)
    with torch.inference_mode():
        got = tm(torch.from_numpy(np.ascontiguousarray(x)))
    assert list(ref) == list(got)
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()})


def _assert_close(ref: dict, got: dict, tol: float) -> None:
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        if ref[k].dtype.kind in "fc":
            np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ------------------------------------------------------------ the parser


def _fixture_irs(tmp: Path) -> dict[str, Path]:
    out = {}
    for name, fn in (("classifier", _build_classifier_ir),
                     ("ssd", _build_ssd_ir), ("yolo", _build_yolo_ir)):
        d = tmp / name
        d.mkdir()
        out[name] = fn(d)[0]
    out["crossroad"] = build_crossroad_like_ir(
        tmp / "crossroad", input_size=(48, 64), width=8)[0]
    out["attributes"] = build_attributes_like_ir(
        tmp / "attributes", input_size=24, width=4)[0]
    out["decoder"] = build_action_decoder_like_ir(
        tmp / "decoder", clip_len=4, embed_dim=8, hidden=4, num_classes=5)[0]
    out["aclnet"] = build_aclnet_like_ir(
        tmp / "aclnet", window=400, width=4, num_classes=7)[0]
    return out


def _graphs_equal(a, b) -> None:
    assert a.name == b.name
    assert list(a.layers) == list(b.layers)
    for lid, la in a.layers.items():
        lb = b.layers[lid]
        assert (la.name, la.type, la.attrs) == (lb.name, lb.type, lb.attrs)
        assert [(p.id, p.shape) for p in la.inputs] == \
            [(p.id, p.shape) for p in lb.inputs]
        assert [(p.id, p.shape) for p in la.outputs] == \
            [(p.id, p.shape) for p in lb.outputs]
        if la.type == "TensorIterator":
            ea, eb = la.extra, lb.extra
            assert (ea["inputs"], ea["outputs"], ea["back_edges"]) == \
                (eb["inputs"], eb["outputs"], eb["back_edges"])
            _graphs_equal(ea["body"], eb["body"])
    assert a.edges == b.edges
    assert list(a.consts) == list(b.consts)
    for lid in a.consts:
        assert a.consts[lid].dtype == b.consts[lid].dtype
        np.testing.assert_array_equal(a.consts[lid], b.consts[lid])
    assert [l.id for l in a.topo_order()] == [l.id for l in b.topo_order()]


IR_NAMES = ["classifier", "ssd", "yolo", "crossroad", "attributes",
            "decoder", "aclnet"]


@pytest.mark.parametrize("name", IR_NAMES)
def test_parser_and_folder_equal_the_reference(tmp_path, name):
    xml = _fixture_irs(tmp_path)[name]
    ja, ta = jir.parse_ir(xml), tir.parse_ir(xml)
    _graphs_equal(ja, ta)
    jir.constant_fold(ja)
    tir.constant_fold(ta)
    _graphs_equal(ja, ta)

    jm, tm = jir.load_ir(xml), tir.load_ir(xml)
    for attr in ("name", "input_shape", "output_names", "output_shapes",
                 "output_is_prob", "is_detector", "detector_kind",
                 "variances", "num_classes", "detection_attrs",
                 "yolo_specs", "input_hw"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    if jm.anchors is None:
        assert tm.anchors is None
    else:
        assert tm.anchors.dtype == jm.anchors.dtype
        np.testing.assert_array_equal(tm.anchors, jm.anchors)
    assert list(tm.params) == list(jm.params)
    for k, v in jm.params.items():
        assert str(tm.params[k].dtype) == f"torch.{v.dtype}", k
        np.testing.assert_array_equal(tm.params[k].numpy(), v)


def test_bf16_and_fp16_consts(tmp_path):
    """A bf16 const widens to float32 by the 16-bit shift (no
    ml_dtypes) and an fp16-compressed IR keeps its f16 weights, as the
    reference reads them; the compressed SSD's outputs match."""
    b = IRBuilder("bf16net")
    x = b.layer("Parameter", {"shape": "1,4", "element_type": "f32"},
                out_shapes=((1, 4),), name="input")
    w = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    words = (w.view(np.uint32) >> 16).astype(np.uint16)
    off = len(b.blob)
    b.blob.extend(words.tobytes())
    wc = b.layer("Const", {"element_type": "bf16", "shape": "4,3",
                           "offset": off, "size": words.nbytes},
                 out_shapes=((4, 3),), name="w_bf16")
    mm = b.layer("MatMul", {"transpose_a": "false", "transpose_b": "false"},
                 inputs=[(x[0], x[1], (1, 4)), (wc[0], wc[1], (4, 3))],
                 out_shapes=((1, 3),), name="mm")
    b.result((mm[0], mm[1], (1, 3)))
    (tmp_path / "bf").mkdir()
    xml = b.write(tmp_path / "bf")
    jm, tm = jir.load_ir(xml), tir.load_ir(xml)
    assert tm.params["w_bf16"].dtype == torch.float32
    np.testing.assert_array_equal(tm.params["w_bf16"].numpy(),
                                  jm.params["w_bf16"])
    xin = np.random.default_rng(1).normal(size=(1, 4)).astype(np.float32)
    _assert_close(*_run_both(xml, xin), 1e-5)

    xml32 = build_crossroad_like_ir(tmp_path / "c32", input_size=48,
                                    width=8)[0]
    xml16 = _compress_to_fp16(xml32, tmp_path / "c16")
    jm, tm = jir.load_ir(xml16), tir.load_ir(xml16)
    assert {str(v.dtype) for v in tm.params.values()} == \
        {f"torch.{v.dtype}" for v in jm.params.values()}
    xin = np.random.default_rng(3).uniform(
        0, 255, (1, 3, 48, 48)).astype(np.float32)
    ref, got = _run_both(xml16, xin)
    _assert_close(ref, got, 1e-4)


# -------------------------------------------------------- single ops


def _single(tmp, ltype, attrs, x, consts=(), n_out=1, out_shape=None):
    """Parameter(x) (+ consts) → one op → Result(s); returns the xml."""
    b = IRBuilder("single_op")
    p = b.layer("Parameter", {"shape": ",".join(map(str, x.shape)),
                              "element_type": "f32"},
                out_shapes=[tuple(x.shape)], name="input")
    inputs = [(p[0], p[1], tuple(x.shape))]
    for arr in consts:
        c = b.const(np.asarray(arr))
        inputs.append((*c, tuple(np.asarray(arr).shape)))
    shape = tuple(out_shape or x.shape)
    op = b.layer(ltype, attrs, inputs=inputs, out_shapes=[shape] * n_out,
                 name="op")
    for i in range(n_out):
        b.result((op[0], op[1] + i, shape))
    return b.write(tmp)


_RNG = np.random.default_rng(2026)
X4 = _RNG.normal(size=(2, 3, 5, 6)).astype(np.float32)
X2 = _RNG.normal(size=(3, 7)).astype(np.float32)
XPOS = np.abs(X4) + 0.1
I64 = np.int64

#: (id, type, attrs, input, consts, outputs, declared output shape)
SINGLE_OPS = [
    ("conv_explicit_asym", "Convolution",
     {"strides": "2,1", "pads_begin": "0,1", "pads_end": "2,0",
      "dilations": "1,1"}, X4,
     [_RNG.normal(size=(4, 3, 3, 2)).astype(np.float32)], 1, None),
    ("conv_same_lower_dil", "Convolution",
     {"strides": "2,2", "auto_pad": "same_lower", "dilations": "2,1"}, X4,
     [_RNG.normal(size=(2, 3, 3, 3)).astype(np.float32)], 1, None),
    ("conv_same_upper", "Convolution",
     {"strides": "2,2", "auto_pad": "same_upper"}, X4,
     [_RNG.normal(size=(2, 3, 3, 3)).astype(np.float32)], 1, None),
    ("conv1d", "Convolution",
     {"strides": "2", "pads_begin": "1", "pads_end": "2"},
     _RNG.normal(size=(2, 3, 9)).astype(np.float32),
     [_RNG.normal(size=(4, 3, 3)).astype(np.float32)], 1, None),
    ("gconv_grouped", "GroupConvolution",
     {"strides": "1,1", "pads_begin": "1,0", "pads_end": "0,1"},
     _RNG.normal(size=(1, 4, 5, 5)).astype(np.float32),
     [_RNG.normal(size=(2, 3, 2, 2, 2)).astype(np.float32)], 1, None),
    ("gconv_depthwise_s2", "GroupConvolution",
     {"strides": "2,2", "pads_begin": "1,1", "pads_end": "1,1"}, X4,
     [_RNG.normal(size=(3, 1, 1, 3, 3)).astype(np.float32)], 1, None),
    ("maxpool_ceil", "MaxPool",
     {"kernel": "2,2", "strides": "2,2", "pads_begin": "0,0",
      "pads_end": "0,0", "rounding_type": "ceil"}, X4, [], 1, None),
    ("maxpool_pads", "MaxPool",
     {"kernel": "3,2", "strides": "2,1", "pads_begin": "1,0",
      "pads_end": "0,1"}, X4, [], 1, None),
    ("avgpool_exclude_asym", "AvgPool",
     {"kernel": "3,3", "strides": "2,2", "pads_begin": "1,0",
      "pads_end": "1,2", "exclude-pad": "true"}, X4, [], 1, None),
    ("avgpool_include_ceil", "AvgPool",
     {"kernel": "2,3", "strides": "2,2", "pads_begin": "0,1",
      "pads_end": "0,1", "exclude-pad": "false", "rounding_type": "ceil"},
     X4, [], 1, None),
    ("avgpool_same_upper", "AvgPool",
     {"kernel": "3,3", "strides": "2,2", "auto_pad": "same_upper"}, X4, [],
     1, None),
    ("maxpool_1d", "MaxPool",
     {"kernel": "3", "strides": "2", "pads_begin": "1", "pads_end": "1"},
     _RNG.normal(size=(2, 3, 9)).astype(np.float32), [], 1, None),
    *[(f"unary_{t}", t, {}, X4, [], 1, None)
      for t in ("ReLU", "Sigmoid", "Tanh", "Exp", "HSwish", "Swish", "Mish",
                "Abs", "Negative", "Floor", "Ceiling", "Erf", "HSigmoid",
                "SoftPlus", "Gelu", "Round", "Sign")],
    ("sqrt", "Sqrt", {}, XPOS, [], 1, None),
    ("log", "Log", {}, XPOS, [], 1, None),
    ("gelu_tanh", "Gelu", {"approximation_mode": "tanh"}, X4, [], 1, None),
    ("elu", "Elu", {"alpha": "0.3"}, X4, [], 1, None),
    ("clamp", "Clamp", {"min": "-0.2", "max": "0.4"}, X4, [], 1, None),
    ("softmax_axis3", "SoftMax", {"axis": "3"}, X4, [], 1, None),
    *[(f"eltwise_{t}", t, {}, XPOS,
       [_RNG.uniform(0.5, 1.5, (1, 3, 1, 6)).astype(np.float32)], 1, None)
      for t in ("Add", "Multiply", "Subtract", "Divide", "Power",
                "Maximum", "Minimum")],
    ("prelu", "PReLU", {}, X4,
     [_RNG.uniform(0.1, 0.5, (1, 3, 1, 1)).astype(np.float32)], 1, None),
    *[(f"reduce_{t}_{keep}", t, {"keep_dims": keep}, X4,
       [np.asarray([1, 3], I64)], 1, None)
      for t in ("ReduceMean", "ReduceMax", "ReduceSum", "ReduceMin",
                "ReduceProd", "ReduceL1", "ReduceL2")
      for keep in ("true", "false")],
    ("matmul_ta_tb", "MatMul", {"transpose_a": "true", "transpose_b": "true"},
     X2, [_RNG.normal(size=(4, 3)).astype(np.float32)], 1, None),
    ("matmul_batched", "MatMul", {}, X4,
     [_RNG.normal(size=(6, 2)).astype(np.float32)], 1, None),
    ("reshape_special_zero", "Reshape", {"special_zero": "true"}, X4,
     [np.asarray([0, -1, 6], I64)], 1, None),
    ("squeeze_all", "Squeeze", {},
     _RNG.normal(size=(1, 3, 1, 2)).astype(np.float32), [], 1, None),
    ("squeeze_axes", "Squeeze", {},
     _RNG.normal(size=(1, 3, 1, 2)).astype(np.float32),
     [np.asarray([2], I64)], 1, None),
    ("unsqueeze", "Unsqueeze", {}, X2, [np.asarray([0, 3], I64)], 1, None),
    ("transpose", "Transpose", {}, X4, [np.asarray([3, 1, 0, 2], I64)], 1,
     None),
    ("concat_const", "Concat", {"axis": "-1"}, X2,
     [_RNG.normal(size=(3, 2)).astype(np.float32)], 1, None),
    ("split", "Split", {"num_splits": "3"},
     _RNG.normal(size=(2, 6, 2)).astype(np.float32),
     [np.asarray(1, I64)], 3, None),
    ("variadic_split", "VariadicSplit", {}, X2,
     [np.asarray(1, I64), np.asarray([2, -1, 1], I64)], 3, None),
    ("convert_f16", "Convert", {"destination_type": "f16"}, X4, [], 1, None),
    ("convert_i32", "Convert", {"destination_type": "i32"}, X4 * 3, [], 1,
     None),
    ("batchnorm", "BatchNormInference", {"epsilon": "1e-3"}, X4,
     [_RNG.uniform(0.5, 1.5, 3).astype(np.float32),
      _RNG.normal(size=3).astype(np.float32),
      _RNG.normal(size=3).astype(np.float32),
      _RNG.uniform(0.5, 2, 3).astype(np.float32)], 1, None),
    ("mvn_across", "MVN", {"across_channels": "true", "eps": "1e-6"}, X4,
     [], 1, None),
    ("mvn_axes_outside", "MVN", {"eps": "1e-4", "eps_mode": "outside_sqrt",
                                 "normalize_variance": "true"}, X4,
     [np.asarray([1, 3], I64)], 1, None),
    ("mvn_no_var", "MVN", {"normalize_variance": "false"}, X4, [], 1, None),
    ("fake_quantize", "FakeQuantize", {"levels": "7"}, X4,
     [np.float32(-1.0), np.float32(1.5), np.float32(-2.0),
      np.float32(2.0)], 1, None),
    ("gather_neg", "Gather", {}, X4,
     [np.asarray([[-1, 0], [2, -3]], I64), np.asarray(1, I64)], 1, None),
    ("gather_axis_last", "Gather", {}, X4,
     [np.asarray([5, 0, 3], I64), np.asarray([-1], I64)], 1, None),
    ("pad_constant_value", "Pad", {"pad_mode": "constant"}, X4,
     [np.asarray([0, 1, 2, 0], I64), np.asarray([1, 0, 1, 3], I64),
      np.float32(0.7)], 1, None),
    *[(f"pad_{mode}", "Pad", {"pad_mode": mode}, X4,
       [np.asarray([0, 0, 2, 1], I64), np.asarray([0, 0, 1, 3], I64)], 1,
       None)
      for mode in ("reflect", "symmetric", "edge")],
    *[(f"interp_{mode}_{tag}", "Interpolate", {"mode": mode}, X4, [], 1,
       shape)
      for mode in ("nearest", "linear", "linear_onnx", "cubic")
      for tag, shape in (("up", (1, 3, 9, 13)), ("down", (1, 3, 3, 4)),
                         ("mixed", (1, 3, 8, 4)))],
    ("topk_min_ties", "TopK", {"axis": "1", "mode": "min", "sort": "value",
                               "index_element_type": "i64"},
     np.asarray([[2.0, 1.0, 3.0, 1.0, 1.0, 0.5]], np.float32),
     [np.asarray(3, I64)], 2, (1, 3)),
    ("topk_max_ties_index", "TopK", {"axis": "1", "mode": "max",
                                     "sort": "index"},
     np.asarray([[1.0, 3.0, 3.0, 2.0, 3.0]], np.float32),
     [np.asarray(2, I64)], 2, (1, 2)),
    ("topk_axis0", "TopK", {"axis": "0", "mode": "max", "sort": "value"},
     X2, [np.asarray(2, I64)], 2, (2, 7)),
    ("reverse_sequence_axes", "ReverseSequence",
     {"batch_axis": "1", "seq_axis": "0"}, X2.T.copy(),
     [np.asarray([1, 7, 4], I64)], 1, None),
    ("hardsigmoid", "HardSigmoid", {}, X4,
     [np.float32(0.3), np.float32(0.4)], 1, None),
    ("selu", "Selu", {}, X4, [np.float32(1.6733), np.float32(1.0507)], 1,
     None),
    ("tile", "Tile", {}, X2, [np.asarray([2, 1, 3], I64)], 1, None),
    ("normalize_max", "NormalizeL2", {"eps": "0.5", "eps_mode": "max"}, X4,
     [np.asarray([1], I64)], 1, None),
    ("normalize_add", "NormalizeL2", {"eps": "1e-6", "eps_mode": "add"}, X4,
     [np.asarray([2, 3], I64)], 1, None),
    ("lrn", "LRN", {"alpha": "0.01", "beta": "0.75", "bias": "2.0",
                    "size": "3"},
     _RNG.normal(size=(1, 5, 3, 3)).astype(np.float32),
     [np.asarray([1], I64)], 1, None),
    *[(f"s2d_{mode}", "SpaceToDepth", {"block_size": "2", "mode": mode},
       _RNG.normal(size=(1, 2, 4, 6)).astype(np.float32), [], 1, None)
      for mode in ("blocks_first", "depth_first")],
    *[(f"d2s_{mode}", "DepthToSpace", {"block_size": "2", "mode": mode},
       _RNG.normal(size=(1, 8, 2, 3)).astype(np.float32), [], 1, None)
      for mode in ("blocks_first", "depth_first")],
    ("round_away", "Round", {"mode": "half_away_from_zero"},
     np.asarray([[0.5, 1.5, -0.5, -2.5, 2.4, -0.6]], np.float32), [], 1,
     None),
    ("round_even", "Round", {},
     np.asarray([[0.5, 1.5, -0.5, -2.5, 2.4, -0.6]], np.float32), [], 1,
     None),
]


@pytest.mark.parametrize("case", SINGLE_OPS, ids=[c[0] for c in SINGLE_OPS])
def test_single_op_matches_the_reference(tmp_path, case):
    _, ltype, attrs, x, consts, n_out, out_shape = case
    xml = _single(tmp_path, ltype, attrs, x, consts, n_out, out_shape)
    _assert_close(*_run_both(xml, x), 1e-5)


def _chain(tmp, x, build):
    """Parameter(x) → build(b, p) → Result of the returned ref."""
    b = IRBuilder("chain")
    p = b.layer("Parameter", {"shape": ",".join(map(str, x.shape)),
                              "element_type": "f32"},
                out_shapes=[tuple(x.shape)], name="input")
    out = build(b, (p[0], p[1], tuple(x.shape)))
    b.result(out)
    return b.write(tmp)


def test_comparisons_logic_and_select(tmp_path):
    """Every comparison and logical op, Select on their masks and Convert
    of a mask, against the reference."""
    x = _RNG.normal(size=(2, 5)).astype(np.float32)
    y = np.round(_RNG.normal(size=(2, 5)), 1).astype(np.float32)
    x[0, :2] = y[0, :2]  # some equal pairs

    def build(b, inp):
        shp = inp[2]
        yc = b.const(y, "y")
        masks = []
        for t in ("Greater", "GreaterEqual", "Less", "LessEqual", "Equal",
                  "NotEqual"):
            m = b.layer(t, inputs=[inp, (*yc, shp)], out_shapes=[shp],
                        name=t.lower())
            masks.append((m[0], m[1], shp))
        cur = masks[0]
        for t, other in (("LogicalAnd", masks[3]), ("LogicalOr", masks[4]),
                         ("LogicalXor", masks[5])):
            m = b.layer(t, inputs=[cur, other], out_shapes=[shp],
                        name=t.lower())
            cur = (m[0], m[1], shp)
        m = b.layer("LogicalNot", inputs=[cur], out_shapes=[shp], name="not")
        sel = b.layer("Select", inputs=[(m[0], m[1], shp), inp, (*yc, shp)],
                      out_shapes=[shp], name="select")
        cv = b.layer("Convert", {"destination_type": "f32"},
                     inputs=[masks[1]], out_shapes=[shp], name="mask_f")
        add = b.layer("Add", inputs=[(sel[0], sel[1], shp),
                                     (cv[0], cv[1], shp)],
                      out_shapes=[shp], name="sum")
        return (add[0], add[1], shp)

    _assert_close(*_run_both(_chain(tmp_path, x, build), x), 1e-5)


def test_integer_divide_and_runtime_gather(tmp_path):
    """Integers computed at run time: Convert to i32, Divide by an
    integer constant (true division, as jnp.divide divides), and a
    Gather into a weight table by indices computed from the input."""
    x = (_RNG.normal(size=(2, 6)) * 4).astype(np.float32)

    def build(b, inp):
        shp = inp[2]
        xi = b.layer("Convert", {"destination_type": "i32"}, inputs=[inp],
                     out_shapes=[shp], name="xi")
        div = b.layer("Divide",
                      inputs=[(xi[0], xi[1], shp),
                              (*b.const(np.asarray([3], I64), "three"), (1,))],
                      out_shapes=[shp], name="div")
        cl = b.layer("Clamp", {"min": "0", "max": "4"}, inputs=[inp],
                     out_shapes=[shp], name="cl")
        idx = b.layer("Convert", {"destination_type": "i32"},
                      inputs=[(cl[0], cl[1], shp)], out_shapes=[shp],
                      name="idx")
        table = _RNG.normal(size=(5,)).astype(np.float32)
        g = b.layer("Gather",
                    inputs=[(*b.const(table, "table"), (5,)),
                            (idx[0], idx[1], shp),
                            (*b.const(np.asarray(0, I64)), ())],
                    out_shapes=[shp], name="g")
        out = b.layer("Add", inputs=[(g[0], g[1], shp),
                                     (div[0], div[1], shp)],
                      out_shapes=[shp], name="out")
        return (out[0], out[1], shp)

    _assert_close(*_run_both(_chain(tmp_path, x, build), x), 1e-5)


def test_lstm_and_gru_cells(tmp_path):
    """LSTMCell (fico gates) and GRUCell (zrh) with runtime state."""
    d, hs = 5, 3
    x = _RNG.normal(size=(2, d)).astype(np.float32)

    def build(b, inp):
        h0 = b.const(_RNG.normal(size=(2, hs)).astype(np.float32), "h0")
        c0 = b.const(_RNG.normal(size=(2, hs)).astype(np.float32), "c0")
        cell = b.layer(
            "LSTMCell", {"hidden_size": str(hs)},
            inputs=[inp, (*h0, (2, hs)), (*c0, (2, hs)),
                    (*b.const(_RNG.normal(size=(4 * hs, d)).astype(
                        np.float32), "W"), (4 * hs, d)),
                    (*b.const(_RNG.normal(size=(4 * hs, hs)).astype(
                        np.float32), "R"), (4 * hs, hs)),
                    (*b.const(_RNG.normal(size=(4 * hs,)).astype(
                        np.float32), "B"), (4 * hs,))],
            out_shapes=((2, hs), (2, hs)), name="lstm")
        gru = b.layer(
            "GRUCell", {"hidden_size": str(hs)},
            inputs=[inp, (cell[0], cell[1] + 1, (2, hs)),
                    (*b.const(_RNG.normal(size=(3 * hs, d)).astype(
                        np.float32), "GW"), (3 * hs, d)),
                    (*b.const(_RNG.normal(size=(3 * hs, hs)).astype(
                        np.float32), "GR"), (3 * hs, hs)),
                    (*b.const(_RNG.normal(size=(3 * hs,)).astype(
                        np.float32), "GB"), (3 * hs,))],
            out_shapes=((2, hs),), name="gru")
        out = b.layer("Add", inputs=[(cell[0], cell[1], (2, hs)),
                                     (gru[0], gru[1], (2, hs))],
                      out_shapes=((2, hs),), name="out")
        return (out[0], out[1], (2, hs))

    _assert_close(*_run_both(_chain(tmp_path, x, build), x), 1e-5)


def test_ctc_greedy_decoder(tmp_path):
    t_len, n, c = 6, 2, 4
    logits = np.full((t_len, n, c), -5.0, np.float32)
    for col, path in enumerate(([2, 2, 3, 1, 1, 0], [3, 3, 3, 0, 0, 1])):
        for t_i, cls in enumerate(path):
            logits[t_i, col, cls] = 5.0
    mask = np.ones((t_len, n), np.float32)
    mask[4:, 1] = 0
    for merge in ("true", "false"):
        sub = tmp_path / merge
        sub.mkdir()
        xml = _single(sub, "CTCGreedyDecoder", {"ctc_merge_repeated": merge},
                      logits, [mask], out_shape=(n, t_len, 1, 1))
        _assert_close(*_run_both(xml, logits), 0)


def test_reference_fixture_graphs(tmp_path):
    """The reference's hand-built fixtures: the classifier, the tiny
    SSD and the YOLO head, at batch 2."""
    for name, fn in (("classifier", _build_classifier_ir),
                     ("ssd", _build_ssd_ir), ("yolo", _build_yolo_ir)):
        d = tmp_path / name
        d.mkdir()
        xml = fn(d)[0]
        shape = jir.parse_ir(xml).layers[0].outputs[0].shape
        x = _RNG.normal(size=(2,) + tuple(shape[1:])).astype(np.float32)
        _assert_close(*_run_both(xml, x), 1e-5)


def test_crossroad_ssd_matches_an_independent_torch_forward(tmp_path):
    """The crossroad-like SSD (input 64, width 8) against the repo's
    independent torch forward of the same weights
    (``tools/gen_omz_ir.py::torch_reference_forward``), and against the
    reference's import, at 1e-5."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    from gen_omz_ir import torch_reference_forward

    xml, weights, _ = build_crossroad_like_ir(tmp_path, input_size=64,
                                              width=8, num_classes=4)
    x = np.random.default_rng(2).normal(size=(2, 3, 64, 64)).astype(
        np.float32)
    ref, got = _run_both(xml, x)
    _assert_close(ref, got, 1e-5)
    loc, conf = torch_reference_forward(weights, x, 8, 4)
    np.testing.assert_allclose(got["loc"], loc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["conf"], conf, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- TensorIterator


def _ti_lstm_ir(tmp, t, d, hs):
    """The reference test's TI: LSTMCell body, h/c back-edges, the h
    sequence concatenated along axis 1 and the last h."""
    rng = np.random.default_rng(9)
    w = rng.normal(size=(4 * hs, d)).astype(np.float32)
    r = rng.normal(size=(4 * hs, hs)).astype(np.float32)
    bias = rng.normal(size=(4 * hs,)).astype(np.float32)
    body = IRBuilder("body")
    bx = body.layer("Parameter", {"shape": f"1,1,{d}", "element_type": "f32"},
                    out_shapes=((1, 1, d),), name="xt")
    bh = body.layer("Parameter", {"shape": f"1,{hs}", "element_type": "f32"},
                    out_shapes=((1, hs),), name="h_in")
    bc_ = body.layer("Parameter", {"shape": f"1,{hs}", "element_type": "f32"},
                     out_shapes=((1, hs),), name="c_in")
    sq = body.layer("Squeeze",
                    inputs=[(bx[0], bx[1], (1, 1, d)),
                            (*body.const(np.asarray([1], I64)), (1,))],
                    out_shapes=((1, d),), name="squeeze")
    cell = body.layer(
        "LSTMCell", {"hidden_size": str(hs)},
        inputs=[(sq[0], sq[1], (1, d)), (bh[0], bh[1], (1, hs)),
                (bc_[0], bc_[1], (1, hs)), (*body.const(w, "W"), w.shape),
                (*body.const(r, "R"), r.shape),
                (*body.const(bias, "B"), bias.shape)],
        out_shapes=((1, hs), (1, hs)), name="cell")
    h3 = body.layer("Unsqueeze",
                    inputs=[(cell[0], cell[1], (1, hs)),
                            (*body.const(np.asarray([1], I64)), (1,))],
                    out_shapes=((1, 1, hs),), name="h3")
    r_hseq = body.result((h3[0], h3[1], (1, 1, hs)))
    r_h = body.result((cell[0], cell[1], (1, hs)))
    r_c = body.result((cell[0], cell[1] + 1, (1, hs)))
    body_xml = (f'<layers>{"".join(body.layers)}</layers>'
                f'<edges>{"".join(body.edges)}</edges>')
    b = IRBuilder("lstm_seq")
    b.blob = body.blob
    b._next_id = 100
    x = b.layer("Parameter", {"shape": f"1,{t},{d}", "element_type": "f32"},
                out_shapes=((1, t, d),), name="input")
    h0 = b.const(np.zeros((1, hs), np.float32), "h0")
    c0 = b.const(np.zeros((1, hs), np.float32), "c0")
    ti_id = b._next_id
    b._next_id += 1
    b.layers.append(
        f'<layer id="{ti_id}" name="ti" type="TensorIterator" version="opset1">'
        f'<input><port id="0"><dim>1</dim><dim>{t}</dim><dim>{d}</dim></port>'
        f'<port id="1"><dim>1</dim><dim>{hs}</dim></port>'
        f'<port id="2"><dim>1</dim><dim>{hs}</dim></port></input><output>'
        f'<port id="3"><dim>1</dim><dim>{t}</dim><dim>{hs}</dim></port>'
        f'<port id="4"><dim>1</dim><dim>{hs}</dim></port></output>'
        '<port_map>'
        f'<input external_port_id="0" internal_layer_id="{bx[0]}" '
        'axis="1" stride="1" start="0"/>'
        f'<input external_port_id="1" internal_layer_id="{bh[0]}"/>'
        f'<input external_port_id="2" internal_layer_id="{bc_[0]}"/>'
        f'<output external_port_id="3" internal_layer_id="{r_hseq[0]}" '
        'axis="1"/>'
        f'<output external_port_id="4" internal_layer_id="{r_h[0]}"/>'
        '</port_map><back_edges>'
        f'<edge from-layer="{r_h[0]}" to-layer="{bh[0]}"/>'
        f'<edge from-layer="{r_c[0]}" to-layer="{bc_[0]}"/>'
        f'</back_edges><body>{body_xml}</body></layer>')
    for to_port, (src_lid, src_port) in enumerate(
            [(x[0], x[1]), h0[:2], c0[:2]]):
        b.edges.append(f'<edge from-layer="{src_lid}" from-port="{src_port}" '
                       f'to-layer="{ti_id}" to-port="{to_port}"/>')
    for rid, port, shape in ((200, 3, (1, t, hs)), (201, 4, (1, hs))):
        dims = "".join(f"<dim>{v}</dim>" for v in shape)
        b.layers.append(f'<layer id="{rid}" name="res{rid}" type="Result" '
                        f'version="opset1"><input><port id="0">{dims}'
                        '</port></input></layer>')
        b.edges.append(f'<edge from-layer="{ti_id}" from-port="{port}" '
                       f'to-layer="{rid}" to-port="0"/>')
    return b.write(tmp)


def test_tensor_iterator_sequences(tmp_path):
    """The LSTM TensorIterator (both outputs) and the reference's
    reverse-slice identity body, against the reference at 1e-4."""
    xml = _ti_lstm_ir(tmp_path, t=5, d=3, hs=4)
    x = _RNG.normal(size=(2, 5, 3)).astype(np.float32)
    _assert_close(*_run_both(xml, x), 1e-4)
    (tmp_path / "rev").mkdir()
    xml = _identity_ti_ir(tmp_path / "rev", 4, 3,
                          {"axis": 1, "start": -1, "end": 0, "stride": -1})
    x = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    ref, got = _run_both(xml, x)
    _assert_close(ref, got, 0)
    np.testing.assert_array_equal(got["ti"], x[:, ::-1])


def test_tensor_iterator_guards(tmp_path):
    """part_size > 1 raises at load, a zero-trip range at the forward,
    and an explicit part_size=1 runs — as the reference's do."""
    xml = _identity_ti_ir(tmp_path, 4, 3, {"axis": 1, "part_size": 2})
    for load in (jir.load_ir, tir.load_ir):
        with pytest.raises(ValueError, match="part_size=2"):
            load(xml)
    (tmp_path / "zt").mkdir()
    xml = _identity_ti_ir(tmp_path / "zt", 4, 3,
                          {"axis": 1, "start": 2, "end": 2})
    jm, tm = jir.load_ir(xml), tir.load_ir(xml)
    x = np.zeros((1, 4, 3), np.float32)
    with pytest.raises(ValueError, match="zero-trip"):
        jm.forward(jm.params, x)
    with pytest.raises(ValueError, match="zero-trip"):
        tm(torch.from_numpy(x))
    (tmp_path / "ok").mkdir()
    xml = _identity_ti_ir(tmp_path / "ok", 4, 3, {"axis": 1, "part_size": 1})
    x = np.arange(12, dtype=np.float32).reshape(1, 4, 3)
    _assert_close(*_run_both(xml, x), 0)


def test_import_guards_raise_as_the_reference(tmp_path):
    """An unsupported layer type, Gather batch_dims, GRUCell
    linear_before_reset, a v2 RegionYolo and a pre-v10 IR raise
    ValueError in both importers."""
    x = X2
    cases = [
        ("NoSuchOp", {}, [], "not supported"),
        ("Gather", {"batch_dims": "1"},
         [np.asarray([0], I64), np.asarray(1, I64)], "batch_dims"),
    ]
    for i, (ltype, attrs, consts, match) in enumerate(cases):
        d = tmp_path / f"c{i}"
        d.mkdir()
        xml = _single(d, ltype, attrs, x, consts)
        for load in (jir.load_ir, tir.load_ir):
            with pytest.raises(ValueError, match=match):
                load(xml)
    d = tmp_path / "gru"
    d.mkdir()
    xml = _single(d, "GRUCell", {"linear_before_reset": "true"}, x,
                  [np.zeros((3, 2), np.float32), np.zeros((6, 7), np.float32),
                   np.zeros((6, 2), np.float32), np.zeros((6,), np.float32)])
    for load in (jir.load_ir, tir.load_ir):
        with pytest.raises(ValueError, match="linear_before_reset"):
            load(xml)
    d = tmp_path / "yolo2"
    d.mkdir()
    xml = _single(d, "RegionYolo", {"classes": "1", "coords": "4", "num": "1"},
                  _RNG.normal(size=(1, 6, 2, 2)).astype(np.float32))
    for load in (jir.load_ir, tir.load_ir):
        with pytest.raises(ValueError, match="do_softmax"):
            load(xml)
    old = tmp_path / "old.xml"
    old.write_text('<?xml version="1.0"?><net name="o" version="7">'
                   "<layers/><edges/></net>")
    for parse in (jir.parse_ir, tir.parse_ir):
        with pytest.raises(ValueError, match="version 7"):
            parse(old)


# ----------------------------------------------------------- fuzz


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_graph_matches_the_reference(tmp_path, seed):
    """The reference's random graphs (its seeds, with the Model
    Optimizer artifacts): the port within 1e-4 of the reference, and
    within the reference's own tolerance of the numpy evaluation."""
    rng = np.random.default_rng(1000 + seed)
    g = FuzzGraph(rng)
    xml = g.build(tmp_path, n_ops=int(rng.integers(3, 9)))
    moify(xml, rng)
    ref, got = _run_both(xml, g.input)
    _assert_close(ref, got, 1e-4)
    np.testing.assert_allclose(list(got.values())[0], g.ref,
                               rtol=2e-3, atol=2e-3)


# ------------------------------------------- layouts and depthwise


@pytest.mark.parametrize("seed", [3, 7])
def test_layouts_match_each_other_and_the_reference(tmp_path, seed):
    """``nhwc`` (channels_last) and ``nchw`` give the same outputs in
    the port, each within 1e-5 of the reference's own layout."""
    rng = np.random.default_rng(500 + seed)
    g = FuzzGraph(rng)
    xml = g.build(tmp_path, n_ops=6)
    outs = {}
    for layout in ("nhwc", "nchw"):
        ref, got = _run_both(xml, g.input, layout=layout)
        _assert_close(ref, got, 1e-5)
        outs[layout] = got
    _assert_close(outs["nchw"], outs["nhwc"], 1e-5)


def test_ir_layout_env_and_depthwise_variants(tmp_path, monkeypatch):
    """The crossroad-like SSD (input 64, width 8) under
    ``EVAM_IR_LAYOUT`` nhwc / nchw and ``EVAM_DWCONV`` lax / shift: all
    four within 1e-5 of each other, each within 1e-5 of the reference
    under the same environment. The shift path reaches the depthwise
    GroupConvolutions on the NCHW plan, as in the reference."""
    xml = build_crossroad_like_ir(tmp_path, input_size=64, width=8)[0]
    x = np.random.default_rng(2).normal(size=(2, 3, 64, 64)).astype(
        np.float32)
    outs = {}
    for layout in ("nhwc", "nchw"):
        for dw in ("lax", "shift"):
            monkeypatch.setenv("EVAM_IR_LAYOUT", layout)
            monkeypatch.setenv("EVAM_DWCONV", dw)
            tm = tir.load_ir(xml)
            assert tm.layout == layout
            ref, got = _run_both(xml, x)
            _assert_close(ref, got, 1e-5)
            outs[(layout, dw)] = got
    for key, got in outs.items():
        _assert_close(outs[("nhwc", "lax")], got, 1e-5)
    # the NHWC plan's conv weights are stored channels_last
    monkeypatch.setenv("EVAM_IR_LAYOUT", "nhwc")
    tm = tir.load_ir(xml)
    w = tm.params["head0_loc_w"]
    assert w.is_contiguous(memory_format=torch.channels_last)
    monkeypatch.setenv("EVAM_IR_LAYOUT", "nchw")
    tm = tir.load_ir(xml)
    assert tm.params["b1_pw_w"].is_contiguous()


def test_depthwise_shift_op_matches_the_reference():
    from evam_tpu.ops.depthwise import depthwise_shift_nchw as ref_shift
    from evam_tpu_torch.ops.depthwise import depthwise_shift_nchw

    x = _RNG.normal(size=(2, 4, 9, 7)).astype(np.float32)
    k = _RNG.normal(size=(4, 3, 3)).astype(np.float32)
    for strides, pads in (((1, 1), ((1, 1), (1, 1))),
                          ((2, 2), ((0, 1), (1, 1))),
                          ((2, 1), ((1, 0), (0, 2)))):
        want = np.asarray(ref_shift(jnp.asarray(x), jnp.asarray(k), strides,
                                    pads))
        got = depthwise_shift_nchw(torch.from_numpy(x), torch.from_numpy(k),
                                   strides, pads).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_zoo_depthwise_shift_matches_grouped_conv(monkeypatch):
    """The zoo SSD built under EVAM_DWCONV=shift (the shift-and-add
    DepthwiseConv) on the weights of one built under lax: outputs
    within 1e-5, and within 1e-5 of the reference's shift variant on the
    same weights."""
    import dataclasses

    import jax

    from evam_tpu.models import registry as jreg
    from evam_tpu_torch.models.convert import params_from_jax
    from evam_tpu_torch.models.registry import ModelRegistry
    from evam_tpu_torch.models.zoo.layers import DepthwiseConv

    key = "object_detection/person_vehicle_bike"
    small = dict(input_overrides={key: (32, 32)}, width_overrides={key: 4},
                 allow_random_weights=True, dtype="float32", precision="FP32")
    x = np.random.default_rng(0).uniform(0, 255, (2, 32, 32, 3)).astype(
        np.float32)
    # the reference's SSD at the same size, its params initialised under
    # lax (the same tree: its DepthwiseConv keeps nn.Conv's names and
    # shapes); the variant is read when its forward traces
    monkeypatch.setenv("EVAM_DWCONV", "lax")
    spec = dataclasses.replace(jreg.ZOO_SPECS[key], input_size=(32, 32),
                               width=4)
    module = jreg.build_module(spec)
    params = jax.jit(module.init)(jax.random.PRNGKey(0),
                                  jreg._example_input(spec))["params"]
    monkeypatch.setenv("EVAM_DWCONV", "shift")
    ref = jax.jit(lambda p, b: module.apply({"params": p}, b))(
        params, jnp.asarray(x))
    state = params_from_jax(jax.tree.map(np.asarray, params))
    outs = {}
    for dw in ("lax", "shift"):
        monkeypatch.setenv("EVAM_DWCONV", dw)
        tm = ModelRegistry(device="cpu", **small).get(key)
        assert any(isinstance(m, DepthwiseConv)
                   for m in tm.module.modules()) == (dw == "shift")
        tm.module.load_state_dict(state)
        with torch.inference_mode():
            outs[dw] = {k: v.numpy()
                        for k, v in tm.forward(torch.from_numpy(x)).items()}
    for k in ("loc", "conf"):
        np.testing.assert_allclose(outs["shift"][k], outs["lax"][k],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(outs["shift"][k], np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5)


# -------------------------------------------------------- bfloat16


def test_bfloat16_forward(tmp_path):
    """The crossroad-like SSD and the attributes classifier with every
    weight and the input in bfloat16: within 2e-2 of the reference."""
    for name, xml, shape in (
            ("ssd", build_crossroad_like_ir(tmp_path / "s", input_size=64,
                                            width=8)[0], (2, 3, 64, 64)),
            ("cls", build_attributes_like_ir(tmp_path / "c", input_size=24,
                                             width=4)[0], (2, 3, 24, 24))):
        jm, tm = jir.load_ir(xml), tir.load_ir(xml)
        tm.cast_params(torch.bfloat16)
        params = {k: jnp.asarray(v, jnp.bfloat16) for k, v in jm.params.items()}
        x = np.random.default_rng(4).uniform(0, 1, shape).astype(np.float32)
        ref = jm.forward(params, jnp.asarray(x, jnp.bfloat16))
        with torch.inference_mode():
            got = tm(torch.from_numpy(x).to(torch.bfloat16))
        for k in ref:
            assert got[k].dtype == torch.bfloat16, (name, k)
            np.testing.assert_allclose(got[k].float().numpy(),
                                       np.asarray(ref[k], np.float32),
                                       rtol=2e-2, atol=2e-2, err_msg=k)


def test_forward_is_device_neutral_after_deepcopy(tmp_path):
    """A deep copy (the hub's per-device model copy) runs on its own
    buffers: the copy's outputs equal the original's, and changing the
    copy's weights leaves the original alone."""
    import copy

    xml = build_attributes_like_ir(tmp_path, input_size=24, width=4)[0]
    tm = tir.load_ir(xml)
    tc = copy.deepcopy(tm)
    x = torch.from_numpy(_RNG.normal(size=(2, 3, 24, 24)).astype(np.float32))
    with torch.inference_mode():
        a, b = tm(x), tc(x)
    for k in a:
        assert torch.equal(a[k], b[k])
    tc.load_params({k: torch.zeros_like(v) for k, v in tc.params.items()})
    with torch.inference_mode():
        c, a2 = tc(x), tm(x)
    for k in a:
        assert torch.equal(a[k], a2[k])
        torch.testing.assert_close(c[k], torch.full_like(c[k], 1 / c[k].shape[1]))


def test_moified_xml_parses_like_the_reference(tmp_path):
    """mo artifacts (rt_info, meta_data, mixed opset tags, port
    precision) parse to the same graph."""
    xml = build_attributes_like_ir(tmp_path, input_size=24, width=4)[0]
    moify(xml, np.random.default_rng(0))
    assert ET.parse(xml).getroot().find("rt_info") is not None
    _graphs_equal(jir.parse_ir(xml), tir.parse_ir(xml))
