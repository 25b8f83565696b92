"""Programmatic OpenVINO IR composition (XML + .bin writer).

A copy of ``evam_tpu/models/ir_build.py`` (numpy only): given the same
seed and arguments it writes byte-equal ``model.xml`` and ``model.bin``.
The inverse of ``models/ir.py``: build a valid IR v11 pair layer by
layer. ``fetch-models --synthesize-omz`` uses it to materialize
OMZ-topology-shaped models (the crossroad-0078 MobileNet-SSD, the
vehicle-attributes classifier, the action encoder and decoder, AclNet)
so IR-backed serving runs without a download.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class IRBuilder:
    """Compose a minimal IR v11 xml + bin pair."""

    def __init__(self, name="testnet"):
        self.name = name
        self.layers: list[str] = []
        self.edges: list[str] = []
        self.blob = bytearray()
        self._next_id = 0

    def _shape_xml(self, port_id: int, shape) -> str:
        dims = "".join(f"<dim>{d}</dim>" for d in shape)
        return f'<port id="{port_id}">{dims}</port>'

    def layer(self, ltype, attrs=None, inputs=(), out_shapes=((),), name=None):
        """inputs: list of (layer_id, port_id, shape). Returns this
        layer's id; its output ports are numbered after the inputs."""
        lid = self._next_id
        self._next_id += 1
        name = name or f"{ltype.lower()}_{lid}"
        attr_xml = ""
        if attrs:
            kv = " ".join(f'{k}="{v}"' for k, v in attrs.items())
            attr_xml = f"<data {kv}/>"
        in_xml = ""
        if inputs:
            ports = "".join(
                self._shape_xml(i, shp) for i, (_, _, shp) in enumerate(inputs)
            )
            in_xml = f"<input>{ports}</input>"
        first_out = len(inputs)
        out_xml = "".join(
            self._shape_xml(first_out + i, s) for i, s in enumerate(out_shapes)
        )
        self.layers.append(
            f'<layer id="{lid}" name="{name}" type="{ltype}" version="opset1">'
            f"{attr_xml}{in_xml}<output>{out_xml}</output></layer>"
            if out_shapes
            else f'<layer id="{lid}" name="{name}" type="{ltype}" '
            f'version="opset1">{attr_xml}{in_xml}</layer>'
        )
        for to_port, (src_lid, src_port, _) in enumerate(inputs):
            self.edges.append(
                f'<edge from-layer="{src_lid}" from-port="{src_port}" '
                f'to-layer="{lid}" to-port="{to_port}"/>'
            )
        return lid, first_out

    def const(self, arr: np.ndarray, name=None):
        arr = np.ascontiguousarray(arr)
        et = {
            np.dtype(np.float32): "f32",
            np.dtype(np.int64): "i64",
            np.dtype(np.float16): "f16",
        }[arr.dtype]
        offset = len(self.blob)
        self.blob.extend(arr.tobytes())
        attrs = {
            "element_type": et,
            "shape": ",".join(str(d) for d in arr.shape),
            "offset": offset,
            "size": arr.nbytes,
        }
        return self.layer("Const", attrs, out_shapes=(arr.shape,), name=name)

    def result(self, src):
        return self.layer("Result", inputs=[src], out_shapes=())

    def write(self, tmpdir: Path, stem="model") -> Path:
        xml = (
            f'<?xml version="1.0"?><net name="{self.name}" version="11">'
            f'<layers>{"".join(self.layers)}</layers>'
            f'<edges>{"".join(self.edges)}</edges></net>'
        )
        xml_path = tmpdir / f"{stem}.xml"
        xml_path.write_text(xml)
        (tmpdir / f"{stem}.bin").write_bytes(bytes(self.blob))
        return xml_path



def conv_bias_relu(
    b: "IRBuilder",
    weights: dict,
    rng,
    cur,
    cur_shape: tuple,
    name: str,
    out_ch: int,
    kernel: int,
    stride: int,
    groups: int = 1,
):
    """Append Convolution/GroupConvolution + bias Add + ReLU (the OMZ
    conv block both generated topologies use) and register the weight
    tensors. Returns (layer_ref, out_shape)."""
    _, in_ch, h, w = cur_shape
    oh, ow = -(-h // stride), -(-w // stride)
    pad = max((oh - 1) * stride + kernel - h, 0)
    lo, hi = pad // 2, pad - pad // 2
    if groups == 1:
        wshape = (out_ch, in_ch, kernel, kernel)
        ltype = "Convolution"
    else:
        wshape = (groups, 1, 1, kernel, kernel)
        ltype = "GroupConvolution"
    warr = (rng.normal(size=wshape)
            * (1.5 / np.sqrt(in_ch * kernel * kernel))).astype(np.float32)
    weights[f"{name}_w"] = warr
    wc = b.const(warr, f"{name}_w")
    out_shape = (1, out_ch, oh, ow)
    cur = b.layer(
        ltype,
        {"strides": f"{stride},{stride}", "pads_begin": f"{lo},{lo}",
         "pads_end": f"{hi},{hi}", "dilations": "1,1"},
        inputs=[(cur[0], cur[1], cur_shape), (*wc, wshape)],
        out_shapes=(out_shape,), name=name,
    )
    barr = (rng.normal(size=(1, out_ch, 1, 1)) * 0.1).astype(np.float32)
    weights[f"{name}_b"] = barr
    bias = b.const(barr, f"{name}_b")
    cur = b.layer(
        "Add", inputs=[(cur[0], cur[1], out_shape),
                       (*bias, (1, out_ch, 1, 1))],
        out_shapes=(out_shape,), name=f"{name}_bias",
    )
    cur = b.layer("ReLU", inputs=[(cur[0], cur[1], out_shape)],
                  out_shapes=(out_shape,), name=f"{name}_relu")
    return cur, out_shape


def build_crossroad_like_ir(
    target: Path,
    input_size: int | tuple[int, int] = 512,
    width: int = 8,
    num_classes: int = 4,
    seed: int = 20260730,
):
    """Write model.xml/.bin; returns (xml_path, weights dict, meta).

    ``width`` is the first pointwise width (real 0078 uses 32); the
    depthwise ladder is the MobileNet-v1 stride pattern down to /16
    with SSD heads on the /8 and /16 features. ``input_size`` may be
    an int (square) or an (H, W) pair — person-detection-retail-0013
    is 320×544.
    """
    rng = np.random.default_rng(seed)
    b = IRBuilder("omz_like_ssd")
    weights: dict[str, np.ndarray] = {}

    def const(name, arr):
        weights[name] = arr
        return b.const(arr, name)

    ih, iw = ((input_size, input_size) if isinstance(input_size, int)
              else (int(input_size[0]), int(input_size[1])))
    x = b.layer(
        "Parameter", {"shape": f"1,3,{ih},{iw}", "element_type": "f32"},
        out_shapes=((1, 3, ih, iw),), name="data",
    )
    cur, cur_shape = x, (1, 3, ih, iw)

    def conv(name, out_ch, kernel, stride, groups=1):
        nonlocal cur, cur_shape
        cur, cur_shape = conv_bias_relu(
            b, weights, rng, cur, cur_shape, name, out_ch, kernel,
            stride, groups,
        )

    def dw_block(name, out_ch, stride):
        in_ch = cur_shape[1]
        conv(f"{name}_dw", in_ch, 3, stride, groups=in_ch)
        conv(f"{name}_pw", out_ch, 1, 1)

    # MobileNet-v1 ladder to /16 (trimmed 5x512 repeat to 2 for size)
    conv("conv0", width, 3, 2)              # /2
    dw_block("b1", width * 2, 1)
    dw_block("b2", width * 4, 2)            # /4
    dw_block("b3", width * 4, 1)
    dw_block("b4", width * 8, 2)            # /8
    feat8, feat8_shape = None, None
    dw_block("b5", width * 8, 1)
    feat8, feat8_shape = cur, cur_shape
    dw_block("b6", width * 16, 2)           # /16
    dw_block("b7", width * 16, 1)
    feat16, feat16_shape = cur, cur_shape

    # --- SSD heads over the two scales ---
    anchors_per = 2
    loc_flats, conf_flats, prior_layers = [], [], []
    img_shape_c = b.const(np.asarray([ih, iw], np.int64), "img_shape")

    for idx, (feat, fshape) in enumerate(
        [(feat8, feat8_shape), (feat16, feat16_shape)]
    ):
        _, in_ch, fh, fw = fshape
        na = anchors_per

        def head(kind, out_ch, last_dims):
            wc = const(f"head{idx}_{kind}_w",
                       (rng.normal(size=(out_ch, in_ch, 1, 1))
                        * (1.0 / np.sqrt(in_ch))).astype(np.float32))
            hshape = (1, out_ch, fh, fw)
            h = b.layer(
                "Convolution",
                {"strides": "1,1", "pads_begin": "0,0", "pads_end": "0,0",
                 "dilations": "1,1"},
                inputs=[(feat[0], feat[1], fshape), (*wc, (out_ch, in_ch, 1, 1))],
                out_shapes=(hshape,), name=f"head{idx}_{kind}",
            )
            perm = b.const(np.asarray([0, 2, 3, 1], np.int64),
                           f"head{idx}_{kind}_perm")
            tshape = (1, fh, fw, out_ch)
            h = b.layer("Transpose",
                        inputs=[(h[0], h[1], hshape), (*perm, (4,))],
                        out_shapes=(tshape,), name=f"head{idx}_{kind}_t")
            tgt = b.const(np.asarray(last_dims, np.int64),
                          f"head{idx}_{kind}_tgt")
            fshape_out = tuple(last_dims)
            h = b.layer("Reshape", {"special_zero": "false"},
                        inputs=[(h[0], h[1], tshape),
                                (*tgt, (len(last_dims),))],
                        out_shapes=(fshape_out,),
                        name=f"head{idx}_{kind}_flat")
            return h, fshape_out

        n_cells = fshape[2] * fshape[3]
        loc, loc_shape = head("loc", na * 4, [1, n_cells * na * 4])
        loc_flats.append((loc, loc_shape))
        conf, conf_shape = head(
            "conf", na * num_classes, [1, n_cells * na, num_classes])
        sm = b.layer("SoftMax", {"axis": "2"},
                     inputs=[(conf[0], conf[1], conf_shape)],
                     out_shapes=(conf_shape,), name=f"head{idx}_conf_sm")
        tgt2 = b.const(np.asarray([1, n_cells * na * num_classes], np.int64),
                       f"head{idx}_conf_ftgt")
        conf_f = b.layer(
            "Reshape", {"special_zero": "false"},
            inputs=[(sm[0], sm[1], conf_shape),
                    (*tgt2, (2,))],
            out_shapes=((1, n_cells * na * num_classes),),
            name=f"head{idx}_conf_flat",
        )
        conf_flats.append((conf_f, (1, n_cells * na * num_classes)))

        fs_c = b.const(np.asarray([fshape[2], fshape[3]], np.int64),
                       f"feat_shape{idx}")
        # the same stride ladder divides both dims, so H and W share
        # one step even for rectangular inputs
        step = ih // fshape[2]
        pri = b.layer(
            "PriorBoxClustered",
            {"width": f"{8.0 * (idx + 1)},{16.0 * (idx + 1)}",
             "height": f"{16.0 * (idx + 1)},{8.0 * (idx + 1)}",
             "clip": "false", "step": f"{step}.0", "offset": "0.5",
             "variance": "0.1,0.1,0.2,0.2"},
            inputs=[(*fs_c, (2,)), (img_shape_c[0], img_shape_c[1], (2,))],
            out_shapes=((1, 2, n_cells * na * 4),), name=f"priors{idx}",
        )
        prior_layers.append((pri, (1, 2, n_cells * na * 4)))

    total_loc = sum(shp[1] for _, shp in loc_flats)
    total_conf = sum(shp[1] for _, shp in conf_flats)
    loc_cat = b.layer(
        "Concat", {"axis": "1"},
        inputs=[(l[0], l[1], shp) for l, shp in loc_flats],
        out_shapes=((1, total_loc),), name="loc_concat",
    )
    conf_cat = b.layer(
        "Concat", {"axis": "1"},
        inputs=[(c[0], c[1], shp) for c, shp in conf_flats],
        out_shapes=((1, total_conf),), name="conf_concat",
    )
    prior_cat = b.layer(
        "Concat", {"axis": "2"},
        inputs=[(p[0], p[1], shp) for p, shp in prior_layers],
        out_shapes=((1, 2, total_loc),), name="prior_concat",
    )
    n_anchors = total_loc // 4
    det = b.layer(
        "DetectionOutput",
        {"num_classes": str(num_classes), "background_label_id": "0",
         "top_k": "200", "keep_top_k": "200",
         "code_type": "caffe.PriorBoxParameter.CENTER_SIZE",
         "share_location": "true", "nms_threshold": "0.45",
         "confidence_threshold": "0.01",
         "variance_encoded_in_target": "false", "normalized": "true"},
        inputs=[(loc_cat[0], loc_cat[1], (1, total_loc)),
                (conf_cat[0], conf_cat[1], (1, total_conf)),
                (prior_cat[0], prior_cat[1], (1, 2, total_loc))],
        out_shapes=((1, 1, 200, 7),), name="detection_out",
    )
    b.result((det[0], det[1], (1, 1, 200, 7)))

    target.mkdir(parents=True, exist_ok=True)
    xml = b.write(target)
    meta = {"num_classes": num_classes, "anchors": n_anchors,
            "input_size": input_size, "width": width}
    return xml, weights, meta


def build_attributes_like_ir(
    target: Path,
    input_size: int = 72,
    width: int = 16,
    heads: tuple = (("color", 7), ("type", 4)),
    seed: int = 20260731,
):
    """Write a vehicle-attributes-shaped multi-head classifier IR.

    The OMZ topology shape the reference's gvaclassify serves
    (vehicle-attributes-recognition-barrier-0039: small conv ladder,
    per-head 1x1 conv + global pool + SoftMax). Head layer names equal
    the head names so zoo head-label metadata binds when installed
    under the matching alias. Returns (xml_path, weights, meta).
    """
    rng = np.random.default_rng(seed)
    b = IRBuilder("attributes_like")
    weights: dict[str, np.ndarray] = {}

    def const(name, arr):
        weights[name] = arr
        return b.const(arr, name)

    s = input_size
    x = b.layer("Parameter", {"shape": f"1,3,{s},{s}", "element_type": "f32"},
                out_shapes=((1, 3, s, s),), name="data")
    cur, cur_shape = x, (1, 3, s, s)

    def conv(name, out_ch, kernel, stride):
        nonlocal cur, cur_shape
        cur, cur_shape = conv_bias_relu(
            b, weights, rng, cur, cur_shape, name, out_ch, kernel, stride,
        )

    conv("c1", width, 3, 2)
    conv("c2", width * 2, 3, 2)
    conv("c3", width * 4, 3, 2)
    trunk, trunk_shape = cur, cur_shape
    _, tc, th, tw_ = trunk_shape

    for hname, classes in heads:
        wshape = (classes, tc, 1, 1)
        wc = const(f"{hname}_w", (rng.normal(size=wshape)
                                  * (1.0 / np.sqrt(tc))).astype(np.float32))
        hshape = (1, classes, th, tw_)
        h = b.layer(
            "Convolution",
            {"strides": "1,1", "pads_begin": "0,0", "pads_end": "0,0",
             "dilations": "1,1"},
            inputs=[(trunk[0], trunk[1], trunk_shape), (*wc, wshape)],
            out_shapes=(hshape,), name=f"{hname}_conv",
        )
        pool = b.layer(
            "AvgPool",
            {"kernel": f"{th},{tw_}", "strides": "1,1", "pads_begin": "0,0",
             "pads_end": "0,0", "exclude-pad": "true"},
            inputs=[(h[0], h[1], hshape)],
            out_shapes=((1, classes, 1, 1),), name=f"{hname}_pool",
        )
        tgt = b.const(np.asarray([1, classes], np.int64), f"{hname}_tgt")
        flat = b.layer("Reshape", {"special_zero": "false"},
                       inputs=[(pool[0], pool[1], (1, classes, 1, 1)),
                               (*tgt, (2,))],
                       out_shapes=((1, classes),), name=f"{hname}_flat")
        sm = b.layer("SoftMax", {"axis": "1"},
                     inputs=[(flat[0], flat[1], (1, classes))],
                     out_shapes=((1, classes),), name=hname)
        b.result((sm[0], sm[1], (1, classes)))

    target.mkdir(parents=True, exist_ok=True)
    xml = b.write(target)
    return xml, weights, {"heads": tuple(heads), "input_size": input_size,
                          "width": width}


def build_action_encoder_like_ir(
    target: Path,
    input_size: int = 224,
    width: int = 16,
    embed_dim: int = 512,
    seed: int = 20260732,
):
    """Write an action-recognition-0001-encoder-shaped IR: conv ladder
    → global average pool → FC to a [1, D] embedding (no softmax —
    the registry serves it through build_action_encode_step, which
    consumes the raw embedding array). Returns (xml, weights, meta)."""
    rng = np.random.default_rng(seed)
    b = IRBuilder("action_encoder_like")
    weights: dict[str, np.ndarray] = {}
    s = input_size
    x = b.layer("Parameter",
                {"shape": f"1,3,{s},{s}", "element_type": "f32"},
                out_shapes=((1, 3, s, s),), name="data")
    cur, cur_shape = x, (1, 3, s, s)
    for i, (ch, stride) in enumerate(
            [(width, 2), (width * 2, 2), (width * 4, 2), (width * 8, 2)]):
        cur, cur_shape = conv_bias_relu(
            b, weights, rng, cur, cur_shape, f"enc{i}", ch, 3, stride)
    _, c, h, w = cur_shape
    pool = b.layer(
        "AvgPool",
        {"kernel": f"{h},{w}", "strides": "1,1", "pads_begin": "0,0",
         "pads_end": "0,0", "exclude-pad": "true"},
        inputs=[(cur[0], cur[1], cur_shape)],
        out_shapes=((1, c, 1, 1),), name="gap",
    )
    tgt = b.const(np.asarray([1, c], np.int64), "flat_tgt")
    flat = b.layer("Reshape", {"special_zero": "false"},
                   inputs=[(pool[0], pool[1], (1, c, 1, 1)), (*tgt, (2,))],
                   out_shapes=((1, c),), name="flat")
    fc = (rng.normal(size=(c, embed_dim)) / np.sqrt(c)).astype(np.float32)
    weights["embed_w"] = fc
    fcc = b.const(fc, "embed_w")
    emb = b.layer("MatMul",
                  {"transpose_a": "false", "transpose_b": "false"},
                  inputs=[(flat[0], flat[1], (1, c)), (*fcc, fc.shape)],
                  out_shapes=((1, embed_dim),), name="embedding")
    b.result((emb[0], emb[1], (1, embed_dim)))
    target.mkdir(parents=True, exist_ok=True)
    xml = b.write(target)
    return xml, weights, {"embed_dim": embed_dim, "input_size": s}


def build_action_decoder_like_ir(
    target: Path,
    clip_len: int = 16,
    embed_dim: int = 512,
    hidden: int = 64,
    num_classes: int = 400,
    seed: int = 20260733,
    softmax_tail: bool = False,
):
    """Write an action-recognition-0001-decoder-shaped IR: clips
    [1, T, D] → TensorIterator(LSTMCell over T, hidden/cell
    back-edges) → last hidden → FC logits (the mo export shape;
    ``softmax_tail=True`` appends an in-graph SoftMax, which the
    importer's out_is_prob detection must honor). The recurrent
    topology the reference's composite action model downloads
    (models_list/action-recognition-0001.json). Returns (xml,
    weights, meta)."""
    rng = np.random.default_rng(seed)
    t, d, hs = clip_len, embed_dim, hidden
    w = (rng.normal(size=(4 * hs, d)) * 0.1).astype(np.float32)
    r = (rng.normal(size=(4 * hs, hs)) * 0.1).astype(np.float32)
    bias = np.zeros((4 * hs,), np.float32)
    fc = (rng.normal(size=(hs, num_classes)) * 0.1).astype(np.float32)

    body = IRBuilder("dbody")
    bx = body.layer("Parameter",
                    {"shape": f"1,1,{d}", "element_type": "f32"},
                    out_shapes=((1, 1, d),), name="xt")
    bh = body.layer("Parameter",
                    {"shape": f"1,{hs}", "element_type": "f32"},
                    out_shapes=((1, hs),), name="h_in")
    bc_ = body.layer("Parameter",
                     {"shape": f"1,{hs}", "element_type": "f32"},
                     out_shapes=((1, hs),), name="c_in")
    axes = body.const(np.asarray([1], np.int64), "sq_axes")
    sq = body.layer("Squeeze",
                    inputs=[(bx[0], bx[1], (1, 1, d)), (*axes, (1,))],
                    out_shapes=((1, d),), name="squeeze")
    wc = body.const(w, "W")
    rc = body.const(r, "R")
    bbc = body.const(bias, "B")
    cell = body.layer(
        "LSTMCell", {"hidden_size": str(hs)},
        inputs=[(sq[0], sq[1], (1, d)), (bh[0], bh[1], (1, hs)),
                (bc_[0], bc_[1], (1, hs)), (*wc, w.shape),
                (*rc, r.shape), (*bbc, bias.shape)],
        out_shapes=((1, hs), (1, hs)), name="cell",
    )
    r_h = body.result((cell[0], cell[1], (1, hs)))
    r_c = body.result((cell[0], cell[1] + 1, (1, hs)))
    body_xml = (f'<layers>{"".join(body.layers)}</layers>'
                f'<edges>{"".join(body.edges)}</edges>')

    b = IRBuilder("action_decoder_like")
    b.blob = body.blob
    b._next_id = 100
    x = b.layer("Parameter",
                {"shape": f"1,{t},{d}", "element_type": "f32"},
                out_shapes=((1, t, d),), name="input")
    h0 = b.const(np.zeros((1, hs), np.float32), "h0")
    c0 = b.const(np.zeros((1, hs), np.float32), "c0")
    ti_id = b._next_id
    b._next_id += 1
    b.layers.append(
        f'<layer id="{ti_id}" name="ti" type="TensorIterator" '
        'version="opset1">'
        '<input>'
        f'<port id="0"><dim>1</dim><dim>{t}</dim><dim>{d}</dim></port>'
        f'<port id="1"><dim>1</dim><dim>{hs}</dim></port>'
        f'<port id="2"><dim>1</dim><dim>{hs}</dim></port>'
        '</input><output>'
        f'<port id="3"><dim>1</dim><dim>{hs}</dim></port>'
        '</output>'
        '<port_map>'
        f'<input external_port_id="0" internal_layer_id="{bx[0]}" '
        'axis="1" stride="1" start="0"/>'
        f'<input external_port_id="1" internal_layer_id="{bh[0]}"/>'
        f'<input external_port_id="2" internal_layer_id="{bc_[0]}"/>'
        f'<output external_port_id="3" internal_layer_id="{r_h[0]}"/>'
        '</port_map>'
        '<back_edges>'
        f'<edge from-layer="{r_h[0]}" to-layer="{bh[0]}"/>'
        f'<edge from-layer="{r_c[0]}" to-layer="{bc_[0]}"/>'
        '</back_edges>'
        f'<body>{body_xml}</body>'
        '</layer>'
    )
    for to_port, (src_lid, src_port) in enumerate(
            [(x[0], x[1]), h0[:2], c0[:2]]):
        b.edges.append(
            f'<edge from-layer="{src_lid}" from-port="{src_port}" '
            f'to-layer="{ti_id}" to-port="{to_port}"/>'
        )
    fc_c = b.const(fc, "fc_w")
    mm = b.layer("MatMul",
                 {"transpose_a": "false", "transpose_b": "false"},
                 inputs=[(ti_id, 3, (1, hs)), (*fc_c, fc.shape)],
                 out_shapes=((1, num_classes),), name="logits")
    tail = mm
    if softmax_tail:
        tail = b.layer("SoftMax", {"axis": "1"},
                       inputs=[(mm[0], mm[1], (1, num_classes))],
                       out_shapes=((1, num_classes),), name="probs")
    b.result((tail[0], tail[1], (1, num_classes)))
    target.mkdir(parents=True, exist_ok=True)
    xml = b.write(target)
    weights = {"W": w, "R": r, "B": bias, "fc_w": fc}
    return xml, weights, {"clip_len": t, "hidden": hs,
                          "num_classes": num_classes}


def build_aclnet_like_ir(
    target: Path,
    window: int = 16000,
    width: int = 16,
    num_classes: int = 53,
    seed: int = 20260734,
):
    """Write an aclnet-shaped audio classifier IR: raw waveform
    [1, 1, 1, S] → strided 1-D convs (as Nx1-free (1,k) 2-D convs,
    the OMZ aclnet lowering) → global pool → FC → SoftMax.
    Returns (xml, weights, meta)."""
    rng = np.random.default_rng(seed)
    b = IRBuilder("aclnet_like")
    weights: dict[str, np.ndarray] = {}
    s = window
    x = b.layer("Parameter",
                {"shape": f"1,1,1,{s}", "element_type": "f32"},
                out_shapes=((1, 1, 1, s),), name="data")
    cur, cur_shape = x, (1, 1, 1, s)
    for i, (ch, k, stride) in enumerate(
            [(width, 9, 4), (width * 2, 9, 4), (width * 4, 9, 4)]):
        _, in_ch, _, cw = cur_shape
        ow = -(-cw // stride)
        pad = max((ow - 1) * stride + k - cw, 0)
        lo, hi = pad // 2, pad - pad // 2
        wshape = (ch, in_ch, 1, k)
        warr = (rng.normal(size=wshape)
                * (1.5 / np.sqrt(in_ch * k))).astype(np.float32)
        weights[f"a{i}_w"] = warr
        wc = b.const(warr, f"a{i}_w")
        out_shape = (1, ch, 1, ow)
        cur = b.layer(
            "Convolution",
            {"strides": f"1,{stride}", "pads_begin": f"0,{lo}",
             "pads_end": f"0,{hi}", "dilations": "1,1"},
            inputs=[(cur[0], cur[1], cur_shape), (*wc, wshape)],
            out_shapes=(out_shape,), name=f"a{i}",
        )
        cur = b.layer("ReLU", inputs=[(cur[0], cur[1], out_shape)],
                      out_shapes=(out_shape,), name=f"a{i}_relu")
        cur_shape = out_shape
    _, c, _, cw = cur_shape
    mean_axes = b.const(np.asarray([2, 3], np.int64), "gap_axes")
    gap = b.layer("ReduceMean", {"keep_dims": "false"},
                  inputs=[(cur[0], cur[1], cur_shape),
                          (*mean_axes, (2,))],
                  out_shapes=((1, c),), name="gap")
    fc = (rng.normal(size=(c, num_classes)) / np.sqrt(c)).astype(np.float32)
    weights["fc_w"] = fc
    fcc = b.const(fc, "fc_w")
    mm = b.layer("MatMul",
                 {"transpose_a": "false", "transpose_b": "false"},
                 inputs=[(gap[0], gap[1], (1, c)), (*fcc, fc.shape)],
                 out_shapes=((1, num_classes),), name="logits")
    sm = b.layer("SoftMax", {"axis": "1"},
                 inputs=[(mm[0], mm[1], (1, num_classes))],
                 out_shapes=((1, num_classes),), name="probs")
    b.result((sm[0], sm[1], (1, num_classes)))
    target.mkdir(parents=True, exist_ok=True)
    xml = b.write(target)
    return xml, weights, {"window": window, "num_classes": num_classes}
