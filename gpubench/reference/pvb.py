"""Plain float32 reference of the person-vehicle-bike engines.

The detect engine: I420 wire → BGR at the detector's input (each plane
resized by the antialiased triangle filter at half-pixel centres, then
the studio-swing BT.601 inverse) → the MobileNet-style SSD (SAME-padded
convolutions, relu6, depthwise separable blocks, two extra levels, one
loc and one conf head per level) → SSD centre-offset decode against the
multi-scale anchors → softmax → class-aware greedy NMS over the top-k
anchors by best foreground score → packed rows
``[x0, y0, x1, y1, score, label, valid]``.

The fused engine adds: the first ``roi_budget`` rows that are valid and
of an allowed label (NMS order) are cropped from the wire planes by a
nearest-sample grid at the classifier's input size, run through the
attribute classifier (stem, three depthwise separable blocks, global
mean, one dense head per attribute), and each head's softmax is written
after the row's seven fields (zero where the row was not classified).

Parameters are a flat dict of float tensors named as the serving
package's ``state_dict`` names them (OIHW convolutions, ``[out, in]``
dense weights). ``quant`` (the control) simulates integer arithmetic a
precision below the configuration's on every layer: 4 bits on the
layers it quantizes to int8, 8 bits on those it serves in bfloat16. A
1×1 stride-1 convolution scales its activations per pixel row, every
other layer per example; weights per output channel, codes
``round(x / scale)`` clipped to ±(2^(bits-1) − 1), products exact in
float64.

Nothing here imports the serving package. Every operation runs in
float32 (float64 where stated); the caller turns TF32 off.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference.synth import wire_bytes


@dataclass(frozen=True)
class Quant:
    """Integer simulation (None: float32): ``bits`` on the layers the
    configuration quantizes (int8 there), ``float_bits`` on the layers
    it serves in bfloat16 — a precision below each, for the control."""

    bits: int
    float_bits: int = 8

    def qmax(self, quantized: bool) -> int:
        return (1 << ((self.bits if quantized else self.float_bits) - 1)) - 1


# ----------------------------------------------------------- parameters

def _conv_shape(cin, cout, k, groups=1):
    return (cout, cin // groups, k, k)


def ssd_layers(width: int, extra_levels: int, num_classes: int,
               num_anchors: int) -> list[dict]:
    """The SSD's convolutions in order: name prefix, shape, stride,
    groups, whether quantized. Heads are listed after the backbone."""
    w = width
    out = [dict(name="Backbone_0.ConvBlock_0.Conv_0",
                shape=_conv_shape(3, w, 3), stride=2, groups=1, quant=True)]
    plan = [(w, w * 2, 2), (w * 2, w * 2, 1), (w * 2, w * 4, 2),
            (w * 4, w * 4, 1), (w * 4, w * 8, 2), (w * 8, w * 8, 1),
            (w * 8, w * 16, 2), (w * 16, w * 16, 1)]
    for i, (cin, cout, s) in enumerate(plan):
        p = f"Backbone_0.SeparableConv_{i}"
        out.append(dict(name=f"{p}.Conv_0", shape=_conv_shape(cin, cin, 3, cin),
                        stride=s, groups=cin, quant=False))
        out.append(dict(name=f"{p}.Conv_1", shape=_conv_shape(cin, cout, 1),
                        stride=1, groups=1, quant=True))
    for lvl in range(extra_levels):
        out.append(dict(name=f"Backbone_0.ConvBlock_{1 + 2 * lvl}.Conv_0",
                        shape=_conv_shape(w * 16, w * 8, 1), stride=1,
                        groups=1, quant=True))
        out.append(dict(name=f"Backbone_0.ConvBlock_{2 + 2 * lvl}.Conv_0",
                        shape=_conv_shape(w * 8, w * 16, 3), stride=2,
                        groups=1, quant=True))
    chans = [w * 4, w * 8, w * 16] + [w * 16] * extra_levels
    for i, ch in enumerate(chans):
        out.append(dict(name=f"SSDHead_{i}.Conv_0",
                        shape=_conv_shape(ch, num_anchors * 4, 3), stride=1,
                        groups=1, quant=False))
        out.append(dict(name=f"SSDHead_{i}.Conv_1",
                        shape=_conv_shape(ch, num_anchors * num_classes, 3),
                        stride=1, groups=1, quant=False))
    return out


def classifier_layers(width: int, heads) -> list[dict]:
    """The attribute classifier's layers in order (dense heads last)."""
    w = width
    out = [dict(name="ConvBlock_0.Conv_0", shape=_conv_shape(3, w, 3),
                stride=2, groups=1, quant=True)]
    for i, (cin, cout) in enumerate([(w, w * 2), (w * 2, w * 4),
                                     (w * 4, w * 8)]):
        out.append(dict(name=f"SeparableConv_{i}.Conv_0",
                        shape=_conv_shape(cin, cin, 3, cin), stride=2,
                        groups=cin, quant=False))
        out.append(dict(name=f"SeparableConv_{i}.Conv_1",
                        shape=_conv_shape(cin, cout, 1), stride=1, groups=1,
                        quant=True))
    for i, (_, n) in enumerate(heads):
        out.append(dict(name=f"Dense_{i}", shape=(n, w * 8), stride=1,
                        groups=1, quant=False))
    return out


def param_shapes(layers: list[dict]) -> list[tuple[str, tuple[int, ...], int]]:
    """(state_dict key, shape, fan-in) of every weight and bias."""
    out = []
    for layer in layers:
        shape = tuple(layer["shape"])
        fan_in = math.prod(shape[1:])
        out.append((layer["name"] + ".weight", shape, fan_in))
        out.append((layer["name"] + ".bias", (shape[0],), fan_in))
    return out


def detector_layers(det: dict) -> list[dict]:
    return ssd_layers(det["width"], det["extra_levels"], det["num_classes"],
                      len(det["aspect_ratios"]) + 1)


# ------------------------------------------------------------ arithmetic

def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    lh, hh = _same_pads(x.shape[2], k, s)
    lw, hw = _same_pads(x.shape[3], k, s)
    return F.pad(x, (lw, hw, lh, hh))


def _codes(x: torch.Tensor, scale: torch.Tensor, qmax: int) -> torch.Tensor:
    return torch.clamp(torch.round(x.double() / scale.double()), -qmax, qmax)


def _scale(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    return torch.clamp((amax.double() / qmax).float(), min=1e-8)


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
         groups: int, q: int | None) -> torch.Tensor:
    """SAME convolution of NCHW float32 ``x``; integer-simulated with
    codes in ±``q`` when ``q`` is given."""
    k = w.shape[2]
    if q is None:
        return F.conv2d(_pad_same(x, k, stride), w, b, stride, groups=groups)
    w_scale = _scale(w.abs().amax(dim=(1, 2, 3)), q)
    wq = _codes(w, w_scale[:, None, None, None], q)
    if k == 1 and stride == 1 and groups == 1:
        bsz, c, h, wd = x.shape
        rows = x.permute(0, 2, 3, 1).reshape(-1, c)
        x_scale = _scale(rows.abs().amax(dim=1), q)
        xq = _codes(rows, x_scale[:, None], q)
        acc = xq @ wq.reshape(w.shape[0], c).T
        y = acc.float() * x_scale[:, None] * w_scale[None, :] + b
        return y.reshape(bsz, h, wd, -1).permute(0, 3, 1, 2)
    x_scale = _scale(x.abs().amax(dim=(1, 2, 3)), q)
    xq = _codes(x, x_scale[:, None, None, None], q)
    acc = F.conv2d(_pad_same(xq, k, stride), wq, None, stride, groups=groups)
    y = acc.float() * (x_scale[:, None, None, None]
                       * w_scale[None, :, None, None])
    return y + b[None, :, None, None]


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def _apply(params: dict, layer: dict, x: torch.Tensor,
           quant: Quant | None) -> torch.Tensor:
    return conv(x, params[layer["name"] + ".weight"],
                params[layer["name"] + ".bias"], layer["stride"],
                layer["groups"],
                None if quant is None else quant.qmax(layer["quant"]))


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          quant: Quant | None) -> torch.Tensor:
    """x [N, in] @ w [out, in]ᵀ + b; integer-simulated (a float layer's
    precision) when ``quant`` is given."""
    if quant is None:
        return x @ w.T + b
    return conv(x[:, :, None, None], w[:, :, None, None], b, 1, 1,
                quant.qmax(False))[:, :, 0, 0]


def ssd_forward(params: dict, det: dict, x_nhwc: torch.Tensor,
                quant: Quant | None) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, 3] BGR (0..255) → (loc [B, A, 4], conf logits [B, A, C])."""
    layers = {l["name"]: l for l in detector_layers(det)}
    run = lambda name, t: _apply(params, layers[name], t, quant)  # noqa: E731
    x = relu6(run("Backbone_0.ConvBlock_0.Conv_0", x_nhwc.permute(0, 3, 1, 2)))
    feats = []
    for i in range(8):
        p = f"Backbone_0.SeparableConv_{i}"
        x = relu6(run(f"{p}.Conv_1", relu6(run(f"{p}.Conv_0", x))))
        if i in (3, 5, 7):
            feats.append(x)
    for lvl in range(det["extra_levels"]):
        y = relu6(run(f"Backbone_0.ConvBlock_{1 + 2 * lvl}.Conv_0", feats[-1]))
        feats.append(relu6(run(f"Backbone_0.ConvBlock_{2 + 2 * lvl}.Conv_0",
                               y)))
    locs, confs = [], []
    b = x_nhwc.shape[0]
    for i, f in enumerate(feats):
        locs.append(run(f"SSDHead_{i}.Conv_0", f).permute(0, 2, 3, 1)
                    .reshape(b, -1, 4))
        confs.append(run(f"SSDHead_{i}.Conv_1", f).permute(0, 2, 3, 1)
                     .reshape(b, -1, det["num_classes"]))
    return torch.cat(locs, 1), torch.cat(confs, 1)


def classifier_forward(params: dict, cls: dict, x_nhwc: torch.Tensor,
                       quant: Quant | None) -> torch.Tensor:
    """[N, h, w, 3] BGR crops → concatenated per-head softmax [N, Σ n]."""
    layers = {l["name"]: l for l in classifier_layers(cls["width"],
                                                       cls["heads"])}
    run = lambda name, t: _apply(params, layers[name], t, quant)  # noqa: E731
    x = relu6(run("ConvBlock_0.Conv_0", x_nhwc.permute(0, 3, 1, 2)))
    for i in range(3):
        x = relu6(run(f"SeparableConv_{i}.Conv_1",
                      relu6(run(f"SeparableConv_{i}.Conv_0", x))))
    pooled = x.mean(dim=(2, 3))
    probs = [torch.softmax(dense(pooled, params[f"Dense_{i}.weight"],
                                 params[f"Dense_{i}.bias"], quant), dim=-1)
             for i in range(len(cls["heads"]))]
    return torch.cat(probs, dim=-1)


# --------------------------------------------------------- wire → input

def resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] linear-resize weights: a triangle at half-pixel
    centres, widened by 1/scale when shrinking, rows summing to 1."""
    scale = n_out / n_in
    ks = min(scale, 1.0)
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    wt = np.clip(1.0 - np.abs((pos[:, None] - np.arange(n_in)[None, :]) * ks),
                 0.0, 1.0)
    wt = wt / np.where(wt.sum(1, keepdims=True) == 0, 1.0,
                       wt.sum(1, keepdims=True))
    return torch.tensor(wt, dtype=torch.float32, device=device)


def planes(wire: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """uint8 [B, H*3/2, W] → float32 Y [B, H, W], U and V [B, H/2, W/2]."""
    b, h32, w = wire.shape
    h = h32 * 2 // 3
    q = h // 4
    y = wire[:, :h].float()
    u = wire[:, h:h + q].reshape(b, h // 2, w // 2).float()
    v = wire[:, h + q:].reshape(b, h // 2, w // 2).float()
    return y, u, v


def bt601(y, u, v) -> torch.Tensor:
    """Studio-swing BT.601 inverse → BGR [..., 3] in 0..255."""
    yy = 1.164 * (y - 16.0)
    uu, vv = u - 128.0, v - 128.0
    r = yy + 1.596 * vv
    g = yy - 0.813 * vv - 0.391 * uu
    bl = yy + 2.018 * uu
    return torch.clamp(torch.stack([bl, g, r], dim=-1), 0.0, 255.0)


def model_input(wire: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """I420 wire → BGR [B, h, w, 3] at the model's input size."""
    out = []
    for p in planes(wire):
        my = resize_matrix(p.shape[1], hw[0], p.device)
        mx = resize_matrix(p.shape[2], hw[1], p.device)
        out.append(my @ p @ mx.T)
    return bt601(*out)


def crop_i420(wire: torch.Tensor, boxes: torch.Tensor,
              out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-sample crops [B, R, oh, ow, 3] BGR of normalized corner
    boxes [B, R, 4]. A grid position is the serving contract's float32
    arithmetic: ``a = (y1 − y0)·(h − 1)`` and ``c = y0·(h − 1)`` each
    rounded to float32, ``t_i = i · fl(1 / (n − 1))`` (the last one
    exactly 1), then ``a·t_i + c`` rounded once (a fused multiply-add:
    the float64 product is exact, and its sum rounds to float32 as one
    rounding would, but for a sum that falls exactly on a float32
    midpoint), rounded half to even and clipped. Chroma is sampled at
    half the position."""
    y, u, v = planes(wire)
    h, w = y.shape[1:]
    bx = boxes.float()

    def grid(n, lo, hi, size):
        step = float(np.float32(1.0) / np.float32(n - 1)) if n > 1 else 0.0
        t = torch.arange(n, dtype=torch.float32, device=boxes.device) * step
        if n > 1:
            t[-1] = 1.0
        a = ((hi - lo) * (size - 1)).double()
        c = (lo * (size - 1)).double()
        pos = (a[..., None] * t.double() + c[..., None]).float()
        return torch.clamp(torch.round(pos), 0, size - 1).long()

    yi = grid(out_hw[0], bx[..., 1], bx[..., 3], h)
    xi = grid(out_hw[1], bx[..., 0], bx[..., 2], w)
    bidx = torch.arange(wire.shape[0], device=wire.device)[:, None, None, None]

    def take(p, yy, xx):
        return p[bidx, yy[..., :, None], xx[..., None, :]]

    return bt601(take(y, yi, xi), take(u, yi // 2, xi // 2),
                 take(v, yi // 2, xi // 2))


# ------------------------------------------------------- anchors, boxes

def anchors(det: dict, device) -> torch.Tensor:
    """Normalized cxcywh anchors [A, 4] in (level, y, x, box) order."""
    h, w = det["input_hw"]
    levels = 3 + det["extra_levels"]
    shapes = [(-(-h // (8 * 2 ** i)), -(-w // (8 * 2 ** i)))
              for i in range(levels)]
    lo, hi = det["min_scale"], det["max_scale"]
    scales = [lo + (hi - lo) * i / max(levels - 1, 1) for i in range(levels)]
    scales.append(1.0)
    out = []
    for i, (fh, fw) in enumerate(shapes):
        per = [(scales[i], ar) for ar in det["aspect_ratios"]]
        per.append((math.sqrt(scales[i] * scales[i + 1]), 1.0))
        for yy, xx in itertools.product(range(fh), range(fw)):
            for s, ar in per:
                out.append([(xx + 0.5) / fw, (yy + 0.5) / fh,
                            s * math.sqrt(ar), s / math.sqrt(ar)])
    return torch.tensor(np.asarray(out, np.float32), device=device)


def decode(loc: torch.Tensor, anc: torch.Tensor, var) -> torch.Tensor:
    """Centre-offset decode → corner boxes in the unit square."""
    cx = anc[:, 0] + loc[..., 0] * var[0] * anc[:, 2]
    cy = anc[:, 1] + loc[..., 1] * var[1] * anc[:, 3]
    w = anc[:, 2] * torch.exp(torch.clamp(loc[..., 2] * var[2], -10, 10))
    h = anc[:, 3] * torch.exp(torch.clamp(loc[..., 3] * var[3], -10, 10))
    return torch.clamp(torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                    cy + h / 2], -1), 0.0, 1.0)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of corner boxes a [..., N, 4], b [..., M, 4]."""
    area = lambda t: (torch.clamp(t[..., 2] - t[..., 0], min=0)  # noqa: E731
                      * torch.clamp(t[..., 3] - t[..., 1], min=0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_rows(boxes: torch.Tensor, probs: torch.Tensor, det: dict
             ) -> torch.Tensor:
    """Greedy class-aware NMS → packed rows [B, K, 7]. Each anchor
    offers its best foreground class; scores under the threshold drop
    out; the top ``max_detections`` by score (lower index first among
    ties) are visited in order, each kept unless a kept, higher one of
    its label overlaps it by more than the IoU threshold."""
    k = det["max_detections"]
    fg = probs[..., 1:]
    score, label = fg.max(dim=-1)
    label = label + 1
    score = torch.where(score >= det["score_threshold"], score,
                        torch.full_like(score, -1.0))
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    bx = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    lb = torch.gather(label, 1, idx)
    over = iou(bx, bx) > det["iou_threshold"]
    same = lb[:, :, None] == lb[:, None, :]
    keep = torch.zeros_like(top, dtype=torch.bool)
    for i in range(top.shape[1]):
        hit = (over[:, i, :i] & same[:, i, :i] & keep[:, :i]).any(dim=1)
        keep[:, i] = ~hit
    valid = keep & (top > 0)
    rows = torch.zeros(top.shape + (7,), dtype=torch.float32,
                       device=boxes.device)
    for f in range(top.shape[0]):
        sel = valid[f].nonzero()[:, 0]
        n = sel.numel()
        rows[f, :n, :4] = bx[f, sel]
        rows[f, :n, 4] = top[f, sel]
        rows[f, :n, 5] = lb[f, sel].float()
        rows[f, :n, 6] = 1.0
        rows[f, n:, 5] = -1.0
    return rows


# --------------------------------------------------------------- engines

@dataclass
class Detail:
    """What the reference works out for a block of frames: every
    anchor's decoded box and class probabilities, and its own rows."""

    boxes: torch.Tensor   # [B, A, 4]
    probs: torch.Tensor   # [B, A, C]
    rows: torch.Tensor    # [B, K, 7 (+ Σ heads)]


def wire_of(cfg: dict, seeds: torch.Tensor) -> torch.Tensor:
    h, w = cfg["wire"]["frame_hw"]
    return wire_bytes(seeds, (h * 3 // 2, w))


def detect(cfg: dict, det_params: dict, wire: torch.Tensor,
           quant: Quant | None) -> Detail:
    det = cfg["detector"]
    x = model_input(wire, tuple(det["input_hw"]))
    loc, conf = ssd_forward(det_params, det, x, quant)
    boxes = decode(loc, anchors(det, wire.device), det["variances"])
    probs = torch.softmax(conf, dim=-1)
    return Detail(boxes, probs, nms_rows(boxes, probs, det))


def allowed_labels(cfg: dict) -> list[int]:
    cls = cfg.get("classifier")
    if not cls or not cls.get("object_class"):
        return []
    return [i for i, name in enumerate(cfg["detector"]["labels"])
            if name == cls["object_class"]]


def roi_slots(cfg: dict, rows: torch.Tensor) -> torch.Tensor:
    """[B, K] → the row index of each ROI slot [B, R] and whether the
    slot holds an eligible row: the first ``roi_budget`` valid rows of
    an allowed label, in row order (then the others, unclassified)."""
    eligible = rows[..., 6] > 0.5
    allowed = allowed_labels(cfg)
    if allowed:
        eligible = eligible & torch.isin(
            rows[..., 5], torch.tensor(allowed, dtype=rows.dtype,
                                       device=rows.device))
    order = torch.argsort((~eligible).to(torch.int32), dim=1, stable=True)
    idx = order[:, :cfg["classifier"]["roi_budget"]]
    return idx, torch.gather(eligible, 1, idx)


def classify_rows(cfg: dict, cls_params: dict, wire: torch.Tensor,
                  rows: torch.Tensor, quant: Quant | None) -> torch.Tensor:
    """Detection rows [B, K, 7] → fused rows [B, K, 7 + Σ heads]."""
    cls = cfg["classifier"]
    idx, ok = roi_slots(cfg, rows)
    boxes = torch.gather(rows[..., :4], 1, idx[..., None].expand(-1, -1, 4))
    crops = crop_i420(wire, boxes, tuple(cls["input_hw"]))
    b, r = boxes.shape[:2]
    probs = classifier_forward(cls_params, cls,
                               crops.reshape((b * r,) + crops.shape[2:]),
                               quant).reshape(b, r, -1) * ok[..., None]
    block = torch.zeros(rows.shape[:2] + probs.shape[2:],
                        dtype=torch.float32, device=rows.device)
    block.scatter_(1, idx[..., None].expand_as(probs), probs)
    return torch.cat([rows, block], dim=-1)


def serve(cfg: dict, params: dict, seeds: torch.Tensor,
          quant: Quant | None) -> Detail:
    """The engine's output for ``seeds`` as the reference computes it:
    the detect engine's rows, or the fused engine's."""
    wire = wire_of(cfg, seeds)
    out = detect(cfg, params["detector"], wire, quant)
    if cfg.get("classifier"):
        out.rows = classify_rows(cfg, params["classifier"], wire, out.rows,
                                 quant)
    return out


def crop_probs(cfg: dict, cls_params: dict, seeds: torch.Tensor,
               boxes: torch.Tensor) -> torch.Tensor:
    """The classifier's probabilities [B, R, Σ heads] on the crops of
    given boxes [B, R, 4] of the frames of ``seeds`` (float32)."""
    cls = cfg["classifier"]
    crops = crop_i420(wire_of(cfg, seeds), boxes, tuple(cls["input_hw"]))
    b, r = boxes.shape[:2]
    return classifier_forward(
        cls_params, cls, crops.reshape((b * r,) + crops.shape[2:]),
        None).reshape(b, r, -1)


def models(config: dict) -> dict[str, tuple[str, list]]:
    """Role → (the model key the program serves it under, its
    parameters' (key, shape, fan-in))."""
    out = {"detector": (config["detector"]["key"],
                        param_shapes(detector_layers(config["detector"])))}
    cls = config.get("classifier")
    if cls:
        out["classifier"] = (cls["key"], param_shapes(
            classifier_layers(cls["width"], cls["heads"])))
    return out


#: the conf heads' margin (logits) of an anchor slot's own class
CLASS_MARGIN = 1.0


def slot_classes(config: dict) -> list[int]:
    """The foreground class each anchor slot of a cell leads with: the
    configuration's object class first, then the others in turn."""
    det = config["detector"]
    fg = list(range(1, det["num_classes"]))
    first = allowed_labels(config)[:1]
    order = first + [c for c in fg if c not in first]
    return [order[a % len(order)]
            for a in range(len(det["aspect_ratios"]) + 1)]


def tie_conf_heads(config: dict, params: dict) -> dict:
    """Random conf heads make one class lead every top detection of a
    seed (the class whose kernel meets the features' mean best), so a
    fused engine would classify nothing in most seeds. Here every slot
    of a level shares one background and one foreground kernel, and a
    slot's own class (:func:`slot_classes`) leads by
    :data:`CLASS_MARGIN`: each location offers one row of each slot's
    class, the object class among them, whatever the seed."""
    det = config["detector"]
    c = det["num_classes"]
    lead = slot_classes(config)
    for i in range(3 + det["extra_levels"]):
        wk, bk = f"SSDHead_{i}.Conv_1.weight", f"SSDHead_{i}.Conv_1.bias"
        w = params[wk].reshape(len(lead), c, *params[wk].shape[1:]).clone()
        b = params[bk].reshape(len(lead), c).clone()
        w[:, 0] = w[0, 0]
        w[:, 1:] = w[0, 1]
        b[:, 0] = b[0, 0]
        b[:, 1:] = b[0, 1]
        for a, cls in enumerate(lead):
            b[a, cls] += CLASS_MARGIN
        params[wk] = w.reshape(params[wk].shape)
        params[bk] = b.reshape(-1)
    return params


#: the stems' kernels are scaled by this: they read raw 0..255 pixels,
#: and at the lecun spread their outputs (±150) would pin relu6 at 0 or
#: 6, leaving a network of near-binary activations that no precision
#: change disturbs; scaled, they sit inside relu6's range, as a trained
#: stem's do
STEM_SCALE = 1.0 / 64.0
STEMS = ("Backbone_0.ConvBlock_0.Conv_0.weight", "ConvBlock_0.Conv_0.weight")


def make_weights(config: dict, seed: int, device, dtype, draw) -> dict:
    """Role → (model key, parameters) for ``seed``: ``draw(shapes,
    seed, salt, device, dtype)`` makes each model's random leaves; the
    stems are scaled by :data:`STEM_SCALE` and the detector's conf heads
    tied (:func:`tie_conf_heads`)."""
    out = {}
    for salt, (role, (key, shapes)) in enumerate(models(config).items(),
                                                 start=1):
        p = draw(shapes, seed, salt, device, dtype)
        for stem in STEMS:
            if stem in p:
                p[stem] = p[stem] * STEM_SCALE
        if role == "detector":
            p = tie_conf_heads(config, p)
        out[role] = (key, p)
    return out


def overrides(config: dict) -> tuple[dict, dict]:
    """The (input size, width) overrides that size the program's models
    as the configuration states."""
    roles = [config["detector"]] + ([config["classifier"]]
                                    if config.get("classifier") else [])
    return ({m["key"]: tuple(m["input_hw"]) for m in roles},
            {m["key"]: m["width"] for m in roles})
