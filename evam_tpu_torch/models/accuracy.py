"""Offline ground-truth accuracy harness (counterpart of
``evam_tpu/models/accuracy.py``): the detector's, the classifier's and
the temporal families' halves, and the helpers of the reference's
serving-chain checks (``tests/test_accuracy.py``).

Random weights cannot show a wrong anchor decode, a flipped colour
order, broken NMS geometry, a shifted ROI crop, a decoder blind to its
clip order or a broken audio window: every path still gives finite rows
of the right shape. This module closes that gap without downloaded
weights:

* :func:`render_scene` draws deterministic synthetic scenes — three
  visually distinct object classes on a textured background — with
  exact normalized ground-truth boxes (and, with ``color_attr``, each
  vehicle's colour);
* :func:`fit_detector` fits the zoo SSD, or an imported OpenVINO IR
  detector, to those scenes (numpy anchor matching, regression targets
  through :func:`~evam_tpu_torch.ops.boxes.encode_boxes`, the exact
  inverse of the serving decode, so a decode bug breaks the fit and the
  final check alike). An IR's weights are its graph's buffers, made
  leaves that take gradients on a float32 copy
  (``ImportedIRModel.trainable_params``); its in-graph SoftMax is
  undone in the loss (``conf_is_prob``), and the fit returns the IR's
  flat ``{layer name: tensor}`` dict, which :func:`save_fitted` writes
  beside the IR for the registries to load as ``ir-bin+override``;
* :func:`fit_classifier` fits the attributes classifier's colour head to
  crops cut by the serving crop path (:func:`render_vehicle_crop`);
* :func:`evaluate_packed` scores packed NMS rows against ground truth
  (recall and precision at IoU ≥ 0.5 with label agreement), and
  :func:`evaluate_attrs` the fused detect+classify rows (a vehicle
  found at IoU ≥ 0.5 with its colour);
* :func:`fit_action` fits the action encoder and decoder together to
  :data:`TEMPORAL_CLASSES`, order-dependent ramps drawn by
  :func:`render_temporal_clip`, and :func:`fit_audio` fits AclNet to
  the :data:`TONE_FREQS` tones of :func:`render_tone_window`;
* :func:`holdout_scenes`, :func:`render_crossing_frames` (a vehicle
  whose footfall anchor crosses x = 0.5), :data:`LABEL_IDS` and
  :func:`recovered` (a published box matched to ground truth) are the
  reference test's helpers, so the chain's checks — tracking and line
  crossing, zone count, the EII bus's ``gva_meta`` rects — read the
  same frames and the same rule in both packages.

The renderers, the matching and the scoring are numpy, copied from the
reference, so one seed gives the same scenes, targets and scores in both
packages bit for bit. A classifier crop is cut by the port's
``crop_rois_i420`` on the CPU from the port's own wire
(``bgr_to_i420_host``, the native library's arithmetic the port serves
with); the reference encodes that wire with cv2, whose 20-bit BT.601
coefficients put a wire byte 1 LSB off on some pixels, so a crop byte
can differ from the reference's by up to 2 (none once the two encoders
agree). The fits are torch: they draw their data
and minibatch order from the same generator in the reference's order,
take the same loss, and step optax's ``adam(cosine_decay_schedule(lr,
steps, alpha=0.05))`` written out, in float32 (on the card TF32 off, and
cuDNN's deterministic algorithms, so a fit repeats). Where the reference
shrinks its 1080p scenes with ``cv2.resize(INTER_AREA)``, the port calls
``ops/color.py::resize_area_host``, its bytes; where it writes weights
with flax, :func:`save_fitted` writes flax's bytes with the port's codec
(``models/convert.py``), so both registries load the file.

The port runs a fit to convergence only on the card: ``chip_smoke.py``'s
``accuracy`` and ``attrs`` phases assert the reference test's limits
there, served at float32 and at INT8 through the qgemm kernel (the
``accuracy`` phase also through the tracker and line crossing, the zone
count and the EII bus), its ``temporal`` phase the action and audio
limits, served at float32 and at INT8 (bfloat16 weights, no qgemm), and
its ``irfit`` phase the fit through the imported IR (float32; an IR
engine launches no qgemm). Tier-1 holds the port to the reference step
by step on the CPU (scenes, crops, clips, tones, targets, data order,
losses, first updates, served rows and the chain's published ids,
events and counts) and runs no full fit there.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import math
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from evam_tpu_torch.device import resolve_device
from evam_tpu_torch.models.convert import flat_to_msgpack, params_to_msgpack
from evam_tpu_torch.models.ir import ImportedIRModel
from evam_tpu_torch.ops.boxes import encode_boxes
from evam_tpu_torch.ops.color import (
    bgr_to_i420_host,
    crop_rois_i420,
    resize_area_host,
)
from evam_tpu_torch.ops.preprocess import preprocess_bgr

log = logging.getLogger("evam_tpu_torch.models.accuracy")

#: class id → (BGR color, aspect w/h): visually separable by a tiny
#: conv net. Labels follow labels.PERSON_VEHICLE_BIKE (background=0).
CLASS_STYLES = {
    1: ((40, 200, 40), 0.45),   # person: tall, green
    2: ((200, 90, 30), 2.2),    # vehicle: wide, blue
    3: ((30, 30, 210), 1.0),    # bike: square, red
}

#: BGR value per labels.VEHICLE_COLORS entry — the classifier ground
#: truth for ``color_attr`` scenes (vehicle inner region is painted
#: with one of these; the border keeps the vehicle class color).
ATTR_COLORS_BGR = (
    (245, 245, 245),  # white
    (130, 130, 130),  # gray
    (40, 230, 230),   # yellow
    (40, 40, 230),    # red
    (40, 200, 40),    # green
    (230, 130, 40),   # blue
    (25, 25, 25),     # black
)


@dataclass
class Scene:
    frame: np.ndarray          # uint8 BGR [H, W, 3]
    boxes: np.ndarray          # float32 [N, 4] normalized x0 y0 x1 y1
    labels: np.ndarray         # int32 [N] (1..3)
    attrs: np.ndarray | None = None  # int32 [N] color idx; -1 = n/a


def _textured_bg(rng: np.random.Generator, h: int, w: int,
                 base: int | None = None) -> np.ndarray:
    """Mildly textured background (8×8 noise tiles) so nets cannot key
    on a flat value — shared by every renderer in this module."""
    if base is None:
        base = int(rng.integers(96, 160))
    noise = rng.integers(0, 24, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
    return np.clip(
        np.full((h, w, 3), base, np.int16)
        + np.kron(noise, np.ones((8, 8, 1), np.int16))[:h, :w] - 12,
        0, 255).astype(np.uint8)


def _draw_object(frame: np.ndarray, xi: int, yi: int, xe: int, ye: int,
                 color: tuple, inner: tuple | None = None) -> None:
    """The harness's object idiom: solid fill + quarter-inset interior
    (``inner``; default half-brightness). One definition so every
    renderer draws the same distribution the detector was fitted on."""
    frame[yi:ye, xi:xe] = color
    iy, ix = max((ye - yi) // 4, 1), max((xe - xi) // 4, 1)
    frame[yi + iy:ye - iy, xi + ix:xe - ix] = (
        tuple(c // 2 for c in color) if inner is None else inner)


def render_scene(
    rng: np.random.Generator,
    hw: tuple[int, int] = (1080, 1920),
    max_objects: int = 3,
    color_attr: bool = False,
) -> Scene:
    """One scene: textured background + 1..max_objects solid shapes.

    Geometry lives in NORMALIZED coordinates (heights 18–38% of frame
    height, widths = height × class aspect) so the post-stretch object
    distribution is identical whether the scene is rendered at the
    model input size or at 1080p — the serving path stretch-resizes
    full frames to the square model input, and the anchors must see
    the same normalized aspects either way. Placements are rejected on
    overlap (IoU > 0.1) so ground truth is unambiguous for NMS.
    """
    h, w = hw
    frame = _textured_bg(rng, h, w)

    n = int(rng.integers(1, max_objects + 1))
    boxes, labels, attrs = [], [], []
    for _ in range(n):
        for _attempt in range(20):
            cls = int(rng.integers(1, 4))
            color, aspect = CLASS_STYLES[cls]
            bh_n = rng.uniform(0.18, 0.38)       # normalized height
            bw_n = min(bh_n * aspect, 0.9)       # normalized width
            x0_n = rng.uniform(0.02, 0.98 - bw_n)
            y0_n = rng.uniform(0.02, 0.98 - bh_n)
            cand = np.asarray(
                [x0_n, y0_n, x0_n + bw_n, y0_n + bh_n], np.float32)
            bw, bh = bw_n * w, bh_n * h
            x0, y0 = x0_n * w, y0_n * h
            if boxes and _max_iou(cand, np.stack(boxes)) > 0.1:
                continue
            xi, yi, xe, ye = (int(x0), int(y0), int(x0 + bw), int(y0 + bh))
            attr = -1
            inner = None  # default: darker band for internal structure
            if color_attr and cls == 2:
                # classification ground truth: vehicle interior takes
                # one of the 7 VEHICLE_COLORS; the border keeps the
                # class color so detection stays learnable
                attr = int(rng.integers(0, len(ATTR_COLORS_BGR)))
                inner = ATTR_COLORS_BGR[attr]
            _draw_object(frame, xi, yi, xe, ye, color, inner)
            boxes.append(cand)
            labels.append(cls)
            attrs.append(attr)
            break
    return Scene(frame=frame,
                 boxes=np.stack(boxes).astype(np.float32),
                 labels=np.asarray(labels, np.int32),
                 attrs=np.asarray(attrs, np.int32))


def _max_iou(box: np.ndarray, others: np.ndarray) -> float:
    lt = np.maximum(box[:2], others[:, :2])
    rb = np.minimum(box[2:], others[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (others[:, 2] - others[:, 0]) * (others[:, 3] - others[:, 1])
    return float((inter / np.maximum(a + b - inter, 1e-9)).max())


def match_anchors(
    anchors_corner: np.ndarray,
    scene: Scene,
    pos_iou: float = 0.5,
) -> tuple[np.ndarray, np.ndarray]:
    """SSD target assignment → (cls_target [A], box_target [A, 4]).

    Anchors with IoU ≥ pos_iou match their best GT; the best anchor of
    every GT is force-matched so no object is unlearnable.
    """
    A = anchors_corner.shape[0]
    cls_t = np.zeros((A,), np.int32)
    box_t = np.zeros((A, 4), np.float32)
    ious = _pairwise_iou(anchors_corner, scene.boxes)  # [A, N]
    best_gt = ious.argmax(axis=1)
    best_iou = ious.max(axis=1)
    pos = best_iou >= pos_iou
    pos[ious.argmax(axis=0)] = True            # force best anchor per GT
    best_gt[ious.argmax(axis=0)] = np.arange(scene.boxes.shape[0])
    cls_t[pos] = scene.labels[best_gt[pos]]
    box_t[pos] = scene.boxes[best_gt[pos]]
    return cls_t, box_t


def _pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def anchors_to_corner(anchors_cxcywh: np.ndarray) -> np.ndarray:
    cx, cy, w, h = np.split(anchors_cxcywh, 4, axis=-1)
    return np.concatenate(
        [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)


def _fit_data(model, rng: np.random.Generator, n_scenes: int,
              source_hw: tuple[int, int] = (1080, 1920),
              color_attr: bool = False
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The fit's training arrays, drawn from ``rng`` as the reference
    draws them: scene ``i`` rendered at the model's input size when
    ``i`` is even, else at ``source_hw`` and area-downscaled, then
    matched at IoU 0.4. Returns (images uint8 BGR [N, h, w, 3], class
    targets int32 [N, A], box targets float32 [N, A, 4])."""
    h, w = model.spec.input_size
    anchors_c = anchors_to_corner(np.asarray(model.anchors, np.float32))
    imgs, cls_ts, box_ts = [], [], []
    for i in range(n_scenes):
        if i % 2 == 0:
            scene = render_scene(rng, hw=(h, w), color_attr=color_attr)
            img = scene.frame
        else:
            scene = render_scene(rng, hw=source_hw, color_attr=color_attr)
            img = resize_area_host(scene.frame, h, w)
        cls_t, box_t = match_anchors(anchors_c, scene, pos_iou=0.4)
        imgs.append(img)
        cls_ts.append(cls_t)
        box_ts.append(box_t)
    return np.stack(imgs), np.stack(cls_ts), np.stack(box_ts)


def _minibatches(rng: np.random.Generator, n_scenes: int, steps: int,
                 batch: int) -> np.ndarray:
    """Scene indices of every step [steps, ≤ batch]: one permutation per
    epoch of ``n_scenes // batch`` steps, drawn from ``rng`` (after the
    data) as the reference's loop draws them."""
    per_epoch = max(n_scenes // batch, 1)
    order = rng.permutation(n_scenes)
    out = []
    for step in range(steps):
        if step % per_epoch == 0 and step:
            order = rng.permutation(n_scenes)  # reshuffle every epoch
        start = (step % per_epoch) * batch
        out.append(order[start:start + batch])
    return np.stack(out) if out else np.zeros((0, batch), np.int64)


def _replacement_batches(rng: np.random.Generator, n: int, steps: int,
                         batch: int) -> np.ndarray:
    """Sample indices of every step [steps, batch] of ``_fit_loop``: one
    ``rng.integers(0, n, size=batch)`` a step, drawn from ``rng`` (after
    the data) as the reference's loop draws them (with replacement)."""
    out = [rng.integers(0, n, size=batch) for _ in range(steps)]
    return np.stack(out) if out else np.zeros((0, batch), np.int64)


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``softmax_cross_entropy_with_integer_labels``: the max held
    constant, the normalizer subtracted at the label only. ``logits``
    float32 [..., C], ``labels`` int64 [...] → [...]."""
    z = logits - logits.max(-1, keepdim=True).values.detach()
    return (torch.log(torch.exp(z).sum(-1))
            - z.gather(-1, labels[..., None])[..., 0])


def _detector_loss(out: dict, cls_t: torch.Tensor, box_t: torch.Tensor,
                   anchors: torch.Tensor,
                   variances: tuple[float, float, float, float],
                   conf_is_prob: bool = False) -> torch.Tensor:
    """The reference's fit loss on one batch: smooth-L1 (optax's Huber,
    delta 1) on the encoded offsets of positive anchors, weighted 2×,
    plus softmax cross-entropy on positives and on the hardest
    negatives, 3 per positive and at least 8 per image (a descending
    sort). ``out`` is the forward's ``{"loc", "conf"}``; ``cls_t``
    int64 [B, A], ``box_t`` float32 [B, A, 4]."""
    conf = out["conf"].float()                          # [B, A, C]
    if conf_is_prob:
        # IR graphs may softmax in-graph: recover logits for CE
        conf = torch.log(conf + 1e-9)
    loc = out["loc"].float()                            # [B, A, 4]
    pos = cls_t > 0
    posf = pos.float()
    n_pos = torch.clamp(pos.sum(), min=1)
    # localization: smooth-L1 on encoded offsets, positives only
    err = (loc - encode_boxes(box_t, anchors, variances)).abs()
    quadratic = torch.clamp(err, max=1.0)
    l1 = (0.5 * quadratic ** 2 + (err - quadratic)).sum(-1)
    # 2× weight: matched-IoU quality is the assertion target
    loc_loss = 2.0 * (l1 * posf).sum() / n_pos
    ce = _softmax_ce(conf, cls_t)
    pos_ce = (ce * posf).sum() / n_pos
    # 3:1 online hard-negative mining
    neg_ce = torch.where(pos, float("-inf"), ce)
    k = torch.clamp(3 * pos.sum(dim=1), min=8)          # per-image cap
    neg_sorted = torch.sort(neg_ce, dim=1, descending=True).values
    take = (torch.arange(neg_sorted.shape[1], device=neg_sorted.device)[None]
            < k[:, None])
    hard_neg = torch.where(take & torch.isfinite(neg_sorted), neg_sorted,
                           torch.zeros_like(neg_sorted))
    neg_loss = hard_neg.sum() / torch.clamp(take.sum(), min=1)
    return loc_loss + pos_ce + neg_loss


class _Adam:
    """optax's ``adam(cosine_decay_schedule(lr, steps, alpha))`` written
    out: b1 0.9, b2 0.999, eps 1e-8, no weight decay; moments ``(1 - b)
    · g + b · m``, bias-corrected by ``1 - b ** count``, the update
    ``-lr(t) · m̂ / (√v̂ + eps)`` with the schedule at the count before
    the step. Every tensor of a step in one ``torch._foreach_*`` call."""

    def __init__(self, params: list[torch.Tensor], lr: float, steps: int,
                 alpha: float = 0.05, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = params
        self.lr, self.steps, self.alpha = lr, steps, alpha
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def learning_rate(self, count: int) -> float:
        """optax's ``cosine_decay_schedule(lr, steps, alpha)`` at ``count``."""
        c = min(count, self.steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / self.steps))
        return self.lr * ((1 - self.alpha) * cosine + self.alpha)

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        lr = self.learning_rate(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - self.b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - self.b2))
        # the bias corrections in float32, as optax computes them
        bc1 = float(np.float32(1) - np.float32(self.b1) ** self.count)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** self.count)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)


@contextlib.contextmanager
def _fit_math(device: torch.device):
    """On the card, while the block runs: TF32 off for the matmuls and
    convolutions (the reference fits in float32), and cuDNN held to its
    deterministic algorithms, so a fit gives the same weights run after
    run (the backward's other scatters write each element once). The
    caller's settings come back after."""
    if device.type != "cuda":
        yield
        return
    flags = ((torch.backends.cuda.matmul, "allow_tf32", False),
             (torch.backends.cudnn, "allow_tf32", False),
             (torch.backends.cudnn, "deterministic", True),
             (torch.backends.cudnn, "benchmark", False))
    saved = [getattr(obj, name) for obj, name, _ in flags]
    for obj, name, value in flags:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for (obj, name, _), value in zip(flags, saved):
            setattr(obj, name, value)


def _trainable_copy(module: torch.nn.Module, dev: torch.device, name: str
                    ) -> tuple[torch.nn.Module, list[torch.Tensor]]:
    """A float32 copy of ``module`` on ``dev`` that takes gradients, and
    the tensors a fit updates: a zoo module's parameters, or an imported
    IR's float weights (its graph's buffers, made leaves after the copy
    is cast: a non-leaf buffer would not copy). The module itself is
    left as it was."""
    net = copy.deepcopy(module).to(device=dev, dtype=torch.float32)
    ir = _imported_ir(net)
    if ir is not None:
        params = list(ir.trainable_params().values())
    else:
        net.requires_grad_(True)
        params = list(net.parameters())
    if not params:
        raise ValueError(f"{name}: the model has no weights to fit")
    return net, params


def _imported_ir(net: torch.nn.Module) -> ImportedIRModel | None:
    """The imported IR graph an IR-backed model's module (``IRForward``)
    runs, or None for a zoo module."""
    return next((m for m in net.modules() if isinstance(m, ImportedIRModel)),
                None)


def _grads(loss: torch.Tensor, params: list[torch.Tensor]
           ) -> list[torch.Tensor]:
    """The loss's gradient for each of ``params``; zeros for one the loss
    never reads (an IR's folded priors), which Adam then leaves as it
    was, as optax does."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def _cpu_state(net: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The fitted weights on the CPU: a zoo module's ``state_dict``, or an
    imported IR's flat ``{layer name: tensor}`` dict sorted by name (the
    order ``jax.tree.map`` leaves the reference's fitted dict in)."""
    ir = _imported_ir(net)
    if ir is not None:
        return {k: v.detach().to("cpu").contiguous()
                for k, v in sorted(ir.params.items())}
    return {k: v.detach().to("cpu").contiguous()
            for k, v in net.state_dict().items()}


def fit_detector(
    model,
    seed: int = 0,
    n_scenes: int = 128,
    steps: int = 800,
    batch: int = 8,
    lr: float = 3e-3,
    source_hw: tuple[int, int] = (1080, 1920),
    color_attr: bool = False,
    device: str | torch.device | None = None,
    timings: dict | None = None,
):
    """Fit the zoo SSD, or an IR-backed detector, to the synthetic scenes
    on ``device`` (None → the card, which must exist).

    ``model`` is a LoadedModel of a zoo ``ssd`` spec or of an imported
    OpenVINO IR SSD (``model.ir``); a float32 copy of its module is
    fitted, the model itself is left as it was. Half the
    training scenes are rendered at the model's input size, half at
    ``source_hw`` and downscaled — the serving path resizes full frames
    on the device, so the net must be robust to both texture scales.
    Images go through the serving normalization
    (``ops/preprocess.py::preprocess_bgr`` with the model's spec) into
    the model's serving forward, so the fitted weights are valid under
    ``preprocess_wire``; an IR that softmaxes in the graph
    (``conf_is_prob``) has its logits recovered for the loss. Returns
    ``(weights, history)``: the fitted float32 weights on the CPU (a
    zoo module's ``state_dict``; an IR's flat dict, as the reference's
    ``params`` is for an IR), and the loss at every 50th step and at
    the last. A ``timings`` dict, when given, gets the seconds spent
    making the data (``data_s``) and fitting (``steps_s``: the copy to
    the device and the steps, synchronized at the end).
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    imgs, cls_ts, box_ts = _fit_data(model, rng, n_scenes, source_hw,
                                     color_attr)
    log.info("fit: %d scenes, %d anchors, %d positives", n_scenes,
             cls_ts.shape[1], int((cls_ts > 0).sum()))
    order = _minibatches(rng, n_scenes, steps, batch)
    t1 = time.perf_counter()

    net, params = _trainable_copy(model.module, dev, model.spec.key)
    # the serving forward, over the copy's weights
    fwd = dataclasses.replace(model, module=net).forward
    pre = model.preprocess
    opt = _Adam(params, lr, steps)
    anchors = torch.from_numpy(np.asarray(model.anchors, np.float32)).to(dev)
    imgs_d = torch.from_numpy(imgs).to(dev)
    cls_d = torch.from_numpy(cls_ts).to(dev, torch.int64)
    box_d = torch.from_numpy(box_ts).to(dev)
    order_d = torch.from_numpy(order).to(dev)

    history = []
    with _fit_math(dev):
        for step in range(steps):
            idx = order_d[step]
            # flax promotes a bfloat16 input against float32 params
            x = preprocess_bgr(imgs_d[idx].float(), pre).float()
            loss = _detector_loss(fwd(x), cls_d[idx], box_d[idx], anchors,
                                  model.variances, model.conf_is_prob)
            opt.step(_grads(loss, params))
            if step % 50 == 0 or step == steps - 1:
                history.append(float(loss.detach()))
                log.info("fit step %d loss %.4f", step, history[-1])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if timings is not None:
        timings.update(data_s=t1 - t0, steps_s=time.perf_counter() - t1)
    return _cpu_state(net), history


def _fit_loop(loss_fn, arrays, *, init_params, steps, batch, lr, rng, name,
              device):
    """The shared harness trainer (the classifier's, the action and the
    audio fits): ``_Adam`` with the cosine schedule over a float32 copy
    of ``init_params`` (an ``nn.Module``; the action fit's encoder and
    decoder as one ``ModuleDict``), on
    ``device`` under ``_fit_math``, one step a minibatch drawn with
    replacement (``_replacement_batches``), eagerly. ``loss_fn(net,
    *batch_tensors)`` → scalar loss; ``arrays`` numpy [N, ...] each,
    moved to the device once. ``fit_detector`` keeps its epoch-shuffled
    loop, as the reference's does. Returns ``(state_dict, history)``:
    the fitted float32 weights on the CPU, and the loss at every 50th
    step and at the last."""
    dev = torch.device(device)
    net, params = _trainable_copy(init_params, dev, name)
    opt = _Adam(params, lr, steps)
    order = torch.from_numpy(_replacement_batches(
        rng, arrays[0].shape[0], steps, batch)).to(dev)
    data = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    history = []
    with _fit_math(dev):
        for step in range(steps):
            idx = order[step]
            loss = loss_fn(net, *(a[idx] for a in data))
            opt.step(_grads(loss, params))
            if step % 50 == 0 or step == steps - 1:
                history.append(float(loss.detach()))
                log.info("%s step %d loss %.4f", name, step, history[-1])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return _cpu_state(net), history


def render_vehicle_crop(
    rng: np.random.Generator, attr: int,
    out_hw: tuple[int, int],
) -> np.ndarray:
    """One classifier training crop produced by the SERVING crop path.

    Domain-matched training is the point (measured in the reference:
    clean cv2 crops train a net that confuses white/gray once crops
    arrive through the wire): render the vehicle into a small frame,
    convert with ``bgr_to_i420_host`` (BT.601 + 2×2 chroma subsampling),
    then cut the crop with ``crop_rois_i420`` using a box jittered like
    an IoU≥0.5 detection (shift/scale up to ~30%). The crop is data: it
    is cut on the CPU whatever device fits, so a fit gets the same bytes
    on every machine. The returned uint8 crop (truncated, as the
    reference's ``astype``) has the serving path's resize + colour
    statistics.
    """
    # small host frame (multiple of 2 for i420) with the vehicle
    # somewhere inside it
    fh, fw = 96, 128
    bg = int(rng.integers(96, 160))
    frame = np.full((fh, fw, 3), bg, np.uint8)
    bh = int(rng.integers(24, 72))
    bw = int(rng.integers(40, 110))
    y0 = int(rng.integers(2, fh - bh - 2))
    x0 = int(rng.integers(2, fw - bw - 2))
    frame[y0:y0 + bh, x0:x0 + bw] = CLASS_STYLES[2][0]
    iy, ix = max(bh // 4, 1), max(bw // 4, 1)
    frame[y0 + iy:y0 + bh - iy, x0 + ix:x0 + bw - ix] = \
        ATTR_COLORS_BGR[attr]

    # detection-like jitter on the crop box (±30% shift/scale)
    jx0 = x0 + rng.uniform(-0.3, 0.3) * bw
    jy0 = y0 + rng.uniform(-0.3, 0.3) * bh
    jx1 = x0 + bw + rng.uniform(-0.3, 0.3) * bw
    jy1 = y0 + bh + rng.uniform(-0.3, 0.3) * bh
    box = np.asarray([[[
        max(jx0 / fw, 0.0), max(jy0 / fh, 0.0),
        min(jx1 / fw, 1.0), min(jy1 / fh, 1.0)]]], np.float32)
    wire = bgr_to_i420_host(frame)[None]
    crop = crop_rois_i420(torch.from_numpy(wire), torch.from_numpy(box),
                          out_hw)
    return crop[0, 0].numpy().astype(np.uint8)


def _classifier_data(model, rng: np.random.Generator, n_crops: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The classifier fit's training arrays, drawn from ``rng`` as the
    reference draws them: every crop's colour first, then the crops at
    the model's input size. Returns (crops uint8 BGR [N, h, w, 3],
    colours int64 [N])."""
    h, w = model.spec.input_size
    attrs = rng.integers(0, len(ATTR_COLORS_BGR), size=n_crops)
    crops = np.stack([
        render_vehicle_crop(rng, int(a), (h, w)) for a in attrs
    ])
    return crops, attrs


def fit_classifier(
    model,
    seed: int = 1,
    n_crops: int = 512,
    steps: int = 400,
    batch: int = 32,
    lr: float = 3e-3,
    device: str | torch.device | None = None,
    timings: dict | None = None,
):
    """Fit the zoo attributes classifier's color head to the attr
    palette on ``device`` (None → the card, which must exist).
    ``model`` is a LoadedModel for the ``classifier`` spec (heads
    color/type); a float32 copy of its module is fitted, the model
    itself is left as it was. The type head is trained to a constant
    ('car') — scenes render one vehicle shape — so only the color head
    carries ground truth. Crops go through the serving normalization
    (``preprocess_bgr`` with the model's spec). Returns ``(state_dict,
    history)`` as ``_fit_loop``; a ``timings`` dict gets ``data_s`` and
    ``steps_s`` as ``fit_detector`` fills it."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    crops, attrs = _classifier_data(model, rng, n_crops)
    t1 = time.perf_counter()
    pre = model.preprocess

    def loss_fn(net, u8, y):
        # flax promotes a bfloat16 input against float32 params
        out = net(preprocess_bgr(u8.float(), pre).float())
        ce = _softmax_ce(out["color"].float(), y).mean()
        ce_type = _softmax_ce(out["type"].float(), torch.zeros_like(y)).mean()
        return ce + 0.1 * ce_type

    state, history = _fit_loop(
        loss_fn, (crops, attrs), init_params=model.module,
        steps=steps, batch=batch, lr=lr, rng=rng, name="fit_classifier",
        device=dev)
    if timings is not None:
        timings.update(data_s=t1 - t0, steps_s=time.perf_counter() - t1)
    return state, history


def evaluate_attrs(
    packed: np.ndarray,
    scenes: list[Scene],
    n_colors: int = 7,
    iou_thresh: float = 0.5,
) -> dict:
    """Score the fused detect+classify output against vehicle color
    ground truth. Rows are ``[x0 y0 x1 y1 score label valid,
    color_probs(n_colors), ...]``. A GT vehicle counts recovered iff a
    valid label-2 detection matches at IoU ≥ iou_thresh AND its color
    argmax equals the scene attr."""
    tp, n_gt = 0, 0
    misses = []
    for scene, rows in zip(scenes, packed):
        for gt_box, gt_label, gt_attr in zip(
                scene.boxes, scene.labels, scene.attrs):
            if int(gt_label) != 2:
                continue
            n_gt += 1
            hit = False
            for row in np.asarray(rows):
                if row[6] <= 0.5 or int(row[5]) != 2:
                    continue
                if _pairwise_iou(
                        row[None, :4].astype(np.float32),
                        gt_box[None])[0, 0] < iou_thresh:
                    continue
                probs = row[7:7 + n_colors]
                if probs.sum() <= 0:
                    continue  # ROI budget skipped this detection
                hit = int(probs.argmax()) == int(gt_attr)
                break
            if hit:
                tp += 1
            else:
                misses.append({"attr": int(gt_attr),
                               "box": gt_box.tolist()})
    return {"attr_recall": tp / max(n_gt, 1), "gt": n_gt,
            "misses": misses}


# ------------------------------------------------- temporal families

#: The 4 temporal ground-truth classes, mapped onto action class
#: slots 0..3: grow / shrink (object area ramps up or down across the
#: clip) and brighten / darken (object intensity ramps). The encoder
#: ends in global average pooling, so per-frame features are
#: translation-invariant scalars like covered area and intensity (a
#: motion direction is invisible to it); and each pair holds the same
#: frame SET in reverse order, so the decoder must use its positional
#: embedding. A single frame is ambiguous between each pair.
TEMPORAL_CLASSES = ("grow", "shrink", "brighten", "darken")


def render_temporal_clip(
    rng: np.random.Generator,
    cls: int,
    hw: tuple[int, int],
    clip_len: int = 16,
) -> np.ndarray:
    """[T, H, W, 3] uint8 BGR clip for one TEMPORAL_CLASSES entry.
    Center, base size and background are randomized so the temporal
    ramp is the only class cue."""
    h, w = hw
    bg = _textured_bg(rng, h, w, base=int(rng.integers(96, 150)))
    cy = rng.uniform(0.35, 0.65) * h
    cx = rng.uniform(0.35, 0.65) * w
    frames = []
    for t in range(clip_len):
        frac = t / (clip_len - 1)
        if cls == 0:      # grow
            scale, value = 0.14 + 0.26 * frac, 235
        elif cls == 1:    # shrink
            scale, value = 0.40 - 0.26 * frac, 235
        elif cls == 2:    # brighten
            scale, value = 0.28, int(40 + 195 * frac)
        else:             # darken
            scale, value = 0.28, int(235 - 195 * frac)
        bh = max(int(scale * h), 2)
        bw = max(int(scale * w), 2)
        y0 = int(np.clip(cy - bh / 2, 0, h - bh))
        x0 = int(np.clip(cx - bw / 2, 0, w - bw))
        f = bg.copy()
        f[y0:y0 + bh, x0:x0 + bw] = (value, value, max(value - 30, 0))
        frames.append(f)
    return np.stack(frames)


def _temporal_data(enc_model, rng: np.random.Generator, n_clips: int,
                   source_hw: tuple[int, int] | None,
                   clip_len: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """The action fit's training arrays, drawn from ``rng`` as the
    reference draws them: per clip its class, then the clip, at the
    encoder's input size when the clip's index is even (or
    ``source_hw`` is None), else at ``source_hw`` and area-downscaled
    frame by frame. Returns (clips uint8 BGR [N, T, h, w, 3], classes
    int32 [N])."""
    h, w = enc_model.spec.input_size
    clips, ys = [], []
    for i in range(n_clips):
        d = int(rng.integers(0, 4))
        if i % 2 == 0 or source_hw is None:
            clip = render_temporal_clip(rng, d, (h, w), clip_len)
        else:
            big = render_temporal_clip(rng, d, source_hw, clip_len)
            clip = np.stack([resize_area_host(f, h, w) for f in big])
        clips.append(clip)
        ys.append(d)
    return np.stack(clips), np.asarray(ys, np.int32)


def fit_action(
    enc_model, dec_model,
    seed: int = 2,
    n_clips: int = 128,
    steps: int = 600,
    batch: int = 8,
    lr: float = 5e-4,   # depth-4 transformer oscillates at 2e-3
    source_hw: tuple[int, int] | None = (64, 96),
    device: str | torch.device | None = None,
    timings: dict | None = None,
):
    """Jointly fit the action encoder+decoder to the 4
    TEMPORAL_CLASSES (class ids 0..3 of the 400-way decoder) on
    ``device`` (None → the card, which must exist). Half the clips
    render at the encoder input size, half at ``source_hw`` and are
    shrunk — the serving path stretches source frames on the device.
    ``source_hw`` must be at least the encoder's input size on both
    axes (the area resize only shrinks). Float32 copies of both modules
    are fitted, the models themselves are left as they were. Frames go
    through the serving normalization (``preprocess_bgr`` with the
    encoder's spec), the encoder's embeddings [B, T, D] into the
    decoder. Returns ``((enc_state, dec_state), history)``, each state
    loadable by ``save_fitted`` under its model's key; ``timings`` gets
    ``data_s`` and ``steps_s`` as ``fit_detector`` fills it."""
    dev = resolve_device(device)
    h, w = enc_model.spec.input_size
    if source_hw is not None and not (source_hw[0] >= h and source_hw[1] >= w):
        raise ValueError(f"fit_action: source_hw {tuple(source_hw)} would "
                         f"enlarge to the encoder's {h}x{w}; the area "
                         "resize only shrinks")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    clips, ys = _temporal_data(enc_model, rng, n_clips, source_hw)
    t1 = time.perf_counter()
    pre = enc_model.preprocess

    def loss_fn(net, clip_u8, y):
        b, t = clip_u8.shape[:2]
        # flax promotes a bfloat16 input against float32 params
        x = preprocess_bgr(clip_u8.reshape((b * t,) + clip_u8.shape[2:])
                           .float(), pre).float()
        emb = net["enc"](x).reshape(b, t, -1).float()
        return _softmax_ce(net["dec"](emb).float(), y.long()).mean()

    # the reference's {"enc", "dec"} tree, as one module
    pair = torch.nn.ModuleDict({"enc": enc_model.module,
                                "dec": dec_model.module})
    state, history = _fit_loop(
        loss_fn, (clips, ys), init_params=pair, steps=steps, batch=batch,
        lr=lr, rng=rng, name="fit_action", device=dev)
    if timings is not None:
        timings.update(data_s=t1 - t0, steps_s=time.perf_counter() - t1)
    enc_state, dec_state = ({k.removeprefix(p): v for k, v in state.items()
                             if k.startswith(p)} for p in ("enc.", "dec."))
    return (enc_state, dec_state), history


#: audio class → tone frequency (Hz); well separated under the 8 kHz
#: Nyquist of the 16 kHz serving rate, mapped onto class slots 0..3
TONE_FREQS = (400.0, 1000.0, 2500.0, 5000.0)


def render_tone_window(
    rng: np.random.Generator, cls: int, n_samples: int,
    sample_rate: float = 16000.0,
) -> np.ndarray:
    """One S16LE window: a sine at the class frequency with random
    phase/amplitude plus noise — amplitude and phase vary so
    FREQUENCY is the only class cue."""
    t = np.arange(n_samples, dtype=np.float64) / sample_rate
    amp = rng.uniform(0.25, 0.8)
    phase = rng.uniform(0, 2 * np.pi)
    x = amp * np.sin(2 * np.pi * TONE_FREQS[cls] * t + phase)
    x = x + rng.normal(0, 0.02, n_samples)
    return np.clip(x * 32767, -32768, 32767).astype(np.int16)


def _audio_data(model, rng: np.random.Generator, n_windows: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """The audio fit's training arrays, drawn from ``rng`` as the
    reference draws them: every window's class first, then the windows
    of the model's sample count. Returns (windows int16 [N, S], classes
    int64 [N])."""
    n_samples = model.spec.input_size[1]
    ys = rng.integers(0, len(TONE_FREQS), size=n_windows)
    xs = np.stack([render_tone_window(rng, int(c), n_samples) for c in ys])
    return xs, ys


def fit_audio(
    model,
    seed: int = 3,
    n_windows: int = 512,
    steps: int = 400,
    batch: int = 32,
    lr: float = 3e-3,
    device: str | torch.device | None = None,
    timings: dict | None = None,
):
    """Fit AclNet to the 4 tone classes on ``device`` (None → the card,
    which must exist) through the serving normalization (int16 /
    32768, as ``engine/steps.py::build_audio_step``). A float32 copy of
    the module is fitted, the model itself is left as it was. Returns
    ``(state_dict, history)`` as ``_fit_loop``; ``timings`` gets
    ``data_s`` and ``steps_s`` as ``fit_detector`` fills it."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    xs, ys = _audio_data(model, rng, n_windows)
    t1 = time.perf_counter()

    def loss_fn(net, win_i16, y):
        return _softmax_ce(net(win_i16.float() / 32768.0).float(), y).mean()

    state, history = _fit_loop(
        loss_fn, (xs, ys), init_params=model.module, steps=steps,
        batch=batch, lr=lr, rng=rng, name="fit_audio", device=dev)
    if timings is not None:
        timings.update(data_s=t1 - t0, steps_s=time.perf_counter() - t1)
    return state, history


def save_fitted(params: dict[str, torch.Tensor], key: str,
                models_dir: str | Path, precision: str = "FP32") -> Path:
    """Write fitted weights into the registry layout,
    ``<models_dir>/<key>/<precision>/weights.msgpack``, as the bytes
    flax's ``to_bytes`` writes for the same params: a zoo ``state_dict``
    as its nested flax tree (``params_to_msgpack``), an IR's flat dict
    as it is (``flat_to_msgpack``; an IR's names are sanitized, so none
    holds a dot, where every zoo module's ``state_dict`` has dotted
    names). Beside an IR's ``.xml`` the file overrides its ``.bin``
    weights."""
    path = Path(models_dir) / key / precision / "weights.msgpack"
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = not any("." in k for k in params)
    path.write_bytes(flat_to_msgpack(params) if flat
                     else params_to_msgpack(params))
    return path


def unpack_rows(packed: np.ndarray) -> list[dict]:
    """Packed NMS rows [K, 7(+)] → [{box, score, label_id}] (valid only)."""
    out = []
    for row in np.asarray(packed):
        if row[6] <= 0.5:
            continue
        out.append({"box": row[:4].astype(np.float32),
                    "score": float(row[4]), "label_id": int(row[5])})
    return out


def evaluate_packed(
    packed: np.ndarray,
    scenes: list[Scene],
    iou_thresh: float = 0.5,
) -> dict:
    """Score packed detections [B, K, 7+] against scene ground truth.

    A GT box counts recovered iff some valid detection has IoU ≥
    iou_thresh AND the right label. Returns recall / precision /
    per-miss detail.
    """
    tp, n_gt, n_det = 0, 0, 0
    misses = []
    for scene, rows in zip(scenes, packed):
        dets = unpack_rows(rows)
        n_det += len(dets)
        n_gt += len(scene.boxes)
        used = set()
        for gt_box, gt_label in zip(scene.boxes, scene.labels):
            hit = None
            for i, d in enumerate(dets):
                if i in used or d["label_id"] != int(gt_label):
                    continue
                if _pairwise_iou(d["box"][None], gt_box[None])[0, 0] >= iou_thresh:
                    hit = i
                    break
            if hit is None:
                misses.append({"label": int(gt_label),
                               "box": gt_box.tolist()})
            else:
                used.add(hit)
                tp += 1
    return {
        "recall": tp / max(n_gt, 1),
        "precision": tp / max(n_det, 1),
        "gt": n_gt, "detections": n_det, "misses": misses,
    }


# ------------------------------------------------- the serving chain

#: published label → id (labels.PERSON_VEHICLE_BIKE, background 0): how
#: a published object's ``detection.label`` is read back as a class
LABEL_IDS = {"person": 1, "vehicle": 2, "bike": 3}


def holdout_scenes(n: int = 8, hw: tuple[int, int] = (1080, 1920),
                   seed: int = 99) -> list[Scene]:
    """``n`` scenes at ``hw`` from ``default_rng(seed)``: the reference
    test's held-out scenes (seed 99 for the wire and served checks, 123
    for EII, 321 for the zone count)."""
    rng = np.random.default_rng(seed)
    return [render_scene(rng, hw=hw) for _ in range(n)]


def recovered(dets, scene: Scene, iou: float = 0.5) -> tuple[int, int]:
    """(hits, ground-truth boxes) of ``scene`` matched by ``dets`` =
    [(x0, y0, x1, y1, label_id), ...] normalized corners: a box counts
    once some detection of its label overlaps it at IoU ≥ ``iou``
    (greedy per ground-truth box) — the rule every published-metadata
    check shares."""
    hits = 0
    for gt_box, gt_label in zip(scene.boxes, scene.labels):
        for x0, y0, x1, y1, lid in dets:
            det = np.asarray([[x0, y0, x1, y1]], np.float32)
            if (lid == int(gt_label)
                    and _pairwise_iou(det, gt_box[None])[0, 0] >= iou):
                hits += 1
                break
    return hits, len(scene.boxes)


def render_crossing_frames(n: int = 14, hw: tuple[int, int] = (1080, 1920)
                           ) -> tuple[list[np.ndarray], list[tuple]]:
    """A vehicle translating left → right over one textured background:
    its box (height 0.30 at y 0.45, the vehicle's class aspect) moves
    from x0 = 0.02 to 0.33 in ``n`` even steps, so its bottom-centre
    anchor sweeps 0.35 → 0.66 and crosses x = 0.5 mid-sequence. Returns
    (``n`` BGR frames, their normalized ground-truth boxes)."""
    h, w = hw
    rng = np.random.default_rng(5)
    color, aspect = CLASS_STYLES[2]
    bh_n = 0.30
    bw_n = min(bh_n * aspect, 0.9)  # the aspect the detector was fit on
    y0_n = 0.45
    frames, boxes = [], []
    bg = _textured_bg(rng, h, w)
    for t in range(n):
        # ~46 px a frame at 1920: far more than a box's jitter, so a
        # re-crossing is rare; x0 stops at 0.33 so the box stays whole
        x0_n = 0.02 + (0.33 - 0.02) * t / (n - 1)
        f = bg.copy()
        xi, yi = int(x0_n * w), int(y0_n * h)
        xe, ye = int((x0_n + bw_n) * w), int((y0_n + bh_n) * h)
        _draw_object(f, xi, yi, xe, ye, color)
        frames.append(f)
        boxes.append((x0_n, y0_n, x0_n + bw_n, y0_n + bh_n))
    return frames, boxes
