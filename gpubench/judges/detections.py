"""The comparison that decides ``correct`` for detection-row engines.

The program's answers are packed rows, one block a frame: ``[x0, y0,
x1, y1, score, label, valid]`` (and, on the fused engine, the
classifier's per-head probabilities after them). The reference works
out each sampled frame again from its seed and float32 weights, and
the rows are judged by six numbers (five on the detect engine):

``row_gap``
    For every valid row, the distance to the nearest answer the
    reference allows for that frame: over all anchors, the larger of
    the box's widest coordinate gap and the gap between the row's score
    and the reference's probability of the row's label there; the
    widest such distance over the sample. It holds every row's box,
    score and label to the network, decode and softmax. Which anchors
    survive the top-k cut and NMS is held by ``nms_unexplained``,
    ``best_shortfall`` and ``struct_faults``, not by comparing the sets
    of rows: NMS is discontinuous at its IoU threshold, and sound runs
    keep some rows a frame more or fewer than the reference.
``nms_unexplained``
    Anchors that greedy NMS had to serve and the program did not, a
    frame, on the mean over the sample: a suppression too eager, or rows
    lost. The anchors checked are those the program's own top-k cut must
    have held: each valid row is traced to the anchor it was decoded
    from (the nearest by box and score), and every other anchor of the
    row's location whose reference score ties with the row's anchor
    (the configuration's conf heads give a location's slots one score)
    ranked beside it, unless the cut may have fallen among them (the
    frame's lowest served score). Each such anchor that no row serves
    has to be suppressed by a valid row of its label that comes no later
    in score order and overlaps it by more than the IoU threshold less
    :data:`IOU_MARGIN`; one that is not counts. Greedy NMS keeps the
    same rows over these anchors as over the whole top k (an anchor of
    the top k that no kept row's location holds suppresses nothing), so
    a sound program reads 0 but for a box traced to the wrong anchor or
    an overlap within rounding of the threshold, whatever anchors the
    near-equal scores of the seeded heads put at the top.
``best_shortfall``
    How far the program's best served score falls below the reference's
    best foreground probability over all anchors, on the mean over the
    sample: a top-k cut drawn from part of the anchors (one level, say)
    misses the frame's best anchor. A mean, because the scores of the
    seeded heads lie close together at the top and single frames swing
    by their rounding.
``empty_frames``
    Frames answered with no valid row where the reference has two or
    more: a batch's rows left out or lost. Exact: its limit is 0.
``cls_gap`` (fused engine)
    For every classified row, the widest gap between its probabilities
    and the reference classifier's on the crop of the row's own box.
``struct_faults``
    Frames whose rows break the engine's contract: valid rows first, in
    falling score order, above the score floor, labels of foreground
    classes, boxes in the unit square, empty rows zero with label −1;
    no two valid rows of one label overlapping by more than the IoU
    threshold (with :data:`IOU_ROUNDING` of room, the served boxes
    being the boxes NMS compared); on the fused engine the classified
    rows exactly the first ``roi_budget`` valid rows of an allowed
    label, each head summing to one. NMS skipped, or run at a higher
    threshold, serves overlapping rows. An exact comparison: its limit
    is 0.
"""

from __future__ import annotations

import numpy as np
import torch

#: frames the reference works out at once
BLOCK = 16
#: room on the IoU of two served rows: rounding of one IoU formula
#: against another on the same float32 boxes
IOU_ROUNDING = 1e-3
#: room on the overlap by which a served row suppresses an anchor: the
#: anchor's box is the reference's, the row's the program's
IOU_MARGIN = 0.05
#: reference scores this close are one score (a location's tied slots)
TIE = 1e-5
#: scores this close in the program's rows are one score: a float32
#: softmax of the same logits in another order differs in its last bit
SCORE_ROUNDING = 1e-5


def _iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of corner boxes a [N, 4], b [M, 4] (float64)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area = lambda t: np.prod(np.clip(t[:, 2:] - t[:, :2], 0, None), -1)  # noqa: E731
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def _struct_ok(rows: np.ndarray, config: dict, allowed: list[int]) -> bool:
    det = config["detector"]
    valid = rows[:, 6]
    if not np.isin(valid, (0.0, 1.0)).all():
        return False
    n = int(valid.sum())
    if n and not (valid[:n] == 1).all():
        return False
    live, dead = rows[:n], rows[n:]
    if dead.size and not (np.delete(dead, 5, axis=1) == 0).all():
        return False
    if dead.size and not (dead[:, 5] == -1).all():
        return False
    if n > det["max_detections"]:
        return False
    s = live[:, 4]
    if n and (np.diff(s) > 0).any() or (s < det["score_threshold"]).any():
        return False
    lab = live[:, 5]
    if ((lab != np.round(lab)) | (lab < 1) | (lab >= det["num_classes"])).any():
        return False
    bx = live[:, :4]
    if ((bx < 0) | (bx > 1)).any() or (bx[:, 2] < bx[:, 0]).any() \
            or (bx[:, 3] < bx[:, 1]).any():
        return False
    over = _iou_np(bx, bx) > det["iou_threshold"] + IOU_ROUNDING
    if (np.triu(over, 1) & (lab[:, None] == lab[None, :])).any():
        return False
    if not config.get("classifier"):
        return True
    block = rows[:, 7:]
    classified = np.abs(block).sum(1) > 0
    eligible = np.flatnonzero(np.isin(lab, allowed)) if allowed else \
        np.arange(n)
    want = np.zeros(len(rows), bool)
    want[eligible[:config["classifier"]["roi_budget"]]] = True
    if not (classified == want).all():
        return False
    at = 0
    for _, size in config["classifier"]["heads"]:
        head = block[classified, at:at + size]
        if ((head < 0) | (head > 1)).any() or (
                np.abs(head.sum(1) - 1) > 1e-3).any():
            return False
        at += size
    return True


def _iou_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of corner boxes a [N, 4], b [M, 4]."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = torch.clamp(rb - lt, min=0).prod(-1)
    area = lambda t: torch.clamp(t[:, 2:] - t[:, :2], min=0).prod(-1)  # noqa: E731
    return inter / torch.clamp(area(a)[:, None] + area(b)[None, :] - inter,
                               min=1e-12)


def tied_anchors(det: dict, boxes: torch.Tensor, probs: torch.Tensor,
                 anchor: torch.Tensor, box: torch.Tensor,
                 score: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """For one frame's valid rows (the anchors ``anchor`` [n] they were
    traced to, their served boxes, scores and labels): each anchor that
    shares a row's location, ties with the row's anchor in the
    reference and is served by no row, with the best overlap [S] of a
    valid row of its label that comes no later in score order (-1 where
    there is none). An anchor takes the served score of the row whose
    location it shares. Anchors whose score is the frame's lowest served
    one are left out: the top-k cut may fall among them, as the program's
    scores tie exactly across locations (bfloat16 heads give few
    distinct values) and a stable sort then splits a location by anchor
    index. ``boxes`` [A, 4] and ``probs`` [A, C] are the reference's."""
    slots = len(det["aspect_ratios"]) + 1
    fg = probs[:, 1:].amax(-1)
    base = anchor - anchor % slots
    sib = (base[:, None] + torch.arange(slots, device=anchor.device)
           ).reshape(-1)
    named = score.repeat_interleave(slots)
    tied = (fg[sib] - fg[anchor].repeat_interleave(slots)).abs() <= TIE
    keep = tied & ~torch.isin(sib, anchor) & (
        named > score.min() + SCORE_ROUNDING)
    sib, named = sib[keep], named[keep]
    if not sib.numel():
        return torch.zeros(0, device=anchor.device)
    sib, inv = torch.unique(sib, return_inverse=True)
    own = torch.full(sib.shape, -1.0, device=sib.device).scatter_reduce(
        0, inv, named, "amax")
    sib_lab = probs[sib, 1:].argmax(-1) + 1
    may = (lab[None, :] == sib_lab[:, None]) & (
        score[None, :] >= own[:, None] - SCORE_ROUNDING)
    over = _iou_t(boxes[sib], box)
    return torch.where(may, over, torch.full_like(over, -1.0)).amax(1)


def judge(config: dict, ref, params: dict, seeds: np.ndarray,
          rows: np.ndarray, device) -> tuple[dict, dict]:
    """Judge the served ``rows`` [n, K, F] of the frames of ``seeds``
    [n]. Returns (the numbers compared, a summary of what was
    compared)."""
    fused = bool(config.get("classifier"))
    det = config["detector"]
    allowed = ref.allowed_labels(config)
    struct = sum(not _struct_ok(r, config, allowed) for r in rows)
    row_gap = cls_gap = 0.0
    row_sum = cls_sum = 0.0
    served_rows = classified_rows = 0
    empty = count_diff = shortfall = unexplained = checked = 0
    best_gap = 0.0
    for at in range(0, len(seeds), BLOCK):
        s = torch.from_numpy(seeds[at:at + BLOCK].astype(np.int64)).to(device)
        r = torch.from_numpy(rows[at:at + BLOCK]).to(device)
        d = ref.detect(config, params["detector"], ref.wire_of(config, s),
                       None)
        valid = r[..., 6] > 0.5
        lab = r[..., 5].long().clamp(0, config["detector"]["num_classes"] - 1)
        for f in range(r.shape[0]):
            v = valid[f]
            if not v.any():
                continue
            box = r[f, v, :4]
            dist = (d.boxes[f][None] - box[:, None]).abs().amax(-1)
            sgap = (d.probs[f][:, lab[f, v]].T - r[f, v, 4][:, None]).abs()
            gaps, anchor = torch.maximum(dist, sgap).min(-1)
            row_gap = max(row_gap, float(gaps.max()))
            cover = tied_anchors(det, d.boxes[f], d.probs[f], anchor, box,
                                 r[f, v, 4], lab[f, v])
            unexplained += int((cover <= det["iou_threshold"]
                                - IOU_MARGIN).sum())
            checked += int(cover.numel())
            row_sum += float(gaps.sum())
            served_rows += int(v.sum())
        best = d.probs[..., 1:].amax(-1).amax(-1)
        best_gap += float((best - r[:, 0, 4])[valid[:, 0]].sum())
        ref_valid = (d.rows[..., 6] > 0.5).sum(1)
        shortfall += int((ref_valid - valid.sum(1)).sum())
        empty += int(((valid.sum(1) == 0) & (ref_valid >= 2)).sum())
        count_diff = max(count_diff, int((valid.sum(1) - ref_valid)
                                         .abs().max()))
        if fused:
            cls = r[..., 7:]
            on = cls.abs().sum(-1) > 0
            if on.any():
                p = ref.crop_probs(config, params["classifier"], s,
                                   r[..., :4])
                gap = (p - cls).abs()[on]
                cls_gap = max(cls_gap, float(gap.max()))
                cls_sum += float(gap.amax(-1).sum())
                classified_rows += int(on.sum())
    numbers = {"row_gap": row_gap,
               "nms_unexplained": unexplained / max(1, len(seeds)),
               "best_shortfall": best_gap / max(1, len(seeds)),
               "empty_frames": empty, "struct_faults": struct}
    if fused:
        numbers["cls_gap"] = cls_gap
    summary = {"frames": int(len(seeds)), "served_rows": served_rows,
               "row_gap_mean": row_sum / max(1, served_rows),
               "widest_count_difference": count_diff,
               "row_shortfall": shortfall / max(1, len(seeds)),
               "tied_anchors_checked": checked,
               "unexplained_anchors": unexplained,
               "classified_rows": classified_rows}
    if fused:
        summary["cls_gap_mean"] = cls_sum / max(1, classified_rows)
    return numbers, summary
