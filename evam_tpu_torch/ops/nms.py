"""Fixed-shape class-aware NMS (counterpart of ``evam_tpu/ops/nms.py``).

Shapes are static — top-k, then an O(K²) suppression matrix settled by
Jacobi fixpoint steps — so the step never syncs with the host. The
reference's ``vmap`` over frames is a batch dimension written out here.

Port notes:

* ``jax.lax.top_k`` puts the lower index first among tied scores;
  ``torch.topk`` does not promise that. The port selects with a stable
  descending sort, which does.
* ``EVAM_NMS=while`` (default) is the reference's convergence-checked
  loop, capped at ``k`` iterations. A settled ``keep`` never moves
  again, so exactly ``k`` updates give the same answer without testing
  convergence — a test on the card would cost a host sync per
  iteration. ``EVAM_NMS=unroll`` runs ``EVAM_NMS_ITERS`` updates, exact
  only for suppression chains of depth ≤ ITERS + 1, as in the reference.
"""

from __future__ import annotations

import os as _os

import torch

from evam_tpu_torch.ops.boxes import iou_matrix

SETTLE = _os.environ.get("EVAM_NMS", "while")
UNROLL_ITERS = int(_os.environ.get("EVAM_NMS_ITERS", "8"))


def nms_batch(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    max_outputs: int,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Class-aware NMS for a batch of frames.

    boxes [B,N,4] corners, scores [B,N], labels [B,N] int.
    Returns (boxes [B,K,4], scores [B,K], labels [B,K] int32,
    valid [B,K] bool), K = max_outputs, score-sorted, invalid slots
    zeroed (labels -1).
    """
    bsz, n = scores.shape
    k = min(max_outputs, n)
    scores = torch.where(scores >= score_threshold, scores,
                         torch.full_like(scores, -1.0))
    top_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(bsz, k, 4))
    top_labels = torch.gather(labels, 1, idx)

    iou = iou_matrix(top_boxes, top_boxes)
    same_class = top_labels[:, :, None] == top_labels[:, None, :]
    # higher[i,j] = box j ranks above i (strictly better score slot)
    ar = torch.arange(k, device=boxes.device)
    higher = ar[None, :] < ar[:, None]
    suppressed_by = (iou > iou_threshold) & same_class & higher

    # settle so a suppressed box cannot itself suppress (sequential
    # NMS semantics)
    keep = ~torch.any(suppressed_by, dim=2)
    iters = UNROLL_ITERS if SETTLE == "unroll" else k
    for _ in range(iters):
        keep = ~torch.any(suppressed_by & keep[:, None, :], dim=2)

    valid = keep & (top_scores > 0.0)
    # compact valid detections to the front, preserving score order
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    valid = torch.gather(valid, 1, order)
    top_boxes = (torch.gather(top_boxes, 1, order[..., None].expand(bsz, k, 4))
                 * valid[..., None])
    top_scores = torch.gather(top_scores, 1, order) * valid
    top_labels = torch.where(valid, torch.gather(top_labels, 1, order),
                             torch.full_like(top_labels, -1)).to(torch.int32)

    if k < max_outputs:
        pad = max_outputs - k
        top_boxes = torch.nn.functional.pad(top_boxes, (0, 0, 0, pad))
        top_scores = torch.nn.functional.pad(top_scores, (0, pad))
        top_labels = torch.nn.functional.pad(top_labels, (0, pad), value=-1)
        valid = torch.nn.functional.pad(valid, (0, pad))
    return top_boxes, top_scores, top_labels, valid


def nms_single(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    max_outputs: int,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One frame: boxes [N,4], scores [N], labels [N] → [K,...] results."""
    out = nms_batch(boxes[None], scores[None], labels[None], max_outputs,
                    iou_threshold, score_threshold)
    return tuple(t[0] for t in out)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_outputs: int = 32,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.3,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-class NMS over a batch.

    boxes [B, A, 4]; scores [B, A, C] per class (class 0 = background,
    excluded). Each anchor contributes its best foreground class.
    Returns boxes [B,K,4], scores [B,K], labels [B,K], valid [B,K].
    """
    fg = scores[..., 1:]
    best_scores = torch.amax(fg, dim=-1)
    # argmax returns the first maximal index, as jnp.argmax does
    best_labels = torch.argmax(fg, dim=-1).to(torch.int32) + 1
    return nms_batch(boxes, best_scores, best_labels, max_outputs,
                     iou_threshold, score_threshold)
