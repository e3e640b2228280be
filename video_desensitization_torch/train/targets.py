"""Anchor-target assignment for multibox training (shape-static).

The inverse of ``ops.boxes.decode_boxes`` / ``decode_landmarks`` with
SSD-style matching: each anchor takes the ground-truth box of highest IoU
(positive above a threshold), and every ground-truth box claims its best
anchor. Ground truth is padded to a fixed count with a validity mask.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from video_desensitization_torch.ops.boxes import DEFAULT_VARIANCES, pairwise_iou


def _priors_xyxy(priors: torch.Tensor) -> torch.Tensor:
    c, s = priors[..., :2], priors[..., 2:]
    return torch.cat([c - s / 2, c + s / 2], dim=-1)


def encode_boxes(
    matched: torch.Tensor, priors: torch.Tensor,
    variances: Sequence[float] = DEFAULT_VARIANCES,
) -> torch.Tensor:
    """xyxy ground truth -> regression targets against priors."""
    g_c = (matched[..., :2] + matched[..., 2:]) / 2
    g_wh = torch.clamp(matched[..., 2:] - matched[..., :2], min=1e-6)
    t_c = (g_c - priors[..., :2]) / (variances[0] * priors[..., 2:])
    t_wh = torch.log(g_wh / priors[..., 2:]) / variances[1]
    return torch.cat([t_c, t_wh], dim=-1)


def encode_landmarks(
    matched: torch.Tensor, priors: torch.Tensor,
    variances: Sequence[float] = DEFAULT_VARIANCES,
) -> torch.Tensor:
    """(..., 10) landmark points -> regression targets."""
    pts = matched.reshape(*matched.shape[:-1], 5, 2)
    t = (pts - priors[..., None, :2]) / (variances[0] * priors[..., None, 2:])
    return t.reshape(matched.shape)


def match_anchors(
    gt_boxes: torch.Tensor,
    gt_landms: torch.Tensor,
    gt_valid: torch.Tensor,
    priors: torch.Tensor,
    iou_threshold: float = 0.35,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assign each anchor a target.

    gt_boxes: (G, 4) xyxy normalized (padded); gt_landms: (G, 10) with -1 for
    faces without annotated landmarks; gt_valid: (G,) bool. priors: (A, 4).
    Returns (loc_targets (A, 4), landm_targets (A, 10), labels (A,) int32)
    where labels: 0 background, 1 face, and -1 marks positives without
    landmark supervision.

    Where several ground truths claim one anchor, the last of them in
    ground-truth order wins, as the JAX package's scatter does on the CPU;
    a padded ground truth (IoU -1 everywhere) claims anchor 0, so a valid
    face whose best anchor is 0 loses its force-match to the padding after
    it. The winner is the largest claiming index (a deterministic
    ``scatter_reduce``), never a scatter with duplicate indices.
    """
    a_xyxy = _priors_xyxy(priors)
    iou = pairwise_iou(a_xyxy, gt_boxes)  # (A, G)
    iou = torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))

    best_gt = torch.argmax(iou, dim=1)  # (A,), first of equal maxima
    best_gt_iou = torch.amax(iou, dim=1)

    # Force-match: each ground truth claims its best anchor.
    best_anchor = torch.argmax(iou, dim=0)  # (G,)
    g = gt_boxes.shape[0]
    claims = torch.arange(g, device=iou.device)
    winner = torch.full((priors.shape[0],), -1, dtype=torch.int64, device=iou.device)
    winner = winner.scatter_reduce(0, best_anchor, claims, reduce="amax")
    forced_gt = torch.clamp(winner, min=0)
    forced = (winner >= 0) & gt_valid[forced_gt]
    assigned_gt = torch.where(forced, forced_gt, best_gt)
    positive = forced | (best_gt_iou >= iou_threshold)

    matched_boxes = gt_boxes[assigned_gt]
    matched_landms = gt_landms[assigned_gt]
    loc_t = encode_boxes(matched_boxes, priors)
    landm_t = encode_landmarks(torch.clamp(matched_landms, min=0.0), priors)

    has_landm = torch.all(matched_landms.reshape(-1, 5, 2)[..., 0] >= 0, dim=-1)
    labels = torch.where(positive, torch.where(has_landm, 1, -1), 0).to(torch.int32)
    return loc_t, landm_t, labels
