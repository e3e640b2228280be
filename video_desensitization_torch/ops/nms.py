"""Shape-static greedy NMS over padded batches.

1. ``scores >= conf`` marks valid candidates (no compaction);
2. a stable descending sort picks the K best (ties keep the lower index
   first, padded ``-inf`` rows included);
3. greedy suppression with strict ``IoU > thr`` is solved as the fixpoint
   of ``keep[i] = valid[i] and not any(j < i, keep[j], iou[j, i] > thr)``,
   iterated from ``keep = valid``; it converges to exactly the greedy
   answer after (suppression-chain depth + 1) rounds.

Each round's convergence test reads one flag on the host, so on CUDA every
round costs one device-to-host synchronisation; each read is a
``nms.flag_read`` span (``utils/timers.py::span``). ``nms_setup`` (steps
1-2 and the suppression matrix) reads nothing on the host, so a CUDA graph
can hold it (``utils/graphs.py``); ``nms_rounds`` iterates step 3.
"""

from __future__ import annotations

from typing import Tuple

import torch

from video_desensitization_torch.ops.boxes import pairwise_iou
from video_desensitization_torch.utils.timers import span


def batched_nms_padded(
    detections: torch.Tensor,
    conf_thres: float = 0.5,
    iou_thres: float = 0.45,
    top_k: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, C) detections ``[x1, y1, x2, y2, score, ...]`` ->
    (dets (B, K, C) sorted by descending score, keep (B, K) bool).
    Rows that are not kept are zeroed and keep their sorted position."""
    return nms_rounds(*nms_setup(detections, conf_thres, iou_thres, top_k))


def nms_setup(
    detections: torch.Tensor,
    conf_thres: float = 0.5,
    iou_thres: float = 0.45,
    top_k: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Steps 1-2 and the suppression matrix, with no host read: (B, N, C)
    detections -> (dets (B, K, C) sorted, valid (B, K), suppresses (B, K, K):
    ``[j, i]`` where j ranks before i and their IoU exceeds ``iou_thres``)."""
    scores = detections[..., 4]
    valid = scores >= conf_thres
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    k = min(top_k, detections.shape[1])
    top_scores, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    dets = torch.gather(
        detections, 1, idx[..., None].expand(-1, -1, detections.shape[-1])
    )
    valid = top_scores > float("-inf")

    iou = pairwise_iou(dets[..., :4], dets[..., :4])  # (B, K, K)
    order = torch.arange(k, device=detections.device)
    sup_mat = (iou > iou_thres) & (order[:, None] < order[None, :])
    return dets, valid, sup_mat


def nms_settings(detector) -> Tuple[float, float, int]:
    """A detector's ``nms_setup`` arguments after the detections: its
    ``confidence``, ``nms_iou`` and ``max_detections``. Its segments pass
    them and key their CUDA graphs by them (``utils/graphs.py``)."""
    return detector.confidence, detector.nms_iou, detector.max_detections


def nms_rounds(
    dets: torch.Tensor, valid: torch.Tensor, sup_mat: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 3 on ``nms_setup``'s outputs, one host read a round ->
    (dets with the rows not kept zeroed, keep)."""
    keep, prev = valid, ~valid
    for _ in range(dets.shape[1]):
        with span("nms.flag_read"):
            changed = bool(torch.any(keep != prev))
        if not changed:
            break
        suppressed = torch.any(sup_mat & keep[:, :, None], dim=1)
        keep, prev = valid & ~suppressed, keep

    dets = torch.where(keep[..., None], dets, torch.zeros_like(dets))
    return dets, keep


def nms_padded(
    detections: torch.Tensor,
    conf_thres: float = 0.5,
    iou_thres: float = 0.45,
    top_k: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-image form: (N, C) -> ((K, C), (K,) bool)."""
    dets, keep = batched_nms_padded(detections[None], conf_thres, iou_thres, top_k)
    return dets[0], keep[0]
