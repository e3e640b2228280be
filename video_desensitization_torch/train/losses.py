"""Multibox loss with hard negative mining (the public RetinaFace objective)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def hard_negatives(
    ce: torch.Tensor, positive: torch.Tensor, num_pos: torch.Tensor, neg_pos_ratio: float
) -> torch.Tensor:
    """(B, A) mask of the ``neg_pos_ratio * num_pos`` negatives of highest
    loss ``ce`` per image. Both sorts are stable (``jnp.argsort``'s
    default), so of equal losses the lower anchor index is taken."""
    neg_score = torch.where(positive, -torch.inf, ce)
    order = torch.argsort(-neg_score, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)  # rank among negatives
    num_neg = torch.clamp((neg_pos_ratio * num_pos).to(torch.int64), max=positive.shape[1] - 1)
    return rank < num_neg[:, None]


def multibox_loss(
    loc_pred: torch.Tensor,  # (B, A, 4)
    cls_logits: torch.Tensor,  # (B, A, 2)
    landm_pred: torch.Tensor,  # (B, A, 10)
    loc_t: torch.Tensor,
    landm_t: torch.Tensor,
    labels: torch.Tensor,  # (B, A) int32: 0 bg, 1 face+landm, -1 face w/o landm
    neg_pos_ratio: float = 7.0,
    loc_weight: float = 2.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total loss and its terms, in float32."""
    positive = labels != 0  # faces with or without landmarks
    with_landm = labels == 1
    num_pos = torch.clamp(positive.sum(dim=1), min=1)  # (B,)

    # Localization: smooth L1 over positives.
    loc_l = smooth_l1(loc_pred, loc_t).sum(dim=-1)  # (B, A)
    loss_loc = torch.where(positive, loc_l, 0.0).sum(dim=1) / num_pos

    # Landmarks: only positives with landmark annotations.
    num_landm = torch.clamp(with_landm.sum(dim=1), min=1)
    landm_l = smooth_l1(landm_pred, landm_t).sum(dim=-1)
    loss_landm = torch.where(with_landm, landm_l, 0.0).sum(dim=1) / num_landm

    # Classification with hard negative mining: all positives + the
    # neg_pos_ratio hardest negatives per image (by background CE loss).
    logp = torch.log_softmax(cls_logits.to(torch.float32), dim=-1)
    ce = -torch.gather(logp, -1, positive.long()[..., None])[..., 0]  # (B, A)

    selected = positive | hard_negatives(ce, positive, num_pos, neg_pos_ratio)
    loss_cls = torch.where(selected, ce, 0.0).sum(dim=1) / num_pos

    total = torch.mean(loc_weight * loss_loc + loss_cls + loss_landm)
    metrics = {
        "loss": total,
        "loss_loc": loss_loc.mean(),
        "loss_cls": loss_cls.mean(),
        "loss_landm": loss_landm.mean(),
        "num_pos": num_pos.to(torch.float32).mean(),
    }
    return total, metrics
