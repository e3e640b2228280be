"""RetinaFace's training step, plainly, in float32.

The objective the configuration states (``loss`` and ``optimizer`` of
``configs/retinaface-r50-train-640.json``):

* input: the image letterboxed onto a gray-128 canvas
  (``detect.letterbox``) minus the mean (104, 117, 123) in its channel
  order; annotation boxes clipped to the image and mapped through the
  same letterbox to [0, 1] canvas coordinates, landmarks likewise (-1
  stays -1); the first ``max_gt`` faces of an image;
* matching (SSD): each prior takes the face of highest IoU, positive at
  ``match_iou`` or above; each face claims its best prior (of several
  claims on one prior, the later face); regression targets by the
  centre-variance encoding; label 1 for a face with five landmarks, -1
  without, 0 background;
* loss, per image then averaged over the batch: ``loc_weight`` x smooth-L1
  of the boxes over positives / positives, cross-entropy over positives
  and the ``neg_pos_ratio`` x positives negatives of highest loss (ties:
  lower prior first) / positives, smooth-L1 of the landmarks over
  positives with landmarks / their count;
* SGD: ``d = g + weight_decay * p``, momentum buffer ``d`` at the first
  step and ``momentum * buf + d`` after, ``p -= lr * buf``.

Batch norm normalises by the batch's statistics (training mode).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference.detect import FACE_MEAN, letterbox, letterbox_geometry


def example(image: np.ndarray, ann: np.ndarray, input_hw, max_gt: int, device):
    """One image (H, W, 3) uint8 and its (N, 14) pixel rows -> the (3, h, w)
    input and (G, 14) normalized ground truth, G <= max_gt."""
    ih, iw = image.shape[:2]
    h, w = input_hw
    x = letterbox(torch.from_numpy(image)[None].to(device), input_hw, 128.0)[0]
    x = x - torch.tensor(FACE_MEAN, device=device).view(3, 1, 1)
    nh, nw, top, left = letterbox_geometry((ih, iw), input_hw)
    g = np.asarray(ann, np.float64).copy()[:max_gt]
    g[:, [0, 2]] = np.clip(g[:, [0, 2]], 0, iw)
    g[:, [1, 3]] = np.clip(g[:, [1, 3]], 0, ih)
    unset = g[:, 4:] < 0
    xs, ys = [0, 2, 4, 6, 8, 10, 12], [1, 3, 5, 7, 9, 11, 13]
    g[:, xs] = (g[:, xs] * (nw / iw) + left) / w
    g[:, ys] = (g[:, ys] * (nh / ih) + top) / h
    g[:, 4:][unset] = -1.0
    return x, torch.tensor(g, dtype=torch.float32, device=device)


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda x: (x[:, 2:] - x[:, :2]).clamp(min=0).prod(-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter).clamp(min=1e-6)


def match(gt: torch.Tensor, pri: torch.Tensor, threshold: float, var) -> Tuple[torch.Tensor, ...]:
    """(G, 14) ground truth, (A, 4) priors -> loc_t (A, 4), landm_t (A, 10),
    labels (A,)."""
    a = pri.shape[0]
    if gt.shape[0] == 0:
        z = torch.zeros
        return z(a, 4, device=pri.device), z(a, 10, device=pri.device), torch.zeros(
            a, dtype=torch.long, device=pri.device)
    pxy = torch.cat([pri[:, :2] - pri[:, 2:] / 2, pri[:, :2] + pri[:, 2:] / 2], 1)
    iou = _iou(pxy, gt[:, :4])  # (A, G)
    best_iou, best_gt = iou.max(1)
    assigned = best_gt.clone()
    positive = best_iou >= threshold
    best_prior = iou.argmax(0)
    for g in range(gt.shape[0]):  # the later face wins a shared prior
        assigned[best_prior[g]] = g
        positive[best_prior[g]] = True
    m = gt[assigned]
    c = (m[:, :2] + m[:, 2:4]) / 2
    wh = (m[:, 2:4] - m[:, :2]).clamp(min=1e-6)
    loc_t = torch.cat([(c - pri[:, :2]) / (var[0] * pri[:, 2:]),
                       torch.log(wh / pri[:, 2:]) / var[1]], 1)
    pts = m[:, 4:].clamp(min=0).view(a, 5, 2)
    landm_t = ((pts - pri[:, None, :2]) / (var[0] * pri[:, None, 2:])).reshape(a, 10)
    has_landm = (m[:, 4:].view(a, 5, 2)[..., 0] >= 0).all(1)
    labels = torch.where(positive, torch.where(has_landm, 1, -1), 0)
    return loc_t, landm_t, labels


def smooth_l1(d: torch.Tensor) -> torch.Tensor:
    d = d.abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def multibox_loss(loc, cls, landm, loc_t, landm_t, labels, loss_cfg: Dict):
    """(total, {"loss_loc", "loss_cls", "loss_landm"}: each term's batch mean)."""
    pos = labels != 0
    npos = pos.sum(1).clamp(min=1)
    loss_loc = (smooth_l1(loc - loc_t).sum(-1) * pos).sum(1) / npos
    wl = labels == 1
    loss_landm = (smooth_l1(landm - landm_t).sum(-1) * wl).sum(1) / wl.sum(1).clamp(min=1)
    ce = -torch.log_softmax(cls.float(), -1).gather(-1, pos.long()[..., None])[..., 0]
    neg_ce = torch.where(pos, torch.full_like(ce, -float("inf")), ce)
    order = torch.sort(neg_ce, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    nneg = (loss_cfg["neg_pos_ratio"] * npos).long().clamp(max=labels.shape[1] - 1)
    selected = pos | (rank < nneg[:, None])
    loss_cls = (ce * selected).sum(1) / npos
    total = (loss_cfg["loc_weight"] * loss_loc + loss_cls + loss_landm).mean()
    return total, {"loss_loc": loss_loc.mean(), "loss_cls": loss_cls.mean(),
                   "loss_landm": loss_landm.mean()}


def sgd_step(params: List[torch.Tensor], bufs: List, lr: float, momentum: float, wd: float):
    with torch.no_grad():
        for i, p in enumerate(params):
            d = p.grad + wd * p
            bufs[i] = d.clone() if bufs[i] is None else momentum * bufs[i] + d
            p -= lr * bufs[i]
