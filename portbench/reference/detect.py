"""The engine's detection and mosaic, plainly, in float32 (float64 on the host).

What the fused engine computes from one batch of uint8 RGB frames, as the
configuration states it:

* letterbox: scale ``min(w / iw, h / ih)``, content ``int(iw * s) x
  int(ih * s)`` centred on a gray canvas (128 for the face network, 114 for
  the plate network), bilinear with half-pixel centres, rounded to uint8;
* RetinaFace: input canvas minus the mean (104, 117, 123) in the frame's
  channel order; float32 softmax score of class 1; centre-variance decode
  against SSD priors; candidates at or above ``confidence``, the best
  ``max_detections`` of them by score (ties, such as scores that round to
  1.0: lower anchor first), greedy NMS suppressing IoU above ``nms_iou``;
  boxes mapped back through the letterbox to pixels of the frame;
* YOLOv8: canvas / 255; best class's sigmoid score; the same selection and
  NMS with the plate settings, in input pixels; boxes mapped back by the
  inverse letterbox, clipped to the frame;
* mosaic: every kept box, faces (by score) then plates (by score), cut to
  integer pixels toward zero, clipped to the frame, replaced by its
  INTER_NEAREST downscale by ``mosaic_level`` (at least one pixel) and
  INTER_NEAREST upscale back, box after box on the same frame.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FACE_MEAN = (104.0, 117.0, 123.0)


def letterbox_geometry(src_hw, dst_hw):
    ih, iw = src_hw
    h, w = dst_hw
    s = min(w / iw, h / ih)
    nw, nh = int(iw * s), int(ih * s)
    return nh, nw, (h - nh) // 2, (w - nw) // 2


def letterbox(frames: torch.Tensor, dst_hw, pad: float) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, h, w) float32 canvas of uint8 values."""
    b, ih, iw, _ = frames.shape
    nh, nw, top, left = letterbox_geometry((ih, iw), dst_hw)
    x = frames.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
    x = x.round().clamp(0, 255)
    canvas = torch.full((b, 3, *dst_hw), pad, dtype=torch.float32, device=frames.device)
    canvas[:, :, top:top + nh, left:left + nw] = x
    return canvas


def priors(input_hw, min_sizes, steps) -> torch.Tensor:
    """SSD priors [cx, cy, s_kx, s_ky], level by level, row-major, the
    level's sizes innermost (biubug6 ``layers/functions/prior_box.py``)."""
    h, w = input_hw
    out = []
    for sizes, step in zip(min_sizes, steps):
        for i in range(math.ceil(h / step)):
            for j in range(math.ceil(w / step)):
                for m in sizes:
                    out.append([(j + 0.5) * step / w, (i + 0.5) * step / h, m / w, m / h])
    return torch.tensor(out, dtype=torch.float32)


def decode(loc: torch.Tensor, pri: torch.Tensor, var: Sequence[float]) -> torch.Tensor:
    c = pri[..., :2] + loc[..., :2] * var[0] * pri[..., 2:]
    wh = pri[..., 2:] * torch.exp(loc[..., 2:] * var[1])
    xy1 = c - wh / 2
    return torch.cat([xy1, xy1 + wh], -1)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, conf: float, iou: float,
               top_k: int) -> np.ndarray:
    """Indices kept, best first: candidates ``score >= conf``, the ``top_k``
    best (stable), then greedy suppression of IoU above ``iou``."""
    cand = np.nonzero(scores >= conf)[0]
    cand = cand[np.argsort(-scores[cand], kind="stable")][:top_k]
    ious = pairwise_iou(boxes[cand], boxes[cand])
    keep = np.zeros(len(cand), bool)
    for i in range(len(cand)):
        keep[i] = not np.any(ious[i, :i][keep[:i]] > iou)
    return cand[keep]


def pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.asarray(a, np.float64)[:, :4], np.asarray(b, np.float64)[:, :4]
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), -1)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-12)


def _saturation_margin() -> float:
    """The least margin (logit difference) whose float32 score rounds to
    exactly 1.0: above it scores tie, and the best-by-score selection takes
    the lower anchor."""
    m = torch.linspace(10.0, 30.0, 200001, dtype=torch.float32)
    soft = torch.softmax(torch.stack([torch.zeros_like(m), m], -1), -1)[:, 1]
    both = (soft == 1.0) & (torch.sigmoid(m) == 1.0)
    return float(m[both.nonzero()[0, 0]])


M_SAT = _saturation_margin()


def _selection(margin: np.ndarray, conf: float, top_k: int):
    """Margins capped at ``M_SAT`` and the ``top_k``-th best of the
    candidates (``score >= conf``), or the threshold's margin where there
    are fewer."""
    capped = np.minimum(margin, M_SAT)
    floor = math.log(conf / (1.0 - conf))
    cand = np.sort(capped[margin >= floor])[::-1]
    kth = cand[top_k - 1] if len(cand) >= top_k else floor
    return capped, float(kth)


@torch.no_grad()
def detect_faces(net, frames: torch.Tensor, cfg: Dict) -> List[Dict]:
    """Each frame's face detections: ``kept`` (K, 5) float64 [x1, y1, x2, y2,
    score] in pixels of the frame, best first; ``boxes`` every prior's box
    in those pixels and ``margin`` its class margin (capped at ``M_SAT``),
    ``kth`` the margin the ``max_detections``-th best candidate has."""
    b, ih, iw, _ = frames.shape
    hw = (cfg["input_size"], cfg["input_size"])
    x = letterbox(frames, hw, 128.0) - torch.tensor(FACE_MEAN, device=frames.device).view(1, 3, 1, 1)
    loc, cls, _ = net(x)
    cls = cls.float()
    score = torch.softmax(cls, -1)[..., 1]
    margin = (cls[..., 1] - cls[..., 0]).double()
    pri = priors(hw, cfg["min_sizes"], cfg["steps"]).to(frames.device)
    boxes = decode(loc.float(), pri, cfg["variance"])  # normalized canvas coordinates
    inp = np.array(hw, np.float64)
    img = np.array([ih, iw], np.float64)
    new = img * np.min(inp / img)
    off = torch.tensor(np.tile(((inp - new) / 2 / inp)[::-1], 2), device=frames.device)
    sc = torch.tensor(np.tile((inp / new)[::-1], 2) * np.tile([iw, ih], 2), device=frames.device)
    out = []
    for bx, sc_, m in zip(boxes, score.cpu().numpy(), margin.cpu().numpy()):
        k = greedy_nms(bx.cpu().numpy(), sc_, cfg["confidence"], cfg["nms_iou"], cfg["max_detections"])
        px = (bx.double() - off) * sc
        capped, kth = _selection(m, cfg["confidence"], cfg["max_detections"])
        kept = px[torch.from_numpy(k).to(px.device)].cpu().numpy()
        out.append({"kept": np.concatenate([kept, sc_[k, None].astype(np.float64)], 1),
                    "boxes": px, "margin": capped, "kth": kth})
    return out


@torch.no_grad()
def detect_plates(net, frames: torch.Tensor, cfg: Dict) -> List[Dict]:
    """Each frame's plate detections, as ``detect_faces`` gives faces."""
    b, ih, iw, _ = frames.shape
    hw = (cfg["input_size"], cfg["input_size"])
    nh, nw, top, left = letterbox_geometry((ih, iw), hw)
    boxes, logits = net(letterbox(frames, hw, 114.0) / 255.0)
    logits = logits.float()
    score = torch.sigmoid(logits).amax(-1)
    margin = logits.amax(-1).double()
    gain = torch.tensor([iw / nw, ih / nh] * 2, dtype=torch.float64, device=frames.device)
    off = torch.tensor([left, top] * 2, dtype=torch.float64, device=frames.device)
    lim = torch.tensor([iw, ih] * 2, dtype=torch.float64, device=frames.device)
    out = []
    for bx, sc_, m in zip(boxes.float(), score.cpu().numpy(), margin.cpu().numpy()):
        k = greedy_nms(bx.cpu().numpy(), sc_, cfg["plate_confidence"], cfg["plate_nms_iou"],
                       cfg["plate_max_detections"])
        px = torch.minimum(torch.clamp((bx.double() - off) * gain, min=0.0), lim)
        capped, kth = _selection(m, cfg["plate_confidence"], cfg["plate_max_detections"])
        kept = px[torch.from_numpy(k).to(px.device)].cpu().numpy()
        out.append({"kept": np.concatenate([kept, sc_[k, None].astype(np.float64)], 1),
                    "boxes": px, "margin": capped, "kth": kth})
    return out


def judge_boxes(ours: np.ndarray, ref: Dict, tie: float = 0.05):
    """Each of ``ours`` (K, 4) pixel boxes against the reference's
    candidates of one frame: the prior whose box is nearest (widest
    coordinate gap over that box's longer side) gives its gap; of the
    priors within ``tie`` of that gap (another prior's box can lie as near
    as rounding moves a box, and boxes clipped to the frame can coincide),
    the best margin, and how far it lies below the ``kth`` best one (0 when
    above). Returns (gaps, shortfalls) as float64 arrays."""
    if len(ours) == 0:
        return np.zeros(0), np.zeros(0)
    theirs = ref["boxes"]
    o = torch.as_tensor(np.asarray(ours, np.float64), device=theirs.device)
    longer = torch.clamp(torch.maximum(theirs[:, 2] - theirs[:, 0], theirs[:, 3] - theirs[:, 1]),
                         min=1.0)
    dist = ((o[:, None, :] - theirs[None, :, :]).abs().amax(-1) / longer[None, :])
    best = dist.min(1).values
    margin = torch.as_tensor(ref["margin"], device=theirs.device)
    near = torch.where(dist <= best[:, None] + tie, margin[None, :],
                       torch.full_like(dist, -float("inf"))).amax(1)
    return best.cpu().numpy(), np.maximum(ref["kth"] - near.cpu().numpy(), 0.0)


def describe_worst(ours: np.ndarray, ref: Dict, tie: float = 0.05) -> Dict:
    """For the record of a run: the box of ``ours`` that falls furthest
    below the reference's selection, its nearest priors and their margins."""
    gap, short = judge_boxes(ours, ref, tie)
    i = int(np.argmax(short))
    theirs = ref["boxes"]
    o = torch.as_tensor(np.asarray(ours, np.float64)[i], device=theirs.device)
    longer = torch.clamp(torch.maximum(theirs[:, 2] - theirs[:, 0], theirs[:, 3] - theirs[:, 1]),
                         min=1.0)
    dist = (o[None, :] - theirs).abs().amax(-1) / longer
    order = torch.argsort(dist)[:3].cpu().numpy()
    return {"box": [round(float(v), 2) for v in np.asarray(ours)[i]], "shortfall": float(short[i]),
            "kth": ref["kth"], "nearest": [(int(a), float(dist[a]), float(ref["margin"][a]),
                                            [round(float(v), 2) for v in theirs[a].tolist()])
                                           for a in order]}


def _nearest_map(dst: int, src: int) -> np.ndarray:
    """OpenCV INTER_NEAREST source index of each destination index."""
    scale = 1.0 / (np.float64(dst) / np.float64(src))
    return np.minimum(np.floor(np.arange(dst, dtype=np.float64) * scale).astype(np.int64), src - 1)


def mosaic_(frame: torch.Tensor, boxes, level: int) -> torch.Tensor:
    """Pixelate ``frame`` (H, W, C), a tensor on any device, in place, box
    after box; boxes (K, 4) float pixel xyxy, cut toward zero."""
    h, w = frame.shape[:2]
    for x1, y1, x2, y2 in np.trunc(np.asarray(boxes, np.float64)).astype(np.int64).reshape(-1, 4):
        x1, x2 = min(max(x1, 0), w), min(max(x2, 0), w)
        y1, y2 = min(max(y1, 0), h), min(max(y2, 0), h)
        bw, bh = x2 - x1, y2 - y1
        if bw <= 0 or bh <= 0:
            continue
        sw, sh = max(1, bw // level), max(1, bh // level)
        rows = torch.from_numpy(_nearest_map(sh, bh)[_nearest_map(bh, sh)]).to(frame.device)
        cols = torch.from_numpy(_nearest_map(sw, bw)[_nearest_map(bw, sw)]).to(frame.device)
        region = frame[y1:y2, x1:x2]
        frame[y1:y2, x1:x2] = region.index_select(0, rows).index_select(1, cols)
    return frame


def match_boxes(a: np.ndarray, b: np.ndarray, min_iou: float) -> List[Tuple[int, int]]:
    """Greedy one-to-one pairs of xyxy boxes, highest IoU first, at least
    ``min_iou``."""
    if len(a) == 0 or len(b) == 0:
        return []
    iou = pairwise_iou(a, b)
    ii, jj = np.nonzero(iou >= min_iou)
    order = np.argsort(-iou[ii, jj], kind="stable")
    pairs, used_a, used_b = [], set(), set()
    for i, j in zip(ii[order].tolist(), jj[order].tolist()):
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        pairs.append((i, j))
    return pairs


def set_gap(ours: np.ndarray, theirs: np.ndarray, iou: float) -> int:
    """Boxes of either side that no box of the other side overlaps by more
    than ``iou`` (the NMS threshold: a box the other side's NMS kept in
    its place overlaps it so)."""
    if len(ours) == 0 or len(theirs) == 0:
        return len(ours) + len(theirs)
    m = pairwise_iou(ours, theirs) > iou
    return int((~m.any(1)).sum() + (~m.any(0)).sum())
