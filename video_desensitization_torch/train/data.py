"""Training data: WIDER-face labels -> encoded anchor-target batches.

* ``load_retinaface_labels`` parses the retinaface ``label.txt`` format
  (``# <path>`` header lines; one face per line: ``x y w h`` + 5 landmark
  (x, y, visibility) triplets). Plain detection-only WIDER files (no
  landmarks) also parse; landmarks then come back as -1 (loss-masked).
* ``encode_example`` letterboxes an image and its annotations to the model
  input, subtracts the mean, pads the ground truth to a fixed count and runs
  the anchor matcher (``train/targets.py``) on the encoder's device.
* ``batch_iterator`` yields one shuffled epoch of ready train batches
  ``{"images" (B, 3, H, W), "loc_t", "landm_t", "labels"}`` as numpy.
* ``multistep_lr`` is the classic SGD schedule (warmup + milestone decays)
  as a plain ``step -> lr`` function.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from video_desensitization_torch import resolve_device
from video_desensitization_torch.ops.image import BGR_MEAN, letterbox_params
from video_desensitization_torch.train.targets import match_anchors


def load_retinaface_labels(txt_path: str) -> Dict[str, np.ndarray]:
    """Parse a retinaface-style label.txt.

    Returns {relative_image_path: (N, 14) float64} rows =
    [x1, y1, x2, y2, lm_x1, lm_y1, ..., lm_x5, lm_y5] with landmark
    coordinates -1 when unannotated. Accepts 4-field (boxes only),
    14/15-field (x y w h + 5*(x, y) [+ conf]) and 19/20-field
    (x y w h + 5*(x, y, vis) [+ conf]) face lines.
    """
    out: Dict[str, np.ndarray] = {}
    path = None
    rows: List[List[float]] = []

    def flush():
        if path is not None:
            out[path] = np.asarray(rows, np.float64).reshape(-1, 14)

    with open(txt_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                flush()
                path = line[1:].strip()
                rows = []
                continue
            vals = [float(v) for v in line.split()]
            x, y, w, h = vals[:4]
            if w <= 0 or h <= 0:
                continue
            box = [x, y, x + w, y + h]
            lm = [-1.0] * 10
            rest = vals[4:]
            if len(rest) >= 15:  # 5 x (x, y, visibility) triplets
                pts = [(rest[i * 3], rest[i * 3 + 1]) for i in range(5)]
            elif len(rest) >= 10:  # 5 x (x, y) pairs
                pts = [(rest[i * 2], rest[i * 2 + 1]) for i in range(5)]
            else:
                pts = None
            if pts is not None and all(px >= 0 for px, _ in pts):
                lm = [c for p in pts for c in p]
            rows.append(box + lm)
    flush()
    return out


def _letterbox_annotations(
    ann: np.ndarray, src_hw: Tuple[int, int], dst_hw: Tuple[int, int]
) -> np.ndarray:
    """Map pixel-space (N, 14) annotations through the letterbox transform
    into normalized [0, 1] coordinates of the dst canvas."""
    ih, iw = src_hw
    h, w = dst_hw
    nh, nw, top, left = letterbox_params((ih, iw), (h, w))
    sx, sy = nw / iw, nh / ih
    out = ann.astype(np.float64).copy()
    # Box corners of partially-out-of-frame faces can be legitimately
    # negative (or beyond the image): clip them into the frame rather than
    # treat them as the landmark sentinel.
    out[:, [0, 2]] = np.clip(out[:, [0, 2]], 0, iw)
    out[:, [1, 3]] = np.clip(out[:, [1, 3]], 0, ih)
    xs = [0, 2, 4, 6, 8, 10, 12]
    ys = [1, 3, 5, 7, 9, 11, 13]
    neg = out[:, 4:] < 0  # unannotated landmarks stay -1 (sentinel)
    out[:, xs] = (out[:, xs] * sx + left) / w
    out[:, ys] = (out[:, ys] * sy + top) / h
    out[:, 4:][neg] = -1.0
    return out


class TargetEncoder:
    """The anchor matcher for one input geometry, on ``device`` (``cuda``
    unless the caller passes ``"cpu"``)."""

    def __init__(self, anchors: np.ndarray, max_gt: int = 64, device=None):
        self.device = resolve_device(device)
        self.anchors = torch.tensor(np.asarray(anchors, np.float32), device=self.device)
        self.max_gt = max_gt

    def __call__(self, ann_norm: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(N, 14) normalized annotations -> (loc_t, landm_t, labels)."""
        g = np.full((self.max_gt, 14), -1.0, np.float32)
        n = min(len(ann_norm), self.max_gt)
        g[:n] = ann_norm[:n]
        valid = np.zeros(self.max_gt, bool)
        valid[:n] = True
        g = torch.from_numpy(g).to(self.device)
        out = match_anchors(g[:, :4], g[:, 4:], torch.from_numpy(valid).to(self.device),
                            self.anchors)
        return tuple(t.cpu().numpy() for t in out)


def encode_example(
    image: np.ndarray,
    ann: np.ndarray,
    input_hw: Tuple[int, int],
    encoder: TargetEncoder,
):
    """HWC uint8 image + (N, 14) pixel annotations -> one train example:
    the (3, H, W) float32 input and its (loc_t, landm_t, labels)."""
    from video_desensitization_torch.pipeline.throughput import letterbox_u8

    ih, iw = image.shape[:2]
    # The inference path's letterbox (geometry and gray fill), so train and
    # inference see the same inputs.
    canvas = letterbox_u8(image, input_hw)
    x = canvas.astype(np.float32) - np.asarray(BGR_MEAN, np.float32)
    loc_t, landm_t, labels = encoder(_letterbox_annotations(ann, (ih, iw), input_hw))
    return np.ascontiguousarray(x.transpose(2, 0, 1)), loc_t, landm_t, labels


def batch_iterator(
    labels: Dict[str, np.ndarray],
    images_root: str,
    input_hw: Tuple[int, int],
    anchors: np.ndarray,
    batch_size: int = 16,
    max_gt: int = 64,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    device=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of ready train batches, shuffled by
    ``np.random.default_rng(seed)``; targets are matched on ``device``."""
    import cv2

    encoder = TargetEncoder(anchors, max_gt=max_gt, device=device)
    keys = sorted(labels)
    order = np.arange(len(keys))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    buf: List[Tuple[np.ndarray, ...]] = []

    def stacked():
        return {name: np.stack(col) for name, col in
                zip(("images", "loc_t", "landm_t", "labels"), zip(*buf))}

    for idx in order:
        key = keys[idx]
        img = cv2.imread(os.path.join(images_root, key))
        if img is None:
            continue
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        buf.append(encode_example(img, labels[key], input_hw, encoder))
        if len(buf) == batch_size:
            yield stacked()
            buf = []
    if buf and not drop_remainder:
        yield stacked()


def multistep_lr(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float = 0.1,
    warmup_steps: int = 0,
) -> Callable[[int], float]:
    """Classic detector schedule: linear warmup from 0, then step decays.

    ``milestones`` are global step counts, as in the JAX package's optax
    schedule: after warmup the decays count from the warmup's end with each
    boundary at ``max(1, milestone - warmup_steps)`` (boundaries that land
    on the same step decay once), and a decay applies from its boundary on.
    """
    boundaries = sorted({int(m) if warmup_steps <= 0 else max(1, int(m) - warmup_steps)
                         for m in milestones})

    def decayed(count: int) -> float:
        lr = base_lr
        for b in boundaries:
            if count >= b:
                lr = gamma * lr
        return lr

    if warmup_steps <= 0:
        return decayed

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1 - max(step, 0) / warmup_steps
            return -base_lr * frac + base_lr
        return decayed(step - warmup_steps)

    return schedule
