"""Box and landmark decode, IoU, and letterbox coordinate correction.

All functions are batched over padded (B, K, C) tensors and keep float32
arithmetic in the same operation order as the reference post-processing,
so decoded boxes agree to float32 rounding.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

DEFAULT_VARIANCES: Tuple[float, float] = (0.1, 0.2)


def decode_boxes(
    loc: torch.Tensor, priors: torch.Tensor, variances: Sequence[float] = DEFAULT_VARIANCES
) -> torch.Tensor:
    """Center-variance decode: loc (..., A, 4) against priors (A, 4)
    ``[cx, cy, s_kx, s_ky]`` -> (..., A, 4) normalized xyxy."""
    priors = priors.to(loc.dtype)
    centers = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    xy1 = centers - wh / 2
    xy2 = xy1 + wh
    return torch.cat([xy1, xy2], dim=-1)


def decode_landmarks(
    landm: torch.Tensor, priors: torch.Tensor, variances: Sequence[float] = DEFAULT_VARIANCES
) -> torch.Tensor:
    """5-point landmark decode: (..., A, 10) -> (..., A, 10)."""
    priors = priors.to(landm.dtype)
    a, s = priors[..., :2], priors[..., 2:]
    pts = landm.reshape(*landm.shape[:-1], 5, 2)
    decoded = a[..., None, :] + pts * variances[0] * s[..., None, :]
    return decoded.reshape(landm.shape)


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU between xyxy box sets: (..., M, 4) x (..., N, 4) -> (..., M, N)."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(boxes_a[..., 2] - boxes_a[..., 0], min=0.0) * torch.clamp(
        boxes_a[..., 3] - boxes_a[..., 1], min=0.0
    )
    area_b = torch.clamp(boxes_b[..., 2] - boxes_b[..., 0], min=0.0) * torch.clamp(
        boxes_b[..., 3] - boxes_b[..., 1], min=0.0
    )
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-6)


def letterbox_correction(
    detections: torch.Tensor,
    input_shape: Tuple[int, int],
    image_shapes: torch.Tensor,
) -> torch.Tensor:
    """Map normalized letterboxed-space (B, K, 15) detections
    ``[x1,y1,x2,y2,score,10*landmark]`` back to normalized coordinates of
    each original image. image_shapes: (B, 2) ``[h, w]``."""
    inp = torch.tensor(input_shape, dtype=detections.dtype, device=detections.device)
    img = image_shapes.to(detections.dtype)
    scale_ratio = torch.amin(inp / img, dim=-1, keepdim=True)
    new_shape = img * scale_ratio
    offset = (inp - new_shape) / 2.0 / inp
    scale = inp / new_shape
    # (h, w) order -> (x, y) order for box coordinates.
    off_xy = offset.flip(-1)
    sc_xy = scale.flip(-1)
    boxes = (detections[..., :4] - off_xy.repeat(1, 2)[:, None, :]) * sc_xy.repeat(1, 2)[
        :, None, :
    ]
    landms = (detections[..., 5:15] - off_xy.repeat(1, 5)[:, None, :]) * sc_xy.repeat(
        1, 5
    )[:, None, :]
    return torch.cat([boxes, detections[..., 4:5], landms], dim=-1)


def scale_to_pixels(detections: torch.Tensor, image_shapes: torch.Tensor) -> torch.Tensor:
    """Scale normalized (B, K, 15) detections to pixels of each image:
    boxes by (w, h, w, h), landmarks by (w, h) per point, score untouched."""
    wh = image_shapes.to(detections.dtype).flip(-1)[:, None, :]  # (B, 1, 2)
    return torch.cat(
        [
            detections[..., :4] * wh.repeat(1, 1, 2),
            detections[..., 4:5],
            detections[..., 5:15] * wh.repeat(1, 1, 5),
        ],
        dim=-1,
    )
