"""Per-box pixelation (mosaic), bit-identical to OpenCV's recipe.

The reference pixelates each box by INTER_NEAREST downscale by
``mosaic_level`` then INTER_NEAREST upscale, box after box in order on the
same frame. The composed down+up remap of a box depends only on its extent
``b`` (and the level), so a host table built once in float64 holds the
exact source offset for every extent:

    out[y, x, c] = cur[y1 + T[y2-y1][y-y1], x1 + T[x2-x1][x-x1], c]

where ``cur`` is the frame after the earlier boxes. ``mosaic_boxes_batch_``
below is the plain PyTorch version of that rule; the CUDA kernel in
``ops/cuda_mosaic.py`` is held against it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_MOSAIC_LEVEL = 8


def _cv2_nn_map(dsz: int, ssz: int) -> np.ndarray:
    """cv2 INTER_NEAREST source indices, exact float64 semantics."""
    scale = np.float64(1.0) / (np.float64(dsz) / np.float64(ssz))
    idx = np.floor(np.arange(dsz, dtype=np.float64) * scale).astype(np.int64)
    return np.minimum(idx, ssz - 1)


@lru_cache(maxsize=8)
def composed_mosaic_table(
    level: int = DEFAULT_MOSAIC_LEVEL, maxdim: int = 2048
) -> np.ndarray:
    """table[b, t] = source offset within a box of extent ``b`` of output
    offset ``t`` after INTER_NEAREST downscale to ``max(1, b // level)`` and
    upscale back. Rows are padded past ``b`` with the last valid entry.
    int16, read-only: extents up to 32767."""
    table = np.zeros((maxdim + 1, maxdim), dtype=np.int16)
    for b in range(1, maxdim + 1):
        s = max(1, b // level)
        up = _cv2_nn_map(b, s)
        down = _cv2_nn_map(s, b)
        comp = down[up]
        table[b, :b] = comp
        if b < maxdim:
            table[b, b:] = comp[-1]
    table.setflags(write=False)
    return table


def clip_boxes(boxes: torch.Tensor, valid: torch.Tensor, height: int, width: int):
    """Clip (..., 4) int xyxy boxes to the frame; a box is applied only if
    it is valid and non-empty after clipping. Returns (clipped, ok)."""
    x1 = boxes[..., 0].clamp(0, width)
    y1 = boxes[..., 1].clamp(0, height)
    x2 = boxes[..., 2].clamp(0, width)
    y2 = boxes[..., 3].clamp(0, height)
    ok = valid.to(torch.bool) & (x2 > x1) & (y2 > y1)
    return torch.stack([x1, y1, x2, y2], dim=-1), ok


def mosaic_boxes_batch_(
    frames: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    level: int = DEFAULT_MOSAIC_LEVEL,
) -> torch.Tensor:
    """Mosaic every valid box of every frame IN PLACE, boxes in order.

    frames: (B, H, W, C) any dtype; boxes: (B, K, 4) int pixel xyxy
    (unclipped ok); valid: (B, K) bool. Reads the boxes on the host once.
    Returns ``frames``.
    """
    _, h, w, _ = frames.shape
    clipped, ok = clip_boxes(boxes.cpu().to(torch.int64), valid.cpu(), h, w)
    if not ok.any():
        return frames
    table = torch.from_numpy(composed_mosaic_table(level, max(h, w)).astype(np.int64))
    table = table.to(frames.device)
    for i, k in ok.nonzero().tolist():
        x1, y1, x2, y2 = clipped[i, k].tolist()
        rows = y1 + table[y2 - y1, : y2 - y1]
        cols = x1 + table[x2 - x1, : x2 - x1]
        # Advanced indexing gathers into a new tensor before the write, so
        # a box reading its own region sees the pre-box values.
        frames[i, y1:y2, x1:x2] = frames[i][rows[:, None], cols[None, :]]
    return frames


def mosaic_boxes_batch(
    frames: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    level: int = DEFAULT_MOSAIC_LEVEL,
) -> torch.Tensor:
    """Out-of-place form of ``mosaic_boxes_batch_``."""
    return mosaic_boxes_batch_(frames.clone(), boxes, valid, level)


def gaussian_blur_boxes(
    frames: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    sigma: float = 6.0,
    kernel_radius: int = 12,
) -> torch.Tensor:
    """Alternative anonymizer: Gaussian-blur box interiors.

    Separable blur over the whole frame (zero padding at the frame edge),
    composited into the union of valid boxes. frames (B, H, W, C) uint8 or
    float; boxes (B, K, 4) int; valid (B, K) bool.
    """
    b, h, w, c = frames.shape
    x = frames.to(torch.float32)
    r = kernel_radius
    k = torch.exp(
        -0.5 * (torch.arange(-r, r + 1, dtype=torch.float32, device=x.device) / sigma) ** 2
    )
    k = k / torch.sum(k)
    nchw = x.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    nchw = F.conv2d(nchw, k.view(1, 1, -1, 1), padding=(r, 0))
    nchw = F.conv2d(nchw, k.view(1, 1, 1, -1), padding=(0, r))
    blurred = nchw.reshape(b, c, h, w).permute(0, 2, 3, 1)

    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    mask = torch.zeros((b, h, w), dtype=torch.bool, device=x.device)
    for k_ in range(boxes.shape[1]):
        bx = boxes[:, k_, :, None, None]
        mask |= (
            (ys >= bx[:, 1]) & (ys < bx[:, 3]) & (xs >= bx[:, 0]) & (xs < bx[:, 2])
            & valid[:, k_, None, None].to(torch.bool)
        )
    out = torch.where(mask[..., None], blurred, x)
    if not frames.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(frames.dtype)
