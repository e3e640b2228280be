"""Per-box pixelation (mosaic), bit-identical to OpenCV's recipe.

The reference pixelates each box by INTER_NEAREST downscale by
``mosaic_level`` then INTER_NEAREST upscale, box after box in order on the
same frame. The composed down+up remap of a box depends only on its extent
``b`` (and the level), so a host table built once in float64 holds the
exact source offset for every extent:

    out[y, x, c] = cur[y1 + T[y2-y1][y-y1], x1 + T[x2-x1][x-x1], c]

where ``cur`` is the frame after the earlier boxes. ``mosaic_boxes_batch_``
below is the plain PyTorch version of that rule; the CUDA kernel in
``ops/cuda_mosaic.py`` is held against it. ``mosaic_i420_batch`` applies it
to the planes of I420 frames, and the cv2 host functions at the end are the
oracles both are tested against.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from video_desensitization_torch.ops.yuv import join_i420, split_i420

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


def chroma_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """Half-resolution chroma-plane boxes covering a full-resolution pixel
    box: the start floors and the end ceils, so every chroma sample whose
    2x2 luma block meets the box is pixelated. ``//`` on integer tensors
    floors, also for negative coordinates."""
    return torch.stack(
        [boxes[..., 0] // 2, boxes[..., 1] // 2, (boxes[..., 2] + 1) // 2, (boxes[..., 3] + 1) // 2],
        dim=-1,
    )


def mosaic_i420_batch(
    yuv: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    level: int = DEFAULT_MOSAIC_LEVEL,
    plane_fn=None,
) -> torch.Tensor:
    """Mosaic planar I420 frames directly, out of place.

    yuv: (B, H*3/2, W) uint8 (each frame H*W bytes of Y, then H/2 x W/2 of
    U, then of V: ``ops.yuv.split_i420``), H and W even; boxes: (B, K, 4)
    int full-resolution pixel xyxy; valid: (B, K) bool.

    The Y plane takes the boxes at ``level``; U and V, interleaved as
    (B, H/2, W/2, 2), take ``chroma_boxes`` at ``max(1, level // 2)``, so a
    chroma block covers about as many full-resolution pixels as a luma
    block. plane_fn: the (B, H, W, C) plane anonymizer, called as
    ``plane_fn(planes, boxes, valid, level)``; the plain
    ``mosaic_boxes_batch`` by default.
    """
    if plane_fn is None:
        plane_fn = mosaic_boxes_batch
    h, w = i420_frame_hw(yuv.shape)
    y, u, v = split_i420(yuv, h, w)
    y_out = plane_fn(y[..., None], boxes, valid, level)[..., 0]
    c_out = plane_fn(torch.stack([u, v], dim=-1), chroma_boxes(boxes), valid, max(1, level // 2))
    return join_i420(y_out, c_out[..., 0], c_out[..., 1])


def i420_frame_hw(shape) -> tuple:
    """(H, W) of a (B, H*3/2, W) I420 batch; raises ``ValueError`` unless
    the rows are H*3/2 with H and W even."""
    if len(shape) != 3:
        raise ValueError(f"expected (B, H*3/2, W) I420 frames, got {tuple(shape)}")
    h15, w = shape[1:]
    h = (h15 * 2) // 3
    if h15 * 2 != h * 3 or h % 2 or w % 2:
        raise ValueError(f"I420 frames need H*3/2 rows with H and W even, got {tuple(shape)}")
    return h, w


def mosaic_i420_host_inplace(yuv: np.ndarray, boxes, level: int = DEFAULT_MOSAIC_LEVEL) -> np.ndarray:
    """Host oracle for ``mosaic_i420_batch``: the cv2 mosaic per plane on
    one (H*3/2, W) I420 image, full-resolution boxes on Y, halved boxes at
    ``max(1, level // 2)`` on U and V. Mutates ``yuv``."""
    # The planes are reshaped views; on a non-contiguous array numpy would
    # copy and the writes would be lost.
    if not yuv.flags["C_CONTIGUOUS"]:
        raise ValueError("mosaic_i420_host_inplace needs a C-contiguous array")
    h15, w = yuv.shape
    h = (h15 * 2) // 3
    hw, q = h * w, (h // 2) * (w // 2)
    flat = yuv.reshape(-1)
    mosaic_host_inplace(yuv[:h], boxes, level)
    u = flat[hw : hw + q].reshape(h // 2, w // 2)
    v = flat[hw + q :].reshape(h // 2, w // 2)
    cb = [[x1 // 2, y1 // 2, (x2 + 1) // 2, (y2 + 1) // 2] for x1, y1, x2, y2 in boxes]
    clevel = max(1, level // 2)
    mosaic_host_inplace(u, cb, clevel)
    mosaic_host_inplace(v, cb, clevel)
    return yuv


def mosaic_host_inplace(img: np.ndarray, boxes, level: int = DEFAULT_MOSAIC_LEVEL) -> np.ndarray:
    """The reference's cv2 mosaic, box after box, on ``img`` in place."""
    import cv2

    h, w = img.shape[:2]
    for x1, y1, x2, y2 in boxes:
        x1, y1 = max(0, int(x1)), max(0, int(y1))
        x2, y2 = min(w, int(x2)), min(h, int(y2))
        if x2 <= x1 or y2 <= y1:
            continue
        area = img[y1:y2, x1:x2]
        sh = max(1, (y2 - y1) // level)
        sw = max(1, (x2 - x1) // level)
        small = cv2.resize(area, (sw, sh), interpolation=cv2.INTER_NEAREST)
        img[y1:y2, x1:x2] = cv2.resize(small, (x2 - x1, y2 - y1), interpolation=cv2.INTER_NEAREST)
    return img


def mosaic_host_reference(img: np.ndarray, boxes, level: int = DEFAULT_MOSAIC_LEVEL) -> np.ndarray:
    """``mosaic_host_inplace`` on a copy of ``img``."""
    return mosaic_host_inplace(img.copy(), boxes, level)


def gaussian_blur_host_inplace(
    img: np.ndarray, boxes, sigma: float = 6.0, kernel_radius: int = 12
) -> np.ndarray:
    """Host form of the gaussian anonymizer (the tiered pipeline's): blur
    each clipped box in place with cv2, same sigma and radius as
    ``gaussian_blur_boxes``. cv2 reflects at the box's edges where
    ``gaussian_blur_boxes`` blurs across them, so the two are alternatives,
    not bitwise twins."""
    import cv2

    k = 2 * kernel_radius + 1
    h, w = img.shape[:2]
    for x1, y1, x2, y2 in boxes:
        x1, y1 = max(0, int(x1)), max(0, int(y1))
        x2, y2 = min(w, int(x2)), min(h, int(y2))
        if x2 <= x1 or y2 <= y1:
            continue
        img[y1:y2, x1:x2] = cv2.GaussianBlur(img[y1:y2, x1:x2], (k, k), sigma)
    return img


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
