"""Planar YUV420 (I420) colour conversion, bitwise equal to cv2.

The engine's I420 path takes decoded I420 frames as they come from the
decoder (half the bytes of RGB24) and pixelates the planes directly; only
the detectors need RGB. ``i420_to_rgb_u8`` is cv2's fixed-point ITU-R
BT.601 video-range conversion (``cv2.COLOR_YUV2RGB_I420``) in int32, so a
detector on this path sees the pixels a host cv2 pipeline would:

    ruv = (1 << 19) + CVR * (V - 128)
    guv = (1 << 19) + CVG * (V - 128) + CUG * (U - 128)
    buv = (1 << 19) + CUB * (U - 128)
    y   = max(0, Y - 16) * CY
    R, G, B = sat_u8((y + {ruv, guv, buv}) >> 20)

with each chroma sample shared by its 2x2 luma block. Every intermediate
fits int32 (|y + guv| < 2^30), and ``>>`` on int32 is arithmetic. The chroma
terms are computed at chroma resolution and broadcast over each 2x2 block,
so no full-size chroma tensor is made.
"""

from __future__ import annotations

import numpy as np
import torch

# ITU-R BT.601 video-range fixed-point coefficients (cv2 ITUR_BT_601_*).
_CY = 1220542
_CUB = 2116026
_CUG = -409993
_CVG = -852492
_CVR = 1673527
_SHIFT = 20


def split_i420(yuv: torch.Tensor, height: int, width: int):
    """(B, H*3/2, W) planar I420 -> Y (B, H, W), U, V (B, H/2, W/2), as
    views of ``yuv`` where it is contiguous.

    Each frame's buffer holds H*W bytes of Y, then H/2 * W/2 of U, then as
    many of V. The planes are cut at those byte offsets, so H need not be a
    multiple of 4 (at H = 98 a chroma plane ends mid-row)."""
    b = yuv.shape[0]
    h, w = height, width
    hw, q = h * w, (h // 2) * (w // 2)
    flat = yuv.reshape(b, -1)
    y = flat[:, :hw].reshape(b, h, w)
    u = flat[:, hw : hw + q].reshape(b, h // 2, w // 2)
    v = flat[:, hw + q :].reshape(b, h // 2, w // 2)
    return y, u, v


def join_i420(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_i420`."""
    b, h, w = y.shape
    planes = [p.reshape(b, -1) for p in (y, u, v)]
    return torch.cat(planes, dim=1).reshape(b, h * 3 // 2, w)


def _upsample2x(p: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest 2x chroma upsample: each sample covers its 2x2 luma block."""
    b = p.shape[0]
    return p[:, :, None, :, None].expand(b, h // 2, 2, w // 2, 2).reshape(b, h, w)


def i420_to_rgb_u8(yuv: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H*3/2, W) uint8 I420 -> (B, H, W, 3) uint8 RGB, bitwise cv2's
    ``cvtColor(_, COLOR_YUV2RGB_I420)``."""
    y8, u8, v8 = split_i420(yuv, height, width)
    b, h, w = y8.shape[0], height, width
    # Luma as (B, H/2, 2, W/2, 2): each chroma term broadcasts over its block.
    yv = ((y8.to(torch.int32) - 16).clamp_(min=0) * _CY).reshape(b, h // 2, 2, w // 2, 2)
    uu = (u8.to(torch.int32) - 128)[:, :, None, :, None]
    vv = (v8.to(torch.int32) - 128)[:, :, None, :, None]
    half = 1 << (_SHIFT - 1)
    terms = (half + _CVR * vv, half + _CVG * vv + _CUG * uu, half + _CUB * uu)
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=yuv.device)
    blocks = out.view(b, h // 2, 2, w // 2, 2, 3)
    for c, term in enumerate(terms):
        acc = yv + term
        blocks[..., c] = acc.bitwise_right_shift_(_SHIFT).clamp_(0, 255)
    return out


def rgb_to_i420_host(rgb: np.ndarray) -> np.ndarray:
    """Host RGB -> planar I420 via cv2 (BT.601, 2x2 chroma average)."""
    import cv2

    return cv2.cvtColor(np.ascontiguousarray(rgb, np.uint8), cv2.COLOR_RGB2YUV_I420)
