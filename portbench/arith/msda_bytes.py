"""The multi-scale deformable attention kernel's least bytes, counted on
the reference's sampling locations.

A call gathers, for each query, head, level and point, the four bilinear
corners of the location in that level's map (``F.grid_sample``'s
arithmetic: ``x = loc_x * W - 0.5``, corners at its floor and the next
column and row); a corner outside the map adds nothing and needs no read.
Each in-map corner reads the head's row of ``head_dim`` channels of the
value, ``(B, S, H, D)`` contiguous in the served dtype. The least bytes of
a call are the distinct 32-byte sectors those rows touch, plus the
offsets, logits and boxes (float32) read once and the output written once.
(``csrc/msda.cu``'s own count of its bound.)
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import torch

from portbench.arith.peaks import HBM_BYTES_PER_S, SECTOR_BYTES

# The kernel in a profiler trace, by the name ``csrc/msda.cu`` gives it.
KERNELS = re.compile(r"msda_kernel")


def value_sectors(loc: torch.Tensor, shapes: Sequence[Tuple[int, int]], head_dim: int,
                  elem_bytes: int) -> int:
    """Distinct 32-byte sectors of the value that the in-map corners of
    ``loc`` (B, Q, H, L, P, 2) normalized locations read."""
    b, q, heads, levels, points, _ = loc.shape
    s = sum(h * w for h, w in shapes)
    starts = [0]
    for h, w in shapes[:-1]:
        starts.append(starts[-1] + h * w)
    frame = torch.arange(b, device=loc.device).view(b, 1, 1, 1)
    head = torch.arange(heads, device=loc.device).view(1, 1, heads, 1)
    offsets = []
    for lvl, ((h, w), start) in enumerate(zip(shapes, starts)):
        x = loc[:, :, :, lvl, :, 0].double() * w - 0.5
        y = loc[:, :, :, lvl, :, 1].double() * h - 0.5
        x0, y0 = torch.floor(x).long(), torch.floor(y).long()
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            cx, cy = x0 + dx, y0 + dy
            inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            row = ((frame * s + start + cy * w + cx) * heads + head) * head_dim
            offsets.append(row[inside])
    first = torch.cat(offsets) * elem_bytes
    if not len(first):
        return 0
    lo = first // SECTOR_BYTES
    hi = (first + head_dim * elem_bytes - 1) // SECTOR_BYTES
    sectors = lo[:, None] + torch.arange(int((hi - lo).max()) + 1, device=lo.device)[None]
    return int(torch.unique(sectors[sectors <= hi[:, None]]).numel())


def call_bytes(loc: torch.Tensor, shapes: Sequence[Tuple[int, int]], head_dim: int,
               elem_bytes: int) -> int:
    """Least bytes of one kernel call with these sampling locations."""
    b, q, heads, levels, points, _ = loc.shape
    n = b * q * heads
    once = 4 * (n * levels * points * 3 + b * q * 4) + n * head_dim * elem_bytes
    return SECTOR_BYTES * value_sectors(loc, shapes, head_dim, elem_bytes) + once


def bound_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
