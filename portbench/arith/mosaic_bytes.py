"""The mosaic's least bytes, counted over the reference mosaic.

The boxes' remaps compose, so each output pixel is one input pixel; the
reference mosaic of an index frame gives that source for every pixel. The
mosaic is in place: a pixel whose source is another pixel is written and
its source read (the old value of a box is never needed, and a box of
extent b reads only max(1, b // level) of its rows and columns); nothing
else moves. Both are counted in the 32-byte sectors that hold them, since
the card moves no less. (The same count as the port's ``chip_smoke.py``
``mosaic_bound_ms``, over this folder's own mosaic.)
"""

from __future__ import annotations

import re

import numpy as np
import torch

from portbench.arith.peaks import HBM_BYTES_PER_S, SECTOR_BYTES
from portbench.reference.detect import mosaic_

# The mosaic's device kernels in a profiler trace, by the names the port's
# ``csrc/mosaic.cu`` gives them (or any kernel named for the mosaic).
KERNELS = re.compile(r"(^|\W)(prepare_kernel|apply_kernel<\d+>)\(|mosaic")


def _sectors(pixels: torch.Tensor, channels: int, total_bytes: int) -> int:
    hit = torch.zeros(-(-total_bytes // SECTOR_BYTES), dtype=torch.bool, device=pixels.device)
    first = pixels * channels
    hit[first // SECTOR_BYTES] = True
    hit[(first + channels - 1) // SECTOR_BYTES] = True
    return int(hit.sum())


def frame_bytes(h: int, w: int, c: int, boxes: np.ndarray, level: int, device="cpu") -> int:
    """Least bytes moved to mosaic one (h, w, c) uint8 frame with ``boxes``
    (K, 4) pixel xyxy, in order."""
    index = torch.arange(h * w, dtype=torch.int64, device=device).view(h, w, 1)
    source = mosaic_(index.clone(), boxes, level)
    moved = source != index
    if not bool(moved.any()):
        return 0
    total = h * w * c
    return SECTOR_BYTES * (_sectors(index[moved], c, total) + _sectors(source[moved], c, total))


def bound_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
