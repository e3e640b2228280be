"""SSD-style prior (anchor) boxes for RetinaFace.

For each feature level with stride ``steps[k]`` the map is
``(ceil(H/step), ceil(W/step))``; priors are emitted row-major over spatial
positions with the level's ``min_sizes`` innermost, as normalized
``[cx, cy, s_kx, s_ky]``. That order matches a head output permuted to
``(B, H, W, A*C)`` and reshaped to ``(B, H*W*A, C)``. Built once in numpy.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np

DEFAULT_MIN_SIZES: Tuple[Tuple[int, ...], ...] = ((16, 32), (64, 128), (256, 512))
DEFAULT_STEPS: Tuple[int, ...] = (8, 16, 32)


def feature_map_shapes(
    image_size: Tuple[int, int], steps: Sequence[int] = DEFAULT_STEPS
) -> Tuple[Tuple[int, int], ...]:
    """Per-level feature map (height, width) = ceil(image/step)."""
    h, w = image_size
    return tuple((math.ceil(h / s), math.ceil(w / s)) for s in steps)


@lru_cache(maxsize=16)
def _generate_anchors_cached(
    image_size: Tuple[int, int],
    min_sizes: Tuple[Tuple[int, ...], ...],
    steps: Tuple[int, ...],
    clip: bool,
) -> np.ndarray:
    h, w = image_size
    levels = []
    for (fh, fw), level_sizes, step in zip(
        feature_map_shapes(image_size, steps), min_sizes, steps
    ):
        a = len(level_sizes)
        cy = (np.arange(fh, dtype=np.float32) + 0.5) * step / h
        cx = (np.arange(fw, dtype=np.float32) + 0.5) * step / w
        cxg, cyg = np.meshgrid(cx, cy)
        centers = np.repeat(np.stack([cxg, cyg], axis=-1)[:, :, None, :], a, axis=2)
        sizes = np.array([[ms / w, ms / h] for ms in level_sizes], dtype=np.float32)
        sizes = np.broadcast_to(sizes, (fh, fw, a, 2))
        level = np.concatenate([centers, sizes], axis=-1).reshape(-1, 4)
        levels.append(level.astype(np.float32))
    anchors = np.concatenate(levels, axis=0)
    if clip:
        anchors = np.clip(anchors, 0.0, 1.0)
    anchors.setflags(write=False)
    return anchors


def generate_anchors(
    image_size: Tuple[int, int],
    min_sizes: Sequence[Sequence[int]] = DEFAULT_MIN_SIZES,
    steps: Sequence[int] = DEFAULT_STEPS,
    clip: bool = False,
) -> np.ndarray:
    """The (A, 4) float32 prior matrix ``[cx, cy, s_kx, s_ky]`` for an
    (height, width) input. Cached and read-only."""
    return _generate_anchors_cached(
        (int(image_size[0]), int(image_size[1])),
        tuple(tuple(int(m) for m in ms) for ms in min_sizes),
        tuple(int(s) for s in steps),
        bool(clip),
    )
