"""The one generator of the benchmark's inputs, driven by a cell's
``traffic`` parameters and the run's seed. Every seed gives the same
sizes and counts; only the content differs.

* ``frame_pool``: ``pool_batches`` distinct batches of ``batch`` uint8 RGB
  frames of ``height`` x ``width``: smooth noise (uniform noise on a grid
  ``detail_px`` coarser, bilinearly enlarged) with ``squares`` bright
  squares a frame, made on the device and copied to the host.
* ``labelled_images``: ``images`` uint8 RGB images with between
  ``faces_min`` and ``faces_max`` bright squares each (sides
  ``face_px_min`` to ``face_px_max``), every ``landmark_every``-th with five
  landmarks, and their annotation rows ``[x1, y1, x2, y2, 10 landmark
  coordinates or -1]`` in pixels, made on the host.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LANDMARKS = ((0.3, 0.35), (0.7, 0.35), (0.5, 0.55), (0.35, 0.75), (0.65, 0.75))


@torch.no_grad()
def frame_pool(p: Dict, seed: int, device) -> List[np.ndarray]:
    h, w, b, n = p["height"], p["width"], p["batch"], p["pool_batches"]
    d = p["detail_px"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    coarse = torch.rand((n * b, 3, -(-h // d), -(-w // d)), generator=gen, device=device)
    frames = F.interpolate(coarse * 255.0, size=(h, w), mode="bilinear", align_corners=False)
    k = p["squares"]
    side = torch.randint(p["square_px_min"], p["square_px_max"] + 1, (n * b, k),
                         generator=gen, device=device)
    x0 = (torch.rand((n * b, k), generator=gen, device=device) * (w - side)).long()
    y0 = (torch.rand((n * b, k), generator=gen, device=device) * (h - side)).long()
    shade = torch.randint(180, 256, (n * b, k, 3), generator=gen, device=device).float()
    ys = torch.arange(h, device=device).view(1, h, 1)
    xs = torch.arange(w, device=device).view(1, 1, w)
    for j in range(k):
        inside = ((ys >= y0[:, j, None, None]) & (ys < (y0 + side)[:, j, None, None])
                  & (xs >= x0[:, j, None, None]) & (xs < (x0 + side)[:, j, None, None]))
        frames = torch.where(inside[:, None], shade[:, j, :, None, None], frames)
    frames = frames.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    host = frames.cpu().numpy()
    return [host[i * b:(i + 1) * b] for i in range(n)]


def labelled_images(p: Dict, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    h, w, d = p["height"], p["width"], p["detail_px"]
    rng = np.random.default_rng(int(seed))
    out = []
    for _ in range(p["images"]):
        coarse = torch.from_numpy(rng.random((1, 3, -(-h // d), -(-w // d)), dtype=np.float32))
        img = F.interpolate(coarse * 255.0, size=(h, w), mode="bilinear", align_corners=False)
        img = img[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy().copy()
        rows = []
        for j in range(int(rng.integers(p["faces_min"], p["faces_max"] + 1))):
            s = int(rng.integers(p["face_px_min"], p["face_px_max"] + 1))
            x, y = int(rng.integers(0, w - s)), int(rng.integers(0, h - s))
            img[y:y + s, x:x + s] = rng.integers(180, 256, 3)
            lm = [-1.0] * 10
            if j % p["landmark_every"] == 0:
                lm = [c for a, b in LANDMARKS for c in (x + a * s, y + b * s)]
            rows.append([x, y, x + s, y + s, *lm])
        out.append((img, np.asarray(rows, np.float64)))
    return out
