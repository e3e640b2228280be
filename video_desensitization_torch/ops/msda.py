"""Multi-scale deformable attention (Zhu et al., Deformable DETR, 2021), as
RT-DETR's decoder runs it: the plain PyTorch form.

Each query of each head samples ``P`` points on each of ``L`` value maps
around its reference box and sums them, weighted by a softmax over its
``L * P`` attention logits:

* ``loc = ref_xy + offset / P * ref_wh * 0.5`` (normalized to [0, 1]);
* ``bilinear(v_l, loc)`` is ``F.grid_sample`` at ``grid = 2 * loc - 1``,
  ``align_corners=False``, zero padding: corners outside the map add 0;
* ``out = sum over l, p of softmax(logits)[l, p] * bilinear(v_l, loc[l, p])``.

The softmax and the locations are float32; the samples are taken from the
value in float32 and the output is in the value's dtype. The CUDA kernel
(``ops/cuda_msda.py``) computes the same in one call.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def sampling_locations(ref: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(B, Q, 4) float32 [cx, cy, w, h] boxes and (B, Q, H, L, P, 2) float32
    offsets -> (B, Q, H, L, P, 2) normalized sampling locations."""
    p = offsets.shape[-2]
    box = ref[:, :, None, None, None, :]
    return box[..., :2] + offsets / p * box[..., 2:] * 0.5


def msda_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    offsets: torch.Tensor,
    logits: torch.Tensor,
    ref: torch.Tensor,
) -> torch.Tensor:
    """value (B, S, H, D), the levels' maps flattened row-major one after
    another (``spatial_shapes``: each level's (h, w), S their sum of h*w);
    offsets (B, Q, H, L, P, 2), logits (B, Q, H, L*P) and ref (B, Q, 4),
    float32 -> (B, Q, H*D) in value's dtype."""
    b, _, n_head, d = value.shape
    _, q, _, n_levels, n_points, _ = offsets.shape
    weights = torch.softmax(logits.float(), dim=-1).view(b, q, n_head, n_levels, n_points)
    grids = 2.0 * sampling_locations(ref.float(), offsets.float()) - 1.0
    levels = value.float().split([h * w for h, w in spatial_shapes], dim=1)
    out = torch.zeros((b, n_head, d, q), dtype=torch.float32, device=value.device)
    for lvl, ((h, w), v) in enumerate(zip(spatial_shapes, levels)):
        v = v.permute(0, 2, 3, 1).reshape(b * n_head, d, h, w)
        grid = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(b * n_head, q, n_points, 2)
        sampled = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=False)  # (B*H, D, Q, P)
        wl = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * n_head, 1, q, n_points)
        out += (sampled * wl).sum(-1).view(b, n_head, d, q)
    return out.permute(0, 3, 1, 2).reshape(b, q, n_head * d).to(value.dtype)
