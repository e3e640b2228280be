"""Model FLOPs of a network with linear layers and attention (RT-DETR),
counted from the reference network's layer shapes on the ``meta`` device
(nothing is computed). A multiply-add is 2 FLOPs. Counted: every
convolution (as ``flops.py`` counts it), every linear layer, and each
attention's input projections and its two products (queries by keys,
weights by values). Not counted: biases, normalisation, activations,
softmax, the deformable attention's bilinear sampling and weighting, the
top-k and gathers.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def forward_flops(model: nn.Module, input_shape: Tuple[int, ...]) -> float:
    """FLOPs of one forward of ``model`` on an ``input_shape`` batch."""
    total = [0.0]

    def conv(m, inp, out):
        total[0] += 2.0 * m.weight[0].numel() * out.numel()

    def linear(m, inp, out):
        total[0] += 2.0 * m.in_features * out.numel()

    def attention(m, inp, out):
        b, n, e = inp[0].shape
        total[0] += 2.0 * b * n * e * 3 * e  # the packed query, key and value projections
        total[0] += 2.0 * 2 * b * n * n * e  # q k^T and a v, over all heads

    hooks = {nn.Conv2d: conv, nn.Linear: linear}
    meta = model.to("meta") if next(model.parameters()).device.type != "meta" else model
    handles = []
    for m in meta.modules():
        fn = next((f for t, f in hooks.items() if isinstance(m, t)), None)
        if fn is None and hasattr(m, "in_proj_weight"):
            fn = attention
        if fn is not None:
            handles.append(m.register_forward_hook(fn))
    try:
        with torch.no_grad():
            meta(torch.empty(input_shape, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return total[0]
