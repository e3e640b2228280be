"""Convolution FLOPs of a network at an input shape, counted from the
reference network's layer shapes on the ``meta`` device (nothing is
computed). A multiply-add is 2 FLOPs; biases, normalisation and
activations are not counted.

A training step's FLOPs are the forward's plus, for every trainable
convolution, its weight gradient (as many as its forward) and its input
gradient (as many again), except where the input needs none: the first
convolution, which reads the images.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def conv_flops(model: nn.Module, input_shape: Tuple[int, ...]) -> Tuple[float, float, float]:
    """(forward, weight-gradient, input-gradient) FLOPs of ``model``'s
    convolutions for one call on a ``input_shape`` batch."""
    fwd = [0.0]
    wgrad = [0.0]
    dgrad = [0.0]
    first = [True]

    def hook(m: nn.Conv2d, inp, out):
        k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        f = 2.0 * k * out.numel()
        fwd[0] += f
        if m.weight.requires_grad:
            wgrad[0] += f
            if not first[0]:
                dgrad[0] += f
        first[0] = False

    meta = model.to("meta") if next(model.parameters()).device.type != "meta" else model
    handles = [m.register_forward_hook(hook) for m in meta.modules() if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad():
            meta(torch.empty(input_shape, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return fwd[0], wgrad[0], dgrad[0]


def forward_flops(model: nn.Module, input_shape) -> float:
    return conv_flops(model, input_shape)[0]


def train_step_flops(model: nn.Module, input_shape) -> float:
    return sum(conv_flops(model, input_shape))
