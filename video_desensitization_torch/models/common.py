"""Shared conv building blocks and explicit-generator weight init.

``ConvBN`` is a ``Sequential`` so its parameters sit under the indices the
reference checkpoints use (``0`` conv, ``1`` BN, ``2`` activation).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from video_desensitization_torch.models.convert import load_torch_checkpoint


class ConvBN(nn.Sequential):
    """Conv2d (no bias) + BatchNorm(eps=1e-5) [+ LeakyReLU].

    ``leaky`` < 0 disables the activation (conv_bn_no_relu); 0 is ReLU.
    """

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, pad=1, groups=1, leaky=0.0):
        layers = [
            nn.Conv2d(in_ch, out_ch, kernel, stride, pad, groups=groups, bias=False),
            nn.BatchNorm2d(out_ch, eps=1e-5),
        ]
        if leaky >= 0.0:
            layers.append(nn.LeakyReLU(leaky) if leaky > 0.0 else nn.ReLU())
        super().__init__(*layers)


def conv_bn(in_ch, out_ch, stride=1, leaky=0.0):
    """3x3 conv + BN + LeakyReLU."""
    return ConvBN(in_ch, out_ch, 3, stride, 1, leaky=leaky)


def conv_bn1x1(in_ch, out_ch, stride=1, leaky=0.0):
    """1x1 conv + BN + LeakyReLU."""
    return ConvBN(in_ch, out_ch, 1, stride, 0, leaky=leaky)


def conv_bn_no_relu(in_ch, out_ch, stride=1):
    """3x3 conv + BN, no activation."""
    return ConvBN(in_ch, out_ch, 3, stride, 1, leaky=-1.0)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``: trainable conv kernels normal with
    variance 1/fan_in (LeCun), conv biases zero, BN at identity statistics.
    Fixed weights (YOLOv8's DFL projection) stay as built."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d) and m.weight.requires_grad:
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return module


def load_weights(net: nn.Module, state_dict, model_path, seed: int) -> None:
    """A given state_dict, else a reference ``.pth``/``.pt`` checkpoint at
    ``model_path``, else random weights from
    ``torch.Generator().manual_seed(seed)``."""
    if state_dict is None and model_path is not None:
        state_dict = load_torch_checkpoint(model_path)
    if state_dict is None:
        init_weights(net, torch.Generator().manual_seed(seed))
    else:
        net.load_state_dict(state_dict)
