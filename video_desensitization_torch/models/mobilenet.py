"""MobileNetV1 x0.25 backbone in the reference layout.

Three stages of depthwise-separable convs (8 -> 16 -> 32 -> 64 -> 128 -> 256
channels), LeakyReLU(0.1), returning {1: stage1 (s8, 64ch), 2: stage2
(s16, 128ch), 3: stage3 (s32, 256ch)}. ``stage1.0`` is the stem conv_bn;
each depthwise-separable block is one ``Sequential`` (0/1 depthwise conv/BN,
3/4 pointwise conv/BN) as in the reference checkpoints.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from video_desensitization_torch.models.common import BatchNorm2d, ConvBN


class DepthwiseSeparable(nn.Sequential):
    """3x3 depthwise + BN + LeakyReLU, then 1x1 pointwise + BN + LeakyReLU."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, leaky: float = 0.1):
        super().__init__(
            nn.Conv2d(in_ch, in_ch, 3, stride, 1, groups=in_ch, bias=False),
            BatchNorm2d(in_ch),
            nn.LeakyReLU(leaky),
            nn.Conv2d(in_ch, out_ch, 1, 1, 0, bias=False),
            BatchNorm2d(out_ch),
            nn.LeakyReLU(leaky),
        )


# (in, out, stride) per depthwise-separable block within each stage.
STAGE1 = [(8, 16, 1), (16, 32, 2), (32, 32, 1), (32, 64, 2), (64, 64, 1)]
STAGE2 = [(64, 128, 2)] + [(128, 128, 1)] * 5
STAGE3 = [(128, 256, 2), (256, 256, 1)]


class MobileNetV1Features(nn.Module):
    def __init__(self):
        super().__init__()
        self.stage1 = nn.Sequential(
            ConvBN(3, 8, 3, 2, 1, leaky=0.1), *[DepthwiseSeparable(*a) for a in STAGE1]
        )
        self.stage2 = nn.Sequential(*[DepthwiseSeparable(*a) for a in STAGE2])
        self.stage3 = nn.Sequential(*[DepthwiseSeparable(*a) for a in STAGE3])

    def forward(self, x) -> Dict[int, torch.Tensor]:
        s1 = self.stage1(x)
        s2 = self.stage2(s1)
        s3 = self.stage3(s2)
        return {1: s1, 2: s2, 3: s3}
