"""ResNet-50 feature backbone in torchvision's layout.

Returns the layer2/3/4 maps (strides 8/16/32, 512/1024/2048 channels) that
RetinaFace reads. Module names follow torchvision (``conv1``, ``bn1``,
``layer{i}.{j}.conv{n}``, ``downsample.0/1``) so reference checkpoints load
directly.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from video_desensitization_torch.models.common import BatchNorm2d

BOTTLENECK_COUNTS = {"resnet50": (3, 4, 6, 3)}


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 (x4 expansion); downsample = 1x1 conv + BN."""

    def __init__(self, in_ch: int, width: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(width * 4)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(in_ch, width * 4, 1, stride, bias=False),
                BatchNorm2d(width * 4),
            )
            if downsample
            else None
        )

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet50Features(nn.Module):
    """Returns {1: C3 (s8), 2: C4 (s16), 3: C5 (s32)}."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        # MaxPool2d pads with -inf, like the reference.
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = 64
        counts = BOTTLENECK_COUNTS["resnet50"]
        for li, (n, w, s) in enumerate(zip(counts, (64, 128, 256, 512), (1, 2, 2, 2)), 1):
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(in_ch, w, s if bi == 0 else 1, bi == 0))
                in_ch = w * 4
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x) -> Dict[int, torch.Tensor]:
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return {1: c3, 2: c4, 3: c5}
