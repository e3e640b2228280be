"""ResNet-50 feature backbones: torchvision's layout, and the "vd" variant.

Both return the layer2/3/4 maps (strides 8/16/32, 512/1024/2048 channels).
``ResNet50Features`` is RetinaFace's: module names follow torchvision
(``conv1``, ``bn1``, ``layer{i}.{j}.conv{n}``, ``downsample.0/1``) so
reference checkpoints load directly. ``ResNet50VdFeatures`` is RT-DETR's
PResNet-50 variant d (He et al., "Bag of Tricks", 2019): a deep stem of
three 3x3 convolutions and, where a block's shortcut halves the map, an
average pool before its 1x1 convolution; the blocks are the same
``Bottleneck``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from video_desensitization_torch.models.common import BatchNorm2d, ConvBN

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


class ResNet50VdFeatures(nn.Module):
    """PResNet depth 50, variant d -> [C3 (s8), C4 (s16), C5 (s32)].

    Stem: 3x3 convolutions 3->32 (stride 2), 32->32, 32->64, each with BN
    and ReLU, then a 3x3 stride-2 max pool. Each stage's first block
    projects its shortcut: ``AvgPool2d(2, 2, ceil_mode=True)`` then a 1x1
    convolution and BN where it strides (``downsample.0/1/2``), a 1x1
    convolution and BN where it does not (``downsample.0/1``). ``blocks``
    per stage: (3, 4, 6, 3) published; tests run fewer.
    """

    def __init__(self, blocks=BOTTLENECK_COUNTS["resnet50"]):
        super().__init__()
        self.stem = nn.Sequential(ConvBN(3, 32, 3, 2, 1), ConvBN(32, 32, 3, 1, 1),
                                  ConvBN(32, 64, 3, 1, 1))
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = 64
        for li, (n, w, s) in enumerate(zip(blocks, (64, 128, 256, 512), (1, 2, 2, 2)), 1):
            layer = []
            for bi in range(n):
                block = Bottleneck(in_ch, w, s if bi == 0 else 1, bi == 0)
                if bi == 0 and s == 2:
                    block.downsample = nn.Sequential(
                        nn.AvgPool2d(2, 2, ceil_mode=True),
                        nn.Conv2d(in_ch, w * 4, 1, bias=False),
                        BatchNorm2d(w * 4),
                    )
                layer.append(block)
                in_ch = w * 4
            setattr(self, f"layer{li}", nn.Sequential(*layer))

    def forward(self, x):
        x = self.layer1(self.maxpool(self.stem(x)))
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return [c3, c4, self.layer4(c4)]
