"""YOLOv8 detection network in the ultralytics state_dict layout.

Conv-BN(eps=1e-3)-SiLU blocks, C2f, SPPF, a PAN neck and a decoupled head
with DFL box regression, sized by the standard width/depth multiples.
``model.{i}`` indices and submodule names match ultralytics checkpoints, so
their state_dicts load directly.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

REG_MAX = 16
STRIDES = (8, 16, 32)

VARIANTS = {
    # name: (depth_multiple, width_multiple, ratio)
    "n": (1 / 3, 0.25, 2.0),
    "s": (1 / 3, 0.50, 2.0),
    "m": (2 / 3, 0.75, 1.5),
    "l": (1.0, 1.00, 1.0),
    "x": (1.0, 1.25, 1.0),
}


def _width(c: int, w: float) -> int:
    return max(8, int(math.ceil(c * w / 8) * 8))


def _depth(n: int, d: float) -> int:
    return max(1, round(n * d))


class ConvBlock(nn.Module):
    """Conv2d + BN(eps=1e-3) + SiLU (ultralytics ``Conv``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3, momentum=0.03)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class YoloBottleneck(nn.Module):
    def __init__(self, ch: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBlock(ch, ch, 3, 1)
        self.cv2 = ConvBlock(ch, ch, 3, 1)
        self.add = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        half = out_ch // 2
        self.cv1 = ConvBlock(in_ch, out_ch, 1, 1)
        self.cv2 = ConvBlock((2 + n) * half, out_ch, 1, 1)
        self.m = nn.ModuleList(YoloBottleneck(half, shortcut) for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, dim=1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, dim=1))


class SPPF(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        half = in_ch // 2
        self.cv1 = ConvBlock(in_ch, half, 1, 1)
        self.cv2 = ConvBlock(half * 4, out_ch, 1, 1)
        self.mpool = nn.MaxPool2d(5, 1, 2)

    def forward(self, x):
        x = self.cv1(x)
        p1 = self.mpool(x)
        p2 = self.mpool(p1)
        return self.cv2(torch.cat([x, p1, p2, self.mpool(p2)], dim=1))


class DFL(nn.Module):
    """Fixed projection of the 16 distance bins (kept as the checkpoint's
    ``dfl.conv.weight``; the forward pass uses the same arange)."""

    def __init__(self, bins: int = REG_MAX):
        super().__init__()
        self.conv = nn.Conv2d(bins, 1, 1, bias=False).requires_grad_(False)
        with torch.no_grad():
            self.conv.weight.copy_(torch.arange(bins, dtype=torch.float32).view(1, bins, 1, 1))


class DetectHead(nn.Module):
    """Decoupled box (DFL) and class heads over three scales."""

    def __init__(self, num_classes: int, channels: Sequence[int]):
        super().__init__()
        c2 = max(16, channels[0] // 4, REG_MAX * 4)
        c3 = max(channels[0], min(num_classes, 100))
        self.nc = num_classes
        self.cv2 = nn.ModuleList(
            nn.Sequential(ConvBlock(c, c2, 3, 1), ConvBlock(c2, c2, 3, 1),
                          nn.Conv2d(c2, 4 * REG_MAX, 1))
            for c in channels
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(ConvBlock(c, c3, 3, 1), ConvBlock(c3, c3, 3, 1),
                          nn.Conv2d(c3, num_classes, 1))
            for c in channels
        )
        self.dfl = DFL(REG_MAX)

    def forward(self, feats: List[torch.Tensor]):
        """-> (box logits (B, A, 64), class logits (B, A, nc)), anchors in
        (scale, h, w) order."""
        box_out, cls_out = [], []
        for f, cv2, cv3 in zip(feats, self.cv2, self.cv3):
            b = cv2(f).permute(0, 2, 3, 1)
            c = cv3(f).permute(0, 2, 3, 1)
            box_out.append(b.reshape(b.shape[0], -1, 4 * REG_MAX))
            cls_out.append(c.reshape(c.shape[0], -1, self.nc))
        return torch.cat(box_out, 1), torch.cat(cls_out, 1)


class YoloV8(nn.Module):
    """Backbone + PAN + Detect; returns (boxes xyxy in input pixels,
    class probabilities), both float32.

    Input: (B, 3, H, W) float in [0, 1], H and W multiples of 32.
    """

    def __init__(self, num_classes: int = 1, variant: str = "n"):
        super().__init__()
        d, w, r = VARIANTS[variant]
        c64, c128, c256, c512 = (_width(c, w) for c in (64, 128, 256, 512))
        c_last = int(c512 * r)
        n3, n6 = _depth(3, d), _depth(6, d)
        self.model = nn.ModuleList(
            [
                ConvBlock(3, c64, 3, 2),  # 0 P1
                ConvBlock(c64, c128, 3, 2),  # 1 P2
                C2f(c128, c128, n3, True),  # 2
                ConvBlock(c128, c256, 3, 2),  # 3 P3
                C2f(c256, c256, n6, True),  # 4
                ConvBlock(c256, c512, 3, 2),  # 5 P4
                C2f(c512, c512, n6, True),  # 6
                ConvBlock(c512, c_last, 3, 2),  # 7 P5
                C2f(c_last, c_last, n3, True),  # 8
                SPPF(c_last, c_last),  # 9
                nn.Upsample(scale_factor=2, mode="nearest"),  # 10
                nn.Identity(),  # 11 concat
                C2f(c_last + c512, c512, n3, False),  # 12
                nn.Upsample(scale_factor=2, mode="nearest"),  # 13
                nn.Identity(),  # 14 concat
                C2f(c512 + c256, c256, n3, False),  # 15
                ConvBlock(c256, c256, 3, 2),  # 16
                nn.Identity(),  # 17 concat
                C2f(c256 + c512, c512, n3, False),  # 18
                ConvBlock(c512, c512, 3, 2),  # 19
                nn.Identity(),  # 20 concat
                C2f(c512 + c_last, c_last, n3, False),  # 21
                DetectHead(num_classes, (c256, c512, c_last)),  # 22
            ]
        )

    def forward(self, x):
        m = self.model
        y = m[2](m[1](m[0](x)))
        p3 = m[4](m[3](y))
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        h4 = m[12](torch.cat([m[10](p5), p4], 1))
        h3 = m[15](torch.cat([m[13](h4), p3], 1))
        h4b = m[18](torch.cat([m[16](h3), h4], 1))
        h5 = m[21](torch.cat([m[19](h4b), p5], 1))
        feats = [h3, h4b, h5]
        box_raw, cls_raw = m[22](feats)

        anchors, strides = [], []
        for f, s in zip(feats, STRIDES):
            hh, ww = f.shape[2], f.shape[3]
            gy, gx = torch.meshgrid(
                torch.arange(hh, dtype=torch.float32, device=x.device) + 0.5,
                torch.arange(ww, dtype=torch.float32, device=x.device) + 0.5,
                indexing="ij",
            )
            anchors.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
            strides.append(torch.full((hh * ww, 1), float(s), device=x.device))
        anchor_points = torch.cat(anchors, 0)  # (A, 2)
        stride_t = torch.cat(strides, 0)  # (A, 1)

        # DFL: softmax over the bins -> expectation -> ltrb grid distances.
        bsz, a = box_raw.shape[0], box_raw.shape[1]
        bins = torch.arange(REG_MAX, dtype=torch.float32, device=x.device)
        dist = torch.softmax(box_raw.reshape(bsz, a, 4, REG_MAX).to(torch.float32), -1) @ bins
        x1y1 = anchor_points - dist[..., :2]
        x2y2 = anchor_points + dist[..., 2:]
        boxes = torch.cat([x1y1, x2y2], -1) * stride_t
        return boxes, torch.sigmoid(cls_raw.to(torch.float32))
