"""Plain PyTorch networks in their published state_dict layouts.

* RetinaFace-ResNet50 as in biubug6/Pytorch_Retinaface (``models/retinaface.py``,
  ``models/net.py``; ``data/config.py`` ``cfg_re50``): torchvision's
  ResNet-50 body (stride on the 3x3 conv), returning layer2/3/4; FPN with
  nearest upsampling; three SSH blocks; class, box and landmark heads of
  two anchors a position. LeakyReLU's slope is 0 (ReLU) for more than 64
  channels.
* YOLOv8 as in ultralytics ``yolov8.yaml`` at a scale (depth, width,
  max channels): Conv-BN(eps 1e-3)-SiLU, C2f, SPPF, the PAN neck and the
  decoupled Detect head with DFL over 16 bins.

Every convolution is a ``QConv2d``: with ``qdtype`` set its operands
are 8-bit floats (input and kernel in ``qdtype``, the gradient coming
back in e5m2; one scale a tensor, the largest magnitude onto the type's
largest value), computed in the weight's own type. That is the control of
the correctness comparison; with ``qdtype`` None it is a plain
``nn.Conv2d``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}
FP8_GRAD = {torch.float8_e4m3fn: torch.float8_e5m2}


def quantize(t: torch.Tensor, qdtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``qdtype`` under one scale (its largest magnitude
    onto the type's largest value), returned in ``t``'s dtype."""
    scale = t.abs().amax().float().clamp(min=1e-30) / FP8_MAX[qdtype]
    return (t.float() / scale).to(qdtype).float().mul(scale).to(t.dtype)


class _QConv(torch.autograd.Function):
    """A convolution whose operands are 8-bit floats: the input and the
    kernel in ``qdtype`` going forward, the output's gradient in the
    wider-range type of the FP8 training recipe (e5m2) going back."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, groups, qdtype):
        xq, wq = quantize(x, qdtype), quantize(w, qdtype)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, groups, qdtype, b is not None)
        return F.conv2d(xq, wq, b, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, grad):
        xq, wq = ctx.saved_tensors
        stride, padding, groups, qdtype, has_bias = ctx.conf
        gq = quantize(grad, FP8_GRAD.get(qdtype, qdtype))
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, padding, 1, groups)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride, padding, 1, groups)
        gb = grad.sum((0, 2, 3)) if has_bias else None
        return gx, gw, gb, None, None, None, None


class QConv2d(nn.Conv2d):
    qdtype: Optional[torch.dtype] = None

    def forward(self, x):
        if self.qdtype is None:
            return super().forward(x)
        return _QConv.apply(x, self.weight, self.bias, self.stride, self.padding, self.groups,
                            self.qdtype)


def set_qdtype(model: nn.Module, qdtype: Optional[torch.dtype]) -> nn.Module:
    for m in model.modules():
        if isinstance(m, QConv2d):
            m.qdtype = qdtype
    return model


# ---------------------------------------------------------------- RetinaFace

def conv_bn(inp, oup, stride=1, leaky=0.0, k=3, act=True):
    pad = 1 if k == 3 else 0
    layers = [QConv2d(inp, oup, k, stride, pad, bias=False), nn.BatchNorm2d(oup)]
    if act:
        layers.append(nn.LeakyReLU(negative_slope=leaky, inplace=False))
    return nn.Sequential(*layers)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = QConv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = QConv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = QConv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            QConv2d(inplanes, planes * 4, 1, stride, bias=False), nn.BatchNorm2d(planes * 4)
        ) if downsample else None

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + idt)


class ResNet50Body(nn.Module):
    """torchvision resnet50 up to layer4; returns layer2, layer3, layer4."""

    def __init__(self, blocks=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = QConv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for i, (n, planes) in enumerate(zip(blocks, (64, 128, 256, 512)), 1):
            layer = []
            for j in range(n):
                stride = 2 if (j == 0 and i > 1) else 1
                layer.append(Bottleneck(inplanes, planes, stride, j == 0))
                inplanes = planes * 4
            setattr(self, f"layer{i}", nn.Sequential(*layer))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return [c3, c4, self.layer4(c4)]


class FPN(nn.Module):
    def __init__(self, in_list, out):
        super().__init__()
        leaky = 0.1 if out <= 64 else 0.0
        self.output1 = conv_bn(in_list[0], out, leaky=leaky, k=1)
        self.output2 = conv_bn(in_list[1], out, leaky=leaky, k=1)
        self.output3 = conv_bn(in_list[2], out, leaky=leaky, k=1)
        self.merge1 = conv_bn(out, out, leaky=leaky)
        self.merge2 = conv_bn(out, out, leaky=leaky)

    def forward(self, feats):
        o1, o2, o3 = self.output1(feats[0]), self.output2(feats[1]), self.output3(feats[2])
        o2 = self.merge2(o2 + F.interpolate(o3, size=o2.shape[2:], mode="nearest"))
        o1 = self.merge1(o1 + F.interpolate(o2, size=o1.shape[2:], mode="nearest"))
        return [o1, o2, o3]


class SSH(nn.Module):
    def __init__(self, inp, out):
        super().__init__()
        leaky = 0.1 if out <= 64 else 0.0
        self.conv3X3 = conv_bn(inp, out // 2, act=False)
        self.conv5X5_1 = conv_bn(inp, out // 4, leaky=leaky)
        self.conv5X5_2 = conv_bn(out // 4, out // 4, act=False)
        self.conv7X7_2 = conv_bn(out // 4, out // 4, leaky=leaky)
        self.conv7x7_3 = conv_bn(out // 4, out // 4, act=False)

    def forward(self, x):
        c5_1 = self.conv5X5_1(x)
        c7 = self.conv7x7_3(self.conv7X7_2(c5_1))
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1), c7], 1))


class Head(nn.Module):
    def __init__(self, inp, per_anchor, anchors=2):
        super().__init__()
        self.per_anchor = per_anchor
        self.conv1x1 = QConv2d(inp, anchors * per_anchor, 1)

    def forward(self, x):
        out = self.conv1x1(x).permute(0, 2, 3, 1).contiguous()
        return out.view(out.shape[0], -1, self.per_anchor)


class RetinaFace(nn.Module):
    """Returns (loc (B, A, 4), class logits (B, A, 2), landmarks (B, A, 10))."""

    def __init__(self, in_channel=256, out_channel=256):
        super().__init__()
        self.body = ResNet50Body()
        self.fpn = FPN([in_channel * 2, in_channel * 4, in_channel * 8], out_channel)
        self.ssh1 = SSH(out_channel, out_channel)
        self.ssh2 = SSH(out_channel, out_channel)
        self.ssh3 = SSH(out_channel, out_channel)
        self.ClassHead = nn.ModuleList(Head(out_channel, 2) for _ in range(3))
        self.BboxHead = nn.ModuleList(Head(out_channel, 4) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(Head(out_channel, 10) for _ in range(3))

    def forward(self, x):
        fpn = self.fpn(self.body(x))
        feats = [self.ssh1(fpn[0]), self.ssh2(fpn[1]), self.ssh3(fpn[2])]
        loc = torch.cat([h(f) for h, f in zip(self.BboxHead, feats)], 1)
        cls = torch.cat([h(f) for h, f in zip(self.ClassHead, feats)], 1)
        landm = torch.cat([h(f) for h, f in zip(self.LandmarkHead, feats)], 1)
        return loc, cls, landm


# -------------------------------------------------------------------- YOLOv8

def make_divisible(x, divisor=8):
    return math.ceil(x / divisor) * divisor


class Conv(nn.Module):
    def __init__(self, c1, c2, k=1, s=1):
        super().__init__()
        self.conv = QConv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class YBottleneck(nn.Module):
    def __init__(self, c, shortcut):
        super().__init__()
        self.cv1 = Conv(c, c, 3)
        self.cv2 = Conv(c, c, 3)
        self.add = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=False):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(YBottleneck(self.c, shortcut) for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        self.cv1 = Conv(c1, c1 // 2, 1)
        self.cv2 = Conv(c1 // 2 * 4, c2, 1)
        self.k = k

    def forward(self, x):
        x = self.cv1(x)
        pools = [x]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(pools, 1))


class DFL(nn.Module):
    def __init__(self, c1=16):
        super().__init__()
        self.conv = nn.Conv2d(c1, 1, 1, bias=False).requires_grad_(False)
        with torch.no_grad():
            self.conv.weight.copy_(torch.arange(c1, dtype=torch.float32).view(1, c1, 1, 1))


class Detect(nn.Module):
    def __init__(self, nc, ch: Sequence[int], reg_max=16):
        super().__init__()
        self.nc, self.reg_max = nc, reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), QConv2d(c2, 4 * reg_max, 1)) for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), QConv2d(c3, nc, 1)) for x in ch)
        self.dfl = DFL(reg_max)


class YOLOv8(nn.Module):
    """Returns (xyxy boxes in input pixels (B, A, 4), class logits (B, A,
    nc)), float32; anchors level by level, row-major."""

    STRIDES = (8, 16, 32)

    def __init__(self, nc=1, depth=1 / 3, width=0.25, max_channels=1024):
        super().__init__()
        ch = lambda c: make_divisible(min(c, max_channels) * width, 8)  # noqa: E731
        n = lambda k: max(round(k * depth), 1)  # noqa: E731
        c64, c128, c256, c512, c1024 = (ch(c) for c in (64, 128, 256, 512, 1024))
        self.model = nn.ModuleList([
            Conv(3, c64, 3, 2), Conv(c64, c128, 3, 2), C2f(c128, c128, n(3), True),
            Conv(c128, c256, 3, 2), C2f(c256, c256, n(6), True),
            Conv(c256, c512, 3, 2), C2f(c512, c512, n(6), True),
            Conv(c512, c1024, 3, 2), C2f(c1024, c1024, n(3), True), SPPF(c1024, c1024),
            nn.Upsample(scale_factor=2, mode="nearest"), nn.Identity(),
            C2f(c1024 + c512, c512, n(3)),
            nn.Upsample(scale_factor=2, mode="nearest"), nn.Identity(),
            C2f(c512 + c256, c256, n(3)),
            Conv(c256, c256, 3, 2), nn.Identity(), C2f(c256 + c512, c512, n(3)),
            Conv(c512, c512, 3, 2), nn.Identity(), C2f(c512 + c1024, c1024, n(3)),
            Detect(nc, (c256, c512, c1024)),
        ])

    def forward(self, x):
        m = self.model
        p3 = m[4](m[3](m[2](m[1](m[0](x)))))
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        h4 = m[12](torch.cat([m[10](p5), p4], 1))
        h3 = m[15](torch.cat([m[13](h4), p3], 1))
        h4 = m[18](torch.cat([m[16](h3), h4], 1))
        h5 = m[21](torch.cat([m[19](h4), p5], 1))
        det: Detect = m[22]
        boxes: List[torch.Tensor] = []
        probs: List[torch.Tensor] = []
        for f, cv2, cv3, s in zip((h3, h4, h5), det.cv2, det.cv3, self.STRIDES):
            b, _, hh, ww = f.shape
            raw = cv2(f).float().view(b, 4, det.reg_max, hh * ww)
            dist = (raw.softmax(2) * torch.arange(det.reg_max, dtype=torch.float32,
                                                  device=x.device).view(1, 1, -1, 1)).sum(2)
            gy, gx = torch.meshgrid(torch.arange(hh, device=x.device, dtype=torch.float32) + 0.5,
                                    torch.arange(ww, device=x.device, dtype=torch.float32) + 0.5,
                                    indexing="ij")
            ax, ay = gx.reshape(1, -1), gy.reshape(1, -1)
            xyxy = torch.stack([ax - dist[:, 0], ay - dist[:, 1], ax + dist[:, 2], ay + dist[:, 3]], -1)
            boxes.append(xyxy * s)
            probs.append(cv3(f).float().view(b, det.nc, hh * ww).transpose(1, 2))
        return torch.cat(boxes, 1), torch.cat(probs, 1)
