"""RetinaFace detection network.

Backbone (resnet50 layer2/3/4 or mobilenet0.25 stage1/2/3) -> FPN -> 3x SSH
-> three head triples whose per-level outputs concatenate over the anchor
axis to (B, A_total, {4 | 2 | 10}); eval mode applies a float32 softmax to
the class logits. Module names are the reference checkpoints' keys.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from video_desensitization_torch.models.layers import FPN, SSH, PredictionHead
from video_desensitization_torch.models.mobilenet import MobileNetV1Features
from video_desensitization_torch.models.resnet import ResNet50Features


class RetinaFace(nn.Module):
    def __init__(self, cfg: dict, mode: str = "eval"):
        super().__init__()
        self.mode = mode
        in_ch = cfg["in_channel"]
        out_ch = cfg["out_channel"]
        if cfg["name"] == "mobilenet0.25":
            self.body = MobileNetV1Features()
        else:
            self.body = ResNet50Features()
        self.fpn = FPN([in_ch * 2, in_ch * 4, in_ch * 8], out_ch)
        self.ssh1 = SSH(out_ch, out_ch)
        self.ssh2 = SSH(out_ch, out_ch)
        self.ssh3 = SSH(out_ch, out_ch)
        self.ClassHead = nn.ModuleList([PredictionHead(out_ch, 2) for _ in range(3)])
        self.BboxHead = nn.ModuleList([PredictionHead(out_ch, 4) for _ in range(3)])
        self.LandmarkHead = nn.ModuleList([PredictionHead(out_ch, 10) for _ in range(3)])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, 3, H, W) -> (bbox (B, A, 4), cls (B, A, 2), landm (B, A, 10))."""
        fpn = self.fpn(self.body(x))
        feats = [ssh(f) for ssh, f in zip((self.ssh1, self.ssh2, self.ssh3), fpn)]
        bbox = torch.cat([h(f) for h, f in zip(self.BboxHead, feats)], dim=1)
        cls = torch.cat([h(f) for h, f in zip(self.ClassHead, feats)], dim=1)
        landm = torch.cat([h(f) for h, f in zip(self.LandmarkHead, feats)], dim=1)
        if self.mode == "train" or self.training:
            return bbox, cls, landm
        return bbox, torch.softmax(cls.to(torch.float32), dim=-1), landm
