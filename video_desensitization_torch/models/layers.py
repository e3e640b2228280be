"""FPN, SSH and prediction heads.

* FPN: 1x1 lateral convs + nearest upsample + add + 3x3 merges.
* SSH: parallel 3x3 / 5x5 (two 3x3) / 7x7 (three 3x3) branches, channel
  concat, ReLU. leaky = 0.1 iff channels <= 64.
* Heads: 1x1 convs emitting per-anchor (2 | 4 | 10) values, permuted to
  NHWC before the reshape to (B, H*W*anchors, C) so rows line up with
  ``ops.anchors.generate_anchors``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn

from video_desensitization_torch.models.common import conv_bn, conv_bn1x1, conv_bn_no_relu


def upsample_nearest(x: torch.Tensor, target_hw) -> torch.Tensor:
    """Nearest upsample of NCHW ``x`` with the integer source index
    ``floor(dst * h / th)`` (a float scale can pick another row)."""
    _, _, h, w = x.shape
    th, tw = target_hw
    rows = torch.arange(th, device=x.device) * h // th
    cols = torch.arange(tw, device=x.device) * w // tw
    return x.index_select(2, rows).index_select(3, cols)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int):
        super().__init__()
        leaky = 0.1 if out_channels <= 64 else 0.0
        self.output1 = conv_bn1x1(in_channels[0], out_channels, 1, leaky)
        self.output2 = conv_bn1x1(in_channels[1], out_channels, 1, leaky)
        self.output3 = conv_bn1x1(in_channels[2], out_channels, 1, leaky)
        self.merge1 = conv_bn(out_channels, out_channels, 1, leaky)
        self.merge2 = conv_bn(out_channels, out_channels, 1, leaky)

    def forward(self, inputs: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
        out1 = self.output1(inputs[1])
        out2 = self.output2(inputs[2])
        out3 = self.output3(inputs[3])
        out2 = self.merge2(out2 + upsample_nearest(out3, out2.shape[2:]))
        out1 = self.merge1(out1 + upsample_nearest(out2, out1.shape[2:]))
        return [out1, out2, out3]


class SSH(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        assert out_channels % 4 == 0
        leaky = 0.1 if out_channels <= 64 else 0.0
        half, quarter = out_channels // 2, out_channels // 4
        self.conv3X3 = conv_bn_no_relu(in_channels, half)
        self.conv5X5_1 = conv_bn(in_channels, quarter, 1, leaky)
        self.conv5X5_2 = conv_bn_no_relu(quarter, quarter)
        self.conv7X7_2 = conv_bn(quarter, quarter, 1, leaky)
        self.conv7x7_3 = conv_bn_no_relu(quarter, quarter)

    def forward(self, x):
        c3 = self.conv3X3(x)
        c5_1 = self.conv5X5_1(x)
        c5 = self.conv5X5_2(c5_1)
        c7 = self.conv7x7_3(self.conv7X7_2(c5_1))
        return torch.relu(torch.cat([c3, c5, c7], dim=1))


class PredictionHead(nn.Module):
    """1x1 conv head -> (B, H*W*num_anchors, out_dim)."""

    def __init__(self, in_channels: int, out_dim: int, num_anchors: int = 2):
        super().__init__()
        self.out_dim = out_dim
        self.conv1x1 = nn.Conv2d(in_channels, num_anchors * out_dim, 1)

    def forward(self, x):
        out = self.conv1x1(x).permute(0, 2, 3, 1)
        return out.reshape(out.shape[0], -1, self.out_dim)
