"""The yardstick's counts against hand counts."""

import numpy as np
import torch
from torch import nn

from portbench.arith import flops, mosaic_bytes
from portbench.arith.peaks import HBM_BYTES_PER_S


class Stack(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Conv2d(3, 8, 3, 1, 1, bias=False)  # 8x8 out
        self.b = nn.Conv2d(8, 16, 1, 2, 0)  # 4x4 out
        self.c = nn.Conv2d(16, 4, 3, 1, 1, groups=4, bias=False)  # 4x4 out, 4 in a group

    def forward(self, x):
        return self.c(torch.relu(self.b(self.a(x))))


def test_conv_flops_by_hand():
    a = 2 * (3 * 3 * 3) * (2 * 8 * 8 * 8)
    b = 2 * (8 * 1 * 1) * (2 * 16 * 4 * 4)
    c = 2 * (4 * 3 * 3) * (2 * 4 * 4 * 4)
    fwd, wgrad, dgrad = flops.conv_flops(Stack(), (2, 3, 8, 8))
    assert (fwd, wgrad, dgrad) == (a + b + c, a + b + c, b + c)
    assert flops.train_step_flops(Stack(), (2, 3, 8, 8)) == 3 * (a + b + c) - a


def test_mosaic_sectors_on_a_two_box_frame():
    # A 4 x 64 frame of 1 channel, level 8. Box one covers columns 0..15 of
    # row 0: each run of 8 columns takes its first pixel, so 14 pixels
    # move (columns 1..7, 9..15), written in sector 0 (bytes 0..31) and
    # read from the same sector. Box two covers columns 32..47 of rows 2..3,
    # height 2 < level: one row is kept (row 2), so row 3 (columns 32..47,
    # bytes 224..239: sector 7) takes row 2's pixel at each run start
    # (bytes 160 and 168: sector 5), and row 2 moves within sector 5.
    boxes = np.array([[0, 0, 16, 1], [32, 2, 48, 4]], np.float64)
    got = mosaic_bytes.frame_bytes(4, 64, 1, boxes, 8)
    written = {0, 5, 7}
    read = {0, 5}
    assert got == 32 * (len(written) + len(read))
    assert mosaic_bytes.bound_seconds(got) == got / HBM_BYTES_PER_S


def test_no_box_moves_nothing():
    assert mosaic_bytes.frame_bytes(8, 8, 3, np.zeros((0, 4)), 8) == 0
