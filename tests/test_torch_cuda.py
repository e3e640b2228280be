"""The mosaic kernel against its plain PyTorch version, on a CUDA card.

Edge cases beyond chip_smoke.py's full-width ones: level 1, 1x1 and
full-frame boxes, boxes wholly outside the frame or empty, many nested
boxes, odd frame sizes, batch 1. Skipped without a CUDA device. This file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from video_desensitization_torch.ops import cuda_mosaic
from video_desensitization_torch.ops.mosaic import mosaic_boxes_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _boxes(rng, b, k, h, w):
    x1 = rng.integers(-w // 4, w, (b, k))
    y1 = rng.integers(-h // 4, h, (b, k))
    boxes = np.stack(
        [x1, y1, x1 + rng.integers(0, w, (b, k)), y1 + rng.integers(0, h, (b, k))], -1
    )
    return boxes.astype(np.int32), rng.random((b, k)) > 0.1


def _check(cuda, frames, boxes, valid, level):
    f = torch.from_numpy(frames).to(cuda)
    bx = torch.from_numpy(boxes).to(cuda)
    ok = torch.from_numpy(valid).to(cuda)
    want = mosaic_boxes_batch(f, bx, ok, level)
    before = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    got = cuda_mosaic.mosaic_boxes_batch_cuda_(f, bx, ok, level)
    torch.cuda.synchronize()
    assert got is f
    assert cuda_mosaic.mosaic_boxes_batch_cuda_.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("level", [1, 3, 8, 13])
@pytest.mark.parametrize("hw", [(1077, 1917), (64, 37), (5, 300)])
def test_kernel_matches_plain(cuda, channels, level, hw):
    rng = np.random.default_rng(level * 10 + channels)
    h, w = hw
    frames = rng.integers(0, 256, (2, h, w, channels), dtype=np.uint8)
    boxes, valid = _boxes(rng, 2, 40, h, w)
    _check(cuda, frames, boxes, valid, level)


def test_kernel_special_boxes(cuda):
    rng = np.random.default_rng(0)
    h, w = 120, 200
    frames = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
    bl = [
        [0, 0, w, h],  # full frame
        [10, 10, 11, 11],  # one pixel
        [-50, -50, -1, -1],  # wholly outside
        [w, 0, w + 10, h],  # starts at the right edge: empty after clipping
        [30, 40, 30, 90],  # zero width
        [-5, 20, w + 5, 60],  # spills both sides
    ] + [[i, i, w - i, h - i] for i in range(0, 60, 3)]  # nested
    boxes = np.array([bl], np.int32)
    valid = np.ones((1, len(bl)), bool)
    _check(cuda, frames, boxes, valid, 8)
    _check(cuda, frames, boxes, np.zeros_like(valid), 8)


def test_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(cuda_mosaic, "mosaic_boxes_batch_", refuse)
    frames = torch.zeros((1, 16, 16, 3), dtype=torch.uint8, device=cuda)
    boxes = torch.tensor([[[0, 0, 8, 8]]], dtype=torch.int32, device=cuda)
    valid = torch.ones((1, 1), dtype=torch.bool, device=cuda)
    cuda_mosaic.mosaic_boxes_batch_cuda_(frames, boxes, valid, 8)
    with pytest.raises(ValueError):
        cuda_mosaic.mosaic_boxes_batch_cuda_(frames[:, :, :8], boxes, valid, 8)
