"""The port's mosaic against the JAX package's.

Same numpy inputs into: the port's plain PyTorch mosaic (the oracle the
CUDA kernel is held against on the card), JAX ``mosaic_boxes_batch`` (XLA
scan), JAX ``mosaic_boxes_batch_pallas`` in interpret mode, and the cv2
host reference. All bitwise. Then a numpy mirror of the CUDA kernel's own
rule (snapshot of source rows, tiles, reachable-box lists, per-pixel
walks) against the plain mosaic, since the kernel itself runs only on a
card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_desensitization_tpu.ops.mosaic import (
    composed_mosaic_table as jax_table,
    mosaic_boxes_batch as jax_mosaic,
    mosaic_host_reference,
)
from video_desensitization_tpu.ops.pallas_mosaic import mosaic_boxes_batch_pallas

from video_desensitization_torch.ops import cuda_mosaic
from video_desensitization_torch.ops.mosaic import (
    composed_mosaic_table,
    gaussian_blur_boxes,
    mosaic_boxes_batch,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are tiny and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


H, W = 256, 128


def _padded(bl, k=8):
    k = max(k, len(bl))
    boxes = np.array([list(bl) + [[0, 0, 0, 0]] * (k - len(bl))], np.int32)
    valid = np.array([[True] * len(bl) + [False] * (k - len(bl))])
    return boxes, valid


def _port(frames, boxes, valid, level):
    return mosaic_boxes_batch(
        torch.from_numpy(frames), torch.from_numpy(boxes), torch.from_numpy(valid), level
    ).numpy()


@pytest.mark.parametrize("level,maxdim", [(4, 300), (8, 512), (12, 257)])
def test_table_equals_jax(level, maxdim):
    np.testing.assert_array_equal(
        composed_mosaic_table(level, maxdim), jax_table(level, maxdim)
    )


# Box lists from tests/test_pallas_mosaic.py, plus invalid/empty entries.
CASES = {
    "short": [[10, 20, 60, 90]],
    "tall": [[50, 70, 100, 200]],
    "clipped_oob": [[-5, 240, 200, 400]],
    "overlapping": [[10, 20, 60, 90], [50, 70, 100, 200]],
    "full_frame": [[0, 0, W, H]],
    "thin": [[30, 30, 34, 37], [100, 10, W, 30]],
    "many": [[i * 7, i * 11 % 200, i * 7 + 20, i * 11 % 200 + 31] for i in range(8)],
    "bottom_overlap_pair": [[10, 150, 100, H], [40, 180, 120, 250]],
    "full_frame_then_bottom": [[0, 0, W, H], [30, 200, 60, H]],
    "empty_and_outside": [[40, 40, 40, 90], [300, 10, 400, 50], [20, 30, 70, 80]],
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_plain_mosaic_bitwise_vs_jax_and_cv2(name, channels):
    rng = np.random.default_rng(sorted(CASES).index(name))
    frame = rng.integers(0, 255, (H, W, channels), dtype=np.uint8)
    bl = CASES[name]
    boxes, valid = _padded(bl)
    got = _port(frame[None], boxes, valid, 8)[0]
    np.testing.assert_array_equal(
        got, np.asarray(jax_mosaic(jnp.asarray(frame[None]), boxes, valid, 8))[0]
    )
    for ch in range(channels):
        np.testing.assert_array_equal(got[..., ch], mosaic_host_reference(frame[..., ch], bl, 8))


@pytest.mark.parametrize("channels,level", [(1, 8), (2, 4), (3, 8), (3, 12)])
def test_plain_mosaic_bitwise_vs_pallas_interpret(channels, level):
    """Overlapping, spilling, invalid and empty boxes; level 12 is beyond
    the TPU kernel's lookback (its wrapper falls back to XLA)."""
    rng = np.random.default_rng(channels * 100 + level)
    frame = rng.integers(0, 255, (2, H, W, channels), dtype=np.uint8)
    bl = [[10, 20, 60, 90], [50, 70, 100, 200], [-10, 230, 90, H + 40], [0, 0, 0, 50]]
    boxes = np.array([bl, bl[::-1]], np.int32)
    valid = np.array([[True, True, True, True], [True, False, True, True]])
    want = np.asarray(
        mosaic_boxes_batch_pallas(jnp.asarray(frame), boxes, valid, level, interpret=True)
    )
    np.testing.assert_array_equal(_port(frame, boxes, valid, level), want)


def test_random_boxes_bitwise_vs_cv2():
    """tests/test_mosaic.py:66: random spilling boxes, 8 trials."""
    rng = np.random.default_rng(12)
    h, w, k = 240, 320, 6
    for trial in range(8):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        x1 = rng.integers(-30, w + 10, k)
        y1 = rng.integers(-30, h + 10, k)
        boxes = np.stack(
            [x1, y1, x1 + rng.integers(1, 120, k), y1 + rng.integers(1, 120, k)], -1
        ).astype(np.int32)
        valid = rng.random(k) > 0.2
        got = _port(img[None], boxes[None], valid[None], 8)[0]
        np.testing.assert_array_equal(
            got, mosaic_host_reference(img, boxes[valid]), err_msg=f"trial {trial}"
        )


@pytest.mark.parametrize("level", [4, 8, 12])
def test_sequential_overlap_and_levels_vs_jax(level):
    """tests/test_mosaic.py:80 and :104: nested overlapping boxes apply in
    order; other levels."""
    rng = np.random.default_rng(level)
    img = rng.integers(0, 255, (100, 110, 3), dtype=np.uint8)
    boxes = np.array([[[5, 5, 70, 70], [30, 30, 95, 95], [0, 0, 110, 100]]], np.int32)
    valid = np.ones((1, 3), bool)
    got = _port(img[None], boxes, valid, level)[0]
    np.testing.assert_array_equal(
        got, np.asarray(jax_mosaic(jnp.asarray(img[None]), boxes, valid, level))[0]
    )
    np.testing.assert_array_equal(got, mosaic_host_reference(img, boxes[0], level))


def test_minimum_height_and_spill_clip_vs_cv2():
    """tests/test_pallas_mosaic.py:58 and :117: near-total overlap of a
    full-height box, and spilling boxes clipped to the frame."""
    rng = np.random.default_rng(3)
    f = rng.integers(0, 255, (136, W, 3), dtype=np.uint8)
    bl = [[0, 0, W, 136], [20, 5, 100, 130]]
    np.testing.assert_array_equal(_port(f[None], *_padded(bl), 8)[0], mosaic_host_reference(f, bl, 8))
    f = rng.integers(0, 255, (250, 91, 3), dtype=np.uint8)
    bl = [[40, 100, 91 + 30, 250 + 60], [-10, -5, 50, 40]]
    np.testing.assert_array_equal(_port(f[None], *_padded(bl), 8)[0], mosaic_host_reference(f, bl, 8))


def test_wrapper_on_cpu_is_in_place_plain_and_uncounted():
    """A CPU tensor takes the plain version, in place, and launches nothing."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (2, 64, 96, 2), dtype=np.uint8)
    boxes = np.array([[[5, 5, 60, 50], [-3, 20, 200, 70]]] * 2, np.int32)
    valid = np.array([[True, True], [False, True]])
    want = _port(frames, boxes, valid, 4)
    work = torch.from_numpy(frames.copy())
    before = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    out = cuda_mosaic.mosaic_boxes_batch_cuda_(work, torch.from_numpy(boxes), torch.from_numpy(valid), 4)
    assert out is work
    np.testing.assert_array_equal(work.numpy(), want)
    assert cuda_mosaic.mosaic_boxes_batch_cuda_.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    boxes, valid = torch.zeros((1, 1, 4), dtype=torch.int32), torch.ones((1, 1), dtype=torch.bool)
    mosaic = cuda_mosaic.mosaic_boxes_batch_cuda_
    with pytest.raises(ValueError):
        mosaic(torch.zeros((1, 8, 8, 4), dtype=torch.uint8), boxes, valid)
    with pytest.raises(ValueError):
        mosaic(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), boxes, valid, 0)
    with pytest.raises(ValueError):
        mosaic(torch.zeros((1, 8, 8, 3)), boxes, valid)
    with pytest.raises(ValueError):
        mosaic(torch.zeros((1, 8, 16, 3), dtype=torch.uint8)[:, :, :8], boxes, valid)


@pytest.mark.parametrize("level", [1, 2, 3, 4, 8, 12, 16])
def test_kernel_precondition_holds_for_1080p(level):
    """The kernel bounds the sources of a run of rows or columns of a box by
    the sources of the run's first and last; that is exact only if every row
    of T is non-decreasing and stays inside its extent. The wrapper checks
    it per table; here for every extent of a 1080p frame."""
    table = cuda_mosaic._device_table(level, 1920, torch.device("cpu"))
    assert table.shape == (1921, 1920) and table.dtype == torch.int16


def _kernel_mirror(frames, boxes, valid, level, tile_rows=32, tile_cols=None, max_boxes=128):
    """numpy mirror of csrc/mosaic.cu on a (B, H, W, C) batch: passes of
    ``max_boxes`` boxes. In each, the snapshot copies every box's source rows
    inside its columns into a scratch frame that holds junk elsewhere. Then,
    for each tile of ``tile_rows`` rows by ``tile_cols`` pixels (the
    kernel's: 256 for C = 1, else 128), the list of reachable boxes, last
    first, from a rectangle grown by the sources of its part of each box it
    meets; a tile with none stays as it is. Then each pixel's walk over that
    list: a pixel whose q is not p takes q's bytes from the scratch, the
    others keep their own."""
    bsz, h, w, c = frames.shape
    tile_cols = tile_cols or (256 if c == 1 else 128)
    table = composed_mosaic_table(level, max(h, w)).astype(np.int64)
    x1, x2 = np.clip(boxes[..., 0], 0, w), np.clip(boxes[..., 2], 0, w)
    y1, y2 = np.clip(boxes[..., 1], 0, h), np.clip(boxes[..., 3], 0, h)
    ok = valid & (x2 > x1) & (y2 > y1)
    clipped = np.where(ok[..., None], np.stack([x1, y1, x2, y2], -1), 0)
    out = frames.copy()
    for k0 in range(0, boxes.shape[1], max_boxes):
        before = out.copy()
        snapshot = before ^ 0x5A  # junk wherever the snapshot does not copy
        for f in range(bsz):
            bx = clipped[f, k0:k0 + max_boxes]
            for bx1, by1, bx2, by2 in bx[ok[f, k0:k0 + max_boxes]]:
                rows = np.unique(by1 + table[by2 - by1][: by2 - by1])
                snapshot[f, rows, bx1:bx2] = before[f, rows, bx1:bx2]
            for row0 in range(0, h, tile_rows):
                for col0 in range(0, w, tile_cols):
                    ry1, ry2, rx1, rx2 = row0, min(row0 + tile_rows, h), col0, min(col0 + tile_cols, w)
                    rows, cols = np.arange(ry1, ry2), np.arange(rx1, rx2)
                    reach = []
                    for bx1, by1, bx2, by2 in bx[::-1]:
                        if bx1 >= rx2 or bx2 <= rx1 or by1 >= ry2 or by2 <= ry1:
                            continue
                        ty, tx = table[by2 - by1], table[bx2 - bx1]
                        ry1, ry2 = (min(ry1, by1 + ty[max(ry1, by1) - by1]),
                                    max(ry2, by1 + ty[min(ry2, by2) - 1 - by1] + 1))
                        rx1, rx2 = (min(rx1, bx1 + tx[max(rx1, bx1) - bx1]),
                                    max(rx2, bx1 + tx[min(rx2, bx2) - 1 - bx1] + 1))
                        reach.append((bx1, by1, bx2, by2))
                    if not reach:
                        continue
                    qy, qx = np.meshgrid(rows, cols, indexing="ij")
                    for bx1, by1, bx2, by2 in reach:
                        inside = (qx >= bx1) & (qx < bx2) & (qy >= by1) & (qy < by2)
                        qy[inside] = by1 + table[by2 - by1][qy[inside] - by1]
                        qx[inside] = bx1 + table[bx2 - bx1][qx[inside] - bx1]
                    moved = (qy != rows[:, None]) | (qx != cols)
                    tile = out[f, rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
                    tile[moved] = snapshot[f][qy[moved], qx[moved]]
    return out


MIRROR_H, MIRROR_W = 96, 112
MIRROR_CASES = {
    # each box overlaps the next, so sources pass through several boxes
    "chain": [[5, 5, 40, 37], [30, 20, 70, 61], [55, 40, 100, 90], [10, 50, 60, 95], [0, 30, 112, 44]],
    # the first box lies wholly inside the second, which owns all of it
    "covered": [[20, 20, 50, 50], [10, 10, 70, 70], [60, 0, 112, 30]],
    # extents 10, 23, 37, 91: no multiple of 3 or 8, so cells read back
    "odd_extents": [[3, 4, 13, 14], [40, 7, 63, 30], [2, 50, 39, 87], [8, 2, 99, 93]],
    # the second box's sources lie where the first writes, and the reverse
    "read_each_other": [[0, 0, 60, 60], [50, 50, 112, 96], [30, 30, 80, 80]],
}


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("level", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(MIRROR_CASES))
def test_kernel_rule_mirror_bitwise_vs_plain(name, level, channels):
    """The kernel's rule, mirrored in numpy, against the plain in-order
    mosaic: at the kernel's tile size, and at a small one with boxes in
    passes of two, so that walks cross many tiles and passes."""
    rng = np.random.default_rng(sorted(MIRROR_CASES).index(name) * 10 + level)
    frames = rng.integers(0, 256, (2, MIRROR_H, MIRROR_W, channels), dtype=np.uint8)
    bl = MIRROR_CASES[name]
    boxes = np.array([bl, bl[::-1]], np.int32)
    valid = np.ones(boxes.shape[:2], bool)
    valid[1, 1] = False
    want = _port(frames, boxes, valid, level)
    np.testing.assert_array_equal(_kernel_mirror(frames, boxes, valid, level), want)
    np.testing.assert_array_equal(
        _kernel_mirror(frames, boxes, valid, level, tile_rows=4, tile_cols=5, max_boxes=2), want
    )


@pytest.mark.parametrize("seed", range(40))
def test_kernel_rule_mirror_random_boxes(seed):
    """Random overlapping, spilling, invalid and empty boxes; level 40 is
    larger than most boxes and than the frame."""
    rng = np.random.default_rng(1000 + seed)
    channels = int(rng.integers(1, 4))
    level = int(rng.choice([1, 2, 3, 5, 8, 40]))
    k = int(rng.integers(1, 13))
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 48))
    frames = rng.integers(0, 256, (1, h, w, channels), dtype=np.uint8)
    x1, y1 = rng.integers(-8, w + 2, (1, k)), rng.integers(-8, h + 2, (1, k))
    boxes = np.stack(
        [x1, y1, x1 + rng.integers(0, w + 8, (1, k)), y1 + rng.integers(0, h + 8, (1, k))], -1
    ).astype(np.int32)
    valid = rng.random((1, k)) > 0.2
    got = _kernel_mirror(frames, boxes, valid, level, tile_rows=3, tile_cols=4, max_boxes=5)
    np.testing.assert_array_equal(got, _port(frames, boxes, valid, level))


def test_gaussian_blur_boxes_matches_jax():
    from video_desensitization_tpu.ops.mosaic import gaussian_blur_boxes as jax_blur

    rng = np.random.default_rng(21)
    frames = rng.integers(0, 255, (2, 64, 80, 3), dtype=np.uint8)
    boxes = np.array([[[8, 8, 40, 40], [30, 20, 90, 70]], [[0, 0, 0, 0], [-5, 10, 30, 50]]], np.int32)
    valid = np.array([[True, True], [True, True]])
    got = gaussian_blur_boxes(torch.from_numpy(frames), torch.from_numpy(boxes), torch.from_numpy(valid)).numpy()
    want = np.asarray(jax_blur(jnp.asarray(frames), boxes, valid))
    # Float blur rounded to uint8: summation order may move a value that
    # sits on .5 by one step.
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != want).mean() < 1e-3
