"""The port's I420 path against the JAX package's: the cv2-exact I420 -> RGB
conversion, the plane split, chroma boxes, the plain I420 mosaic and its
cv2 oracle, the I420 wrapper on CPU tensors (and the views its kernel calls
take on a card), and ``process_batch_yuv`` of the engine: 96x160 frames,
input 128, RetinaFace-mobilenet + YOLOv8n in float32, mosaic level 8, the
JAX package's weights carried over with ``from_jax_variables``."""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_desensitization_tpu.detect.face import Retinaface as JaxRetinaface
from video_desensitization_tpu.detect.plate import PlateDetector as JaxPlateDetector
from video_desensitization_tpu.ops.mosaic import (
    chroma_boxes as jax_chroma_boxes,
    mosaic_i420_batch as jax_mosaic_i420,
    mosaic_i420_host_inplace as jax_i420_oracle,
)
from video_desensitization_tpu.ops.yuv import i420_to_rgb_u8 as jax_i420_to_rgb
from video_desensitization_tpu.ops.yuv import split_i420 as jax_split_i420
from video_desensitization_tpu.pipeline.engine import DesensitizationEngine as JaxEngine

from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.detect.plate import PlateDetector
from video_desensitization_torch.models.convert import from_jax_variables
from video_desensitization_torch.ops import cuda_mosaic
from video_desensitization_torch.ops.mosaic import (
    chroma_boxes,
    mosaic_boxes_batch_,
    mosaic_host_reference,
    mosaic_i420_batch,
    mosaic_i420_host_inplace,
)
from video_desensitization_torch.ops.yuv import (
    i420_to_rgb_u8,
    join_i420,
    rgb_to_i420_host,
    split_i420,
)
from video_desensitization_torch.pipeline.engine import DesensitizationEngine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are small and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _all_triples():
    """64 I420 images of 512x512 holding every (Y, U, V) triple: each 2x2
    luma block shares one of the 65,536 (U, V) pairs, and its four Y values
    step with the image (tests/test_yuv.py)."""
    h = w = 512
    u, v = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8))
    base = np.empty((h * 3 // 2, w), np.uint8)
    base[h : h + h // 4] = u.reshape(h // 4, w)
    base[h + h // 4 :] = v.reshape(h // 4, w)
    batch = np.repeat(base[None], 64, axis=0)
    for step in range(64):
        block = np.array([[4 * step, 4 * step + 1], [4 * step + 2, 4 * step + 3]], np.uint8)
        batch[step, :h] = np.tile(block, (h // 2, w // 2))
    return batch, h, w


def test_i420_to_rgb_u8_exhaustive_vs_jax_and_cv2():
    batch, h, w = _all_triples()
    got = i420_to_rgb_u8(torch.from_numpy(batch), h, w).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_i420_to_rgb(jnp.asarray(batch), h, w)))
    for i in (0, 21, 63):
        np.testing.assert_array_equal(got[i], cv2.cvtColor(batch[i], cv2.COLOR_YUV2RGB_I420))


@pytest.mark.parametrize("hw", [(64, 96), (98, 162)], ids=["h%4==0", "h%4==2"])
def test_split_join_round_trip(hw):
    """Planes cut at byte offsets: equal to the JAX package's row split
    where H is a multiple of 4, and cv2's layout at H = 98 too."""
    h, w = hw
    yuv = np.random.default_rng(0).integers(0, 256, (3, h * 3 // 2, w), dtype=np.uint8)
    planes = split_i420(torch.from_numpy(yuv), h, w)
    assert [tuple(p.shape) for p in planes] == [(3, h, w), (3, h // 2, w // 2), (3, h // 2, w // 2)]
    np.testing.assert_array_equal(join_i420(*planes).numpy(), yuv)
    rgb = i420_to_rgb_u8(torch.from_numpy(yuv), h, w).numpy()
    np.testing.assert_array_equal(rgb[1], cv2.cvtColor(yuv[1], cv2.COLOR_YUV2RGB_I420))
    if h % 4 == 0:
        for mine, theirs in zip(planes, jax_split_i420(jnp.asarray(yuv), h, w)):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_rgb_to_i420_host_matches_cv2():
    rgb = np.random.default_rng(1).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    np.testing.assert_array_equal(rgb_to_i420_host(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420))


def test_chroma_boxes_floor_negative_and_odd_edges():
    edges = np.array([-7, -6, -5, -2, -1, 0, 1, 2, 3, 95, 96, 97, 159, 160, 161, 6_300_001, -6_300_001])
    rng = np.random.default_rng(2)
    boxes = rng.choice(edges, (4, 9, 4)).astype(np.int32)
    got = chroma_boxes(torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_chroma_boxes(jnp.asarray(boxes))))
    assert chroma_boxes(torch.tensor([[-3, -1, -3, -1]])).tolist() == [[-2, -1, -1, 0]]


H, W = 96, 160


def _i420_boxes(rng, b=3, k=7, h=H, w=W):
    """Overlapping boxes, some spilling past every edge, with odd and
    negative coordinates; frame 1 has no valid box."""
    x1, y1 = rng.integers(-w // 3, w, (b, k)), rng.integers(-h // 3, h, (b, k))
    boxes = np.stack(
        [x1, y1, x1 + rng.integers(1, w, (b, k)), y1 + rng.integers(1, h, (b, k))], -1
    ).astype(np.int32)
    valid = rng.random((b, k)) > 0.2
    valid[1] = False
    return boxes, valid


@pytest.mark.parametrize("level", [1, 3, 8])
def test_plain_i420_mosaic_bitwise_vs_jax_and_cv2(level):
    rng = np.random.default_rng(level)
    yuv = rng.integers(0, 256, (3, H * 3 // 2, W), dtype=np.uint8)
    boxes, valid = _i420_boxes(rng)
    got = mosaic_i420_batch(torch.from_numpy(yuv), torch.from_numpy(boxes), torch.from_numpy(valid), level)
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_mosaic_i420(jnp.asarray(yuv), boxes, valid, level)))
    np.testing.assert_array_equal(got[1], yuv[1])
    for i in range(3):
        kept = boxes[i][valid[i]].tolist()
        np.testing.assert_array_equal(got[i], jax_i420_oracle(yuv[i].copy(), kept, level))
        np.testing.assert_array_equal(got[i], mosaic_i420_host_inplace(yuv[i].copy(), kept, level))
        np.testing.assert_array_equal(got[i, :H], mosaic_host_reference(yuv[i, :H], kept, level))
    assert (got != yuv).any() == (level > 1)  # level 1 is the identity


def test_i420_wrapper_on_cpu_is_in_place_plain_and_uncounted():
    rng = np.random.default_rng(4)
    yuv = rng.integers(0, 256, (3, H * 3 // 2, W), dtype=np.uint8)
    boxes, valid = _i420_boxes(rng)
    bx, ok = torch.from_numpy(boxes), torch.from_numpy(valid)
    want = mosaic_i420_batch(torch.from_numpy(yuv), bx, ok, 8)
    work = torch.from_numpy(yuv.copy())
    before = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    assert cuda_mosaic.mosaic_i420_batch_cuda_(work, bx, ok, 8) is work
    assert torch.equal(work, want)
    assert cuda_mosaic.mosaic_boxes_batch_cuda_.launches == before


@pytest.mark.parametrize("hw,level", [((96, 160), 8), ((98, 162), 3), ((64, 40), 1)])
def test_kernel_calls_on_views_equal_the_plain_i420_mosaic(hw, level):
    """The card's two kernel calls, each a view of the I420 buffer (whole
    frames with boxes clipped to Y; six (H/2, W/2) blocks with chroma boxes
    on U and V), run here through the plain in-place mosaic: the result is
    the plain I420 mosaic, in place in the caller's buffer."""
    h, w = hw
    rng = np.random.default_rng(h + level)
    yuv = torch.from_numpy(rng.integers(0, 256, (3, h * 3 // 2, w), dtype=np.uint8))
    boxes, valid = (torch.from_numpy(a) for a in _i420_boxes(rng, h=h, w=w))
    want = mosaic_i420_batch(yuv, boxes, valid, level)
    work = yuv.clone()
    calls = cuda_mosaic.i420_kernel_calls(work, boxes, valid, level)
    assert [c[3] for c in calls] == [level, max(1, level // 2)]
    for frames, bx, ok, lvl in calls:
        assert frames.data_ptr() == work.data_ptr() and frames.is_contiguous()
        mosaic_boxes_batch_(frames, bx, ok, lvl)
    assert torch.equal(work, want)


def test_i420_wrapper_rejects_what_it_does_not_take():
    boxes, valid = torch.zeros((1, 1, 4), dtype=torch.int32), torch.ones((1, 1), dtype=torch.bool)
    mosaic = cuda_mosaic.mosaic_i420_batch_cuda_
    mosaic(torch.zeros((1, 9, 6), dtype=torch.uint8), boxes, valid)  # H = 6, W = 6
    with pytest.raises(ValueError):
        mosaic(torch.zeros((1, 10, 6), dtype=torch.uint8), boxes, valid)  # rows not H*3/2
    with pytest.raises(ValueError):
        mosaic(torch.zeros((1, 9, 7), dtype=torch.uint8), boxes, valid)  # W odd
    with pytest.raises(ValueError):
        mosaic(torch.zeros((1, 9, 6, 1), dtype=torch.uint8), boxes, valid)  # rank 4
    with pytest.raises(ValueError):
        mosaic(torch.zeros((1, 9, 6)), boxes, valid)  # float
    with pytest.raises(ValueError):
        mosaic(torch.zeros((1, 9, 12), dtype=torch.uint8)[:, :, :6], boxes, valid)  # strided
    with pytest.raises(ValueError):
        mosaic(torch.zeros((1, 9, 6), dtype=torch.uint8), boxes, valid, 0)
    with pytest.raises(ValueError):
        mosaic(torch.zeros((2, 9, 6), dtype=torch.uint8), boxes, valid)  # boxes of 1 frame


FACE = dict(backbone="mobilenet", input_shape=[128, 128, 3], max_detections=16)
PLATE = dict(variant="n", input_shape=(128, 128), max_detections=8)


@pytest.fixture(scope="module")
def detectors():
    """JAX detectors (random init) and the port's on the same weights."""
    jface = JaxRetinaface(dtype=jnp.float32, **FACE)
    jplate = JaxPlateDetector(dtype=jnp.float32, **PLATE)
    tree = lambda v: jax.tree.map(np.asarray, dict(v))  # noqa: E731
    face = Retinaface(state_dict=from_jax_variables(tree(jface.variables)),
                      dtype=torch.float32, device="cpu", **FACE)
    plate = PlateDetector(state_dict=from_jax_variables(tree(jplate.variables)),
                          dtype=torch.float32, device="cpu", **PLATE)
    return jface, jplate, face, plate


@pytest.fixture(scope="module")
def yuv_frames():
    rgb = np.random.default_rng(0).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    return np.stack([rgb_to_i420_host(f) for f in rgb])


@pytest.mark.parametrize("share", [True, False], ids=["shared", "per-detector"])
def test_process_batch_yuv_matches_jax(detectors, yuv_frames, share):
    jface, jplate, face, plate = detectors
    jax_engine = JaxEngine(jface, jplate, mosaic_level=8, share_letterbox=share)
    engine = DesensitizationEngine(face, plate, mosaic_level=8, share_letterbox=share)
    got = engine.process_batch_yuv(yuv_frames)
    assert engine.last_letterbox.startswith("shared-") == share
    _, face_px, face_keep, plate_px, plate_keep = (
        np.asarray(o) for o in jax_engine.program(yuv=True)(
            jface.variables, jplate.variables, jnp.asarray(yuv_frames),
            jnp.asarray(np.tile(np.array([[H, W]], np.float32), (2, 1))),
        )
    )
    _, p_face_px, p_face_keep, p_plate_px, p_plate_keep = engine.program(
        torch.from_numpy(yuv_frames.copy()), torch.tensor([[float(H), float(W)]] * 2)
    )
    np.testing.assert_array_equal(p_face_keep.numpy(), face_keep)
    np.testing.assert_array_equal(p_plate_keep.numpy(), plate_keep)
    assert face_keep.any() and plate_keep.any()
    np.testing.assert_allclose(p_face_px.numpy()[..., :4], face_px[..., :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(p_plate_px.numpy()[..., :4], plate_px[..., :4], rtol=0, atol=1e-3)

    want = jax_engine.process_batch_yuv(yuv_frames)
    assert got.frames.shape == yuv_frames.shape and got.frames.dtype == np.uint8
    np.testing.assert_array_equal(got.frames, want.frames)
    assert got.num_faces == want.num_faces and got.num_plates == want.num_plates
    for g, w in zip(got.face_boxes + got.plate_boxes, want.face_boxes + want.plate_boxes):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=1e-3)

    # The same detections as the RGB path on the cv2 conversion of the frames.
    rgb = np.stack([cv2.cvtColor(f, cv2.COLOR_YUV2RGB_I420) for f in yuv_frames])
    on_rgb = engine.process_batch(rgb)
    assert on_rgb.face_boxes == got.face_boxes and on_rgb.plate_boxes == got.plate_boxes

    # The port's plain I420 mosaic on the JAX engine's own int32 boxes.
    boxes = np.concatenate([face_px[..., :4], plate_px[..., :4]], 1).astype(np.int32)
    valid = np.concatenate([face_keep, plate_keep], 1)
    mine = mosaic_i420_batch(torch.from_numpy(yuv_frames), torch.from_numpy(boxes),
                             torch.from_numpy(valid), 8)
    np.testing.assert_array_equal(mine.numpy(), want.frames)


def test_process_batch_yuv_gaussian_shape_and_odd_sizes(detectors, yuv_frames):
    _, _, face, plate = detectors
    gauss = DesensitizationEngine(face, plate, anonymizer="gaussian")
    g = gauss.process_batch_yuv(yuv_frames)
    assert g.frames.shape == yuv_frames.shape and g.frames.dtype == np.uint8
    assert g.num_faces > 0 and (g.frames != yuv_frames).any()
    engine = DesensitizationEngine(face, plate)
    for shape in [(2, 9 * 3 // 2 + 1, 16), (2, 144, 161), (2, 145, 160)]:
        with pytest.raises(ValueError):
            engine.process_batch_yuv(np.zeros(shape, np.uint8))
    with pytest.raises(ValueError):
        engine.process_batch(yuv_frames)
    with pytest.raises(ValueError):
        engine.process_batch_yuv(np.zeros((2, H, W, 3), np.uint8))
