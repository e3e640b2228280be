"""The port's anchors, box math, NMS and letterbox against the JAX package's,
on the same numpy inputs."""

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_desensitization_tpu.ops import anchors as jax_anchors
from video_desensitization_tpu.ops import boxes as jax_boxes
from video_desensitization_tpu.ops import image as jax_image
from video_desensitization_tpu.ops.nms import batched_nms_padded as jax_nms

from video_desensitization_torch.ops import anchors, boxes, image
from video_desensitization_torch.ops.nms import batched_nms_padded, nms_padded


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are tiny and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


T = torch.from_numpy


@pytest.mark.parametrize("hw", [(128, 128), (640, 640), (96, 160), (1080, 1920)])
def test_anchors_exact(hw):
    assert anchors.feature_map_shapes(hw) == jax_anchors.feature_map_shapes(hw)
    np.testing.assert_array_equal(
        anchors.generate_anchors(hw), jax_anchors.generate_anchors(hw)
    )


def test_decode_iou_and_correction_match():
    rng = np.random.default_rng(0)
    priors = jax_anchors.generate_anchors((128, 128))
    a = priors.shape[0]
    loc = rng.normal(0, 1, (2, a, 4)).astype(np.float32)
    landm = rng.normal(0, 1, (2, a, 10)).astype(np.float32)
    np.testing.assert_allclose(
        boxes.decode_boxes(T(loc), T(priors.copy())).numpy(),
        np.asarray(jax_boxes.decode_boxes(jnp.asarray(loc), priors)),
        rtol=0, atol=1e-5,
    )
    np.testing.assert_allclose(
        boxes.decode_landmarks(T(landm), T(priors.copy())).numpy(),
        np.asarray(jax_boxes.decode_landmarks(jnp.asarray(landm), priors)),
        rtol=0, atol=1e-5,
    )
    b1 = rng.uniform(0, 100, (3, 7, 4)).astype(np.float32)
    b2 = rng.uniform(0, 100, (3, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        boxes.pairwise_iou(T(b1), T(b2)).numpy(),
        np.asarray(jax_boxes.pairwise_iou(jnp.asarray(b1), jnp.asarray(b2))),
        rtol=0, atol=1e-6,
    )
    dets = rng.uniform(0, 1, (2, 9, 15)).astype(np.float32)
    shapes = np.array([[1080, 1920], [96, 160]], np.float32)
    got = boxes.letterbox_correction(T(dets), (128, 128), T(shapes))
    want = jax_boxes.letterbox_correction(jnp.asarray(dets), (128, 128), jnp.asarray(shapes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        boxes.scale_to_pixels(got, T(shapes)).numpy(),
        np.asarray(jax_boxes.scale_to_pixels(want, jnp.asarray(shapes))),
        rtol=1e-6, atol=1e-4,
    )


def random_dets(n, seed, w=640, h=640):
    """tests/test_nms.py's generator: boxes, scores, 10 extra columns."""
    rng = np.random.default_rng(seed)
    xy1 = rng.uniform(0, 0.8, (n, 2)) * [w, h]
    wh = rng.uniform(10, 150, (n, 2))
    bx = np.concatenate([xy1, xy1 + wh], -1)
    return np.concatenate([bx, rng.uniform(0, 1, (n, 1)), rng.normal(size=(n, 10))], -1).astype(
        np.float32
    )


def _assert_nms_equal(dets, conf, iou, top_k):
    got, keep = batched_nms_padded(T(dets), conf, iou, top_k)
    want, want_keep = jax_nms(jnp.asarray(dets), conf, iou, top_k)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("conf,iou", [(0.5, 0.45), (0.02, 0.3)])
def test_nms_keep_and_order_match(conf, iou):
    dets = np.stack([random_dets(300, seed=s) for s in range(3)])
    _assert_nms_equal(dets, conf, iou, 128)
    _assert_nms_equal(dets, conf, iou, 300)


def test_nms_score_ties_keep_lower_index_first():
    """Equal scores, overlapping and not, plus padded -inf rows: a stable
    descending sort matches lax.top_k's tie order."""
    dets = random_dets(40, seed=5)
    dets[:, 4] = np.repeat([0.9, 0.7, 0.3, 0.6], 10)  # 0.3 rows are padded
    dets[10:14, :4] = dets[0, :4] + np.arange(4)[:, None]  # tied and overlapping
    _assert_nms_equal(dets[None], 0.5, 0.45, 40)
    _assert_nms_equal(dets[None], 0.5, 0.45, 16)


def test_nms_deep_suppression_chain():
    """tests/test_nms.py:104: box i overlaps only box i+1; greedy keeps the
    even boxes after ~n/2 fixpoint rounds."""
    n = 64
    dets = np.zeros((n, 15), np.float32)
    for i in range(n):
        dets[i, :4] = [i * 30.0, 0.0, i * 30.0 + 100.0, 100.0]
        dets[i, 4] = 1.0 - i * 1e-3
    _assert_nms_equal(dets[None], 0.5, 0.45, n)
    _, keep = nms_padded(T(dets), 0.5, 0.45, n)
    assert np.array_equal(np.flatnonzero(keep.numpy()), np.arange(0, n, 2))


@pytest.mark.parametrize("src", [(1080, 1920), (100, 313)])
def test_letterbox_canvas_bitwise_vs_jax_and_cv2(src):
    """1080p -> 640 (downscale) and 100x313 -> 640 (upscale)."""
    rng = np.random.default_rng(src[0])
    frames = rng.integers(0, 256, (2, *src, 3), dtype=np.uint8)
    formula = image.letterbox_canvas_formula(src, (640, 640))
    assert formula is not None
    assert formula == jax_image.letterbox_canvas_formula(src, (640, 640))
    got = image.letterbox_canvas_u8(T(frames), (640, 640), formula=formula).numpy()
    want = np.asarray(jax_image.letterbox_canvas_u8(jnp.asarray(frames), (640, 640), formula=formula))
    np.testing.assert_array_equal(got, want)
    for i in range(2):
        np.testing.assert_array_equal(got[i], jax_image.letterbox_host(frames[i], (640, 640)))


@pytest.mark.parametrize(
    "src,dst",
    [((1080, 1920), (360, 640)), ((480, 640), (360, 640)), ((97, 131), (41, 59)),
     ((360, 640), (640, 1138)), ((64, 64), (64, 64))],
)
def test_resize_linear_cv2_exact_bitwise(src, dst):
    """Select, general, upscale and identity geometries (test_image.py:71)."""
    formula = image.cv2_resize_formula(src, dst)
    assert formula == jax_image.cv2_resize_formula(src, dst)
    imgs = np.random.default_rng(7).integers(0, 256, (2, *src, 3), dtype=np.uint8)
    got = image.resize_linear_cv2_exact(T(imgs), dst, formula).numpy()
    for i in range(2):
        want = cv2.resize(imgs[i], (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(got[i], want)


def test_float_letterbox_and_preprocess_match():
    """The float fallback (bilinear, no antialias) within 1e-3 of
    jax.image.resize; the exact preprocess bitwise."""
    frames = np.random.default_rng(9).integers(0, 256, (2, 96, 160, 3), dtype=np.uint8)
    got = image.letterbox_device(T(frames), (128, 128)).numpy()
    want = np.asarray(jax_image.letterbox_device(jnp.asarray(frames), (128, 128)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    for exact in ("auto", "never"):
        got = image.preprocess_batch_device(T(frames), (128, 128), exact=exact).numpy()
        want = np.asarray(jax_image.preprocess_batch_device(jnp.asarray(frames), (128, 128), exact=exact))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 if exact == "never" else 0)
    assert image.letterbox_params((1080, 1920), (640, 640)) == jax_image.letterbox_params(
        (1080, 1920), (640, 640)
    )
