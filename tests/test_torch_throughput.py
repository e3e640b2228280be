"""The port's tiered pipeline against the JAX package's ``TieredPipeline``
on the same frames and weights: 96x160 RGB frames (and awkward shapes),
RetinaFace-mobilenet + YOLOv8n at input 128 in float32, confidence 0.01 so
that random weights keep boxes, mosaic level 8.

Held: blurred frames bitwise, keep masks equal, boxes within 1e-4 px (the
networks run in float32 on both sides; the host mosaic casts the boxes to
integers, so a wider error could move a box edge). The host helpers
(letterbox, I420 packing, geometry, gaussian blur) are held bitwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_desensitization_tpu.detect.face import Retinaface as JaxRetinaface
from video_desensitization_tpu.detect.plate import PlateDetector as JaxPlateDetector
from video_desensitization_tpu.ops import image as jax_image
from video_desensitization_tpu.ops import mosaic as jax_mosaic
from video_desensitization_tpu.pipeline import throughput as jax_throughput

from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.detect.plate import PlateDetector
from video_desensitization_torch.models.convert import from_jax_variables
from video_desensitization_torch.ops import image
from video_desensitization_torch.ops import mosaic
from video_desensitization_torch.pipeline import throughput
from video_desensitization_torch.pipeline.throughput import TieredPipeline


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are small and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


FACE = dict(backbone="mobilenet", input_shape=[128, 128, 3], max_detections=16, confidence=0.01)
PLATE = dict(variant="n", input_shape=(128, 128), max_detections=8, confidence=0.01)
BOX_TOL = 1e-4


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
def frames():
    return np.random.default_rng(0).integers(0, 256, (2, 96, 160, 3), dtype=np.uint8)


def assert_results_equal(got, want, tol=BOX_TOL):
    """Frames bitwise, the same boxes kept in the same order, coordinates
    within ``tol`` px."""
    np.testing.assert_array_equal(got.frames, want.frames)
    assert (got.num_faces, got.num_plates) == (want.num_faces, want.num_plates)
    for g, w in zip(got.face_boxes + got.plate_boxes, want.face_boxes + want.plate_boxes):
        assert len(g) == len(w)
        if g:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=tol)


@pytest.mark.parametrize("transfer", ["rgb", "yuv420"])
def test_tiered_matches_jax(detectors, frames, transfer):
    """process_batch and the packed device output, both transfers. On
    yuv420 the detectors see the unrounded float conversion of the I420
    content on both sides."""
    jface, jplate, face, plate = detectors
    jpipe = jax_throughput.TieredPipeline(jface, jplate, mosaic_level=8, transfer=transfer)
    pipe = TieredPipeline(face, plate, mosaic_level=8, transfer=transfer)
    want = jpipe.process_batch(frames)
    got = pipe.process_batch(frames)
    assert got.num_faces > 0 and got.num_plates > 0
    assert_results_equal(got, want)

    content = pipe.letterbox_batch(frames)
    np.testing.assert_array_equal(content, jpipe.letterbox_batch(frames))
    shapes = np.full((2, 2), [96, 160], np.float32)
    mine = pipe._unpack(pipe.dispatch(content, shapes)[0].numpy())
    theirs = jpipe._unpack(np.asarray(jpipe.dispatch(content, shapes)))
    for (px, keep), (jpx, jkeep) in ((mine[:2], theirs[:2]), (mine[2:], theirs[2:])):
        np.testing.assert_array_equal(keep, jkeep)
        np.testing.assert_allclose(px[keep], jpx[jkeep], rtol=0, atol=BOX_TOL)


def test_stream_and_dispatch_finalize_equal_process_batch(detectors):
    """process_stream and the dispatch_batch/finalize_batch split with two
    batches in flight give process_batch's results, in order."""
    _, _, face, plate = detectors
    pipe = TieredPipeline(face, plate, mosaic_level=8)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, (2, 90, 160, 3), dtype=np.uint8) for _ in range(3)]
    want = [pipe.process_batch(b) for b in batches]
    streamed = list(pipe.process_stream(iter(batches)))
    assert len(streamed) == 3
    for got, w in zip(streamed, want):
        assert_results_equal(got, w, tol=0)
    handles = [pipe.dispatch_batch(b) for b in batches[:2]]
    for handle, w in zip(handles, want):
        assert_results_equal(pipe.finalize_batch(handle), w, tol=0)


@pytest.mark.parametrize("hw", [(160, 96), (101, 67), (64, 200)], ids=["portrait", "odd", "wide"])
def test_awkward_geometries(detectors, hw):
    """Portrait, odd and extreme-aspect frames (rgb: yuv420 needs even
    content), faces only: shape kept, frames bitwise equal to the JAX
    pipeline's and to the cv2 mosaic of the port's own boxes."""
    jface, _, face, _ = detectors
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    got = TieredPipeline(face, None, mosaic_level=8).process_batch(frames)
    want = jax_throughput.TieredPipeline(jface, None, mosaic_level=8).process_batch(frames)
    assert got.frames.shape == frames.shape
    assert_results_equal(got, want)
    for i in range(2):
        boxes = [[int(v) for v in b] for b in got.face_boxes[i]]
        np.testing.assert_array_equal(got.frames[i], mosaic.mosaic_host_reference(frames[i], boxes, 8))


def test_yuv420_refuses_odd_content(detectors):
    """(129, 128) frames letterbox to 127-wide content: no I420 form. Both
    packages refuse, naming the transfer."""
    jface, _, face, _ = detectors
    frames = np.zeros((1, 129, 128, 3), np.uint8)
    for pipe in (TieredPipeline(face, None, transfer="yuv420"),
                 jax_throughput.TieredPipeline(jface, None, transfer="yuv420")):
        with pytest.raises(ValueError, match="yuv420"):
            pipe.process_batch(frames)


def test_gaussian_anonymizer(detectors, frames):
    """anonymizer='gaussian': the JAX package's host gaussian on the port's
    own boxes, bitwise, and the rest of each frame untouched."""
    _, _, face, _ = detectors
    got = TieredPipeline(face, None, anonymizer="gaussian").process_batch(frames)
    assert got.num_faces > 0
    for i in range(2):
        boxes = np.asarray(got.face_boxes[i]).astype(np.int64).tolist()
        want = jax_mosaic.gaussian_blur_host_inplace(frames[i].copy(), boxes)
        np.testing.assert_array_equal(got.frames[i], want)
        np.testing.assert_array_equal(got.frames[i], mosaic.gaussian_blur_host_inplace(frames[i].copy(), boxes))
    with pytest.raises(ValueError, match="anonymizer"):
        TieredPipeline(face, None, anonymizer="blur")


def test_float_same_size_letterbox_passes_floats_through():
    """On yuv420 the face program gets an unrounded float32 canvas of its
    own input size. The letterbox must pass it through unchanged, as the
    JAX package's does (its point-sample axes do not cast), and the plate
    program's 114-repad must promote to float32 as jnp.where does."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
    got = image.letterbox_device_auto(torch.from_numpy(x), (128, 128))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(np.asarray(jax_image.letterbox_device_auto(jnp.asarray(x), (128, 128))), x)
    pad = torch.tensor(114, dtype=torch.uint8)
    inside = torch.zeros((2, 128, 128, 1), dtype=torch.bool)
    inside[:, 10:100] = True
    mine = torch.where(inside, torch.from_numpy(x), pad)
    theirs = jnp.where(jnp.asarray(inside.numpy()), jnp.asarray(x), jnp.uint8(114))
    assert mine.dtype == torch.float32 and theirs.dtype == jnp.float32
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def _host_helper_cases():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (96, 160, 3), dtype=np.uint8)
    odd = rng.integers(0, 256, (101, 67, 3), dtype=np.uint8)
    content = throughput.resize_content_u8(rgb, (128, 128))
    yuv = throughput.rgb_to_i420(content)[None]
    shapes = np.array([[1077, 1920], [96, 160], [101, 67]], np.float32)
    boxes = [[-5, 3, 40, 50], [30, 20, 90, 95], [150, 80, 170, 120]]
    return [
        ("letterbox_u8", lambda m: m.letterbox_u8(odd, (128, 128))),
        ("resize_content_u8", lambda m: m.resize_content_u8(rgb, (128, 128))),
        ("rgb_to_i420", lambda m: m.rgb_to_i420(content)),
        ("letterbox_geometry", lambda m: m.letterbox_geometry(shapes, (640, 640))),
        ("letterbox_host", lambda m: m.letterbox_host(odd, (128, 96))),
        ("gaussian_blur_host_inplace", lambda m: m.gaussian_blur_host_inplace(rgb.copy(), boxes)),
        ("i420_to_rgb_device", lambda m: np.asarray(m.i420_to_rgb_device(
            torch.from_numpy(yuv) if m is throughput else jnp.asarray(yuv), *content.shape[:2]))),
    ]


HOST_HELPERS = {
    "letterbox_u8": (throughput, jax_throughput),
    "resize_content_u8": (throughput, jax_throughput),
    "rgb_to_i420": (throughput, jax_throughput),
    "letterbox_geometry": (image, jax_image),
    "letterbox_host": (image, jax_image),
    "gaussian_blur_host_inplace": (mosaic, jax_mosaic),
    "i420_to_rgb_device": (throughput, jax_throughput),
}


@pytest.mark.parametrize("name", list(HOST_HELPERS))
def test_host_helpers_match_jax(name):
    run = dict(_host_helper_cases())[name]
    mine_module, jax_module = HOST_HELPERS[name]
    mine, theirs = run(mine_module), run(jax_module)
    assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
    np.testing.assert_array_equal(mine, theirs)
