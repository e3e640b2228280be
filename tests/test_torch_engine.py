"""The port's fused engine against the JAX package's on the same frames and
weights: 96x160 RGB frames, input 128, RetinaFace-mobilenet + YOLOv8n in
float32, mosaic level 8, with the shared letterbox canvas and with each
detector letterboxing on its own."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_desensitization_tpu.detect.face import Retinaface as JaxRetinaface
from video_desensitization_tpu.detect.plate import PlateDetector as JaxPlateDetector
from video_desensitization_tpu.pipeline.engine import DesensitizationEngine as JaxEngine

from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.detect.plate import PlateDetector
from video_desensitization_torch.models.convert import from_jax_variables
from video_desensitization_torch.ops.mosaic import mosaic_boxes_batch
from video_desensitization_torch.pipeline.engine import DesensitizationEngine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are tiny and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


FACE = dict(backbone="mobilenet", input_shape=[128, 128, 3], max_detections=16)
PLATE = dict(variant="n", input_shape=(128, 128), max_detections=8)


def _numpy_tree(variables):
    return jax.tree.map(np.asarray, dict(variables))


@pytest.fixture(scope="module")
def detectors():
    """JAX detectors (random init) and the port's on the same weights."""
    jface = JaxRetinaface(dtype=jnp.float32, **FACE)
    jplate = JaxPlateDetector(dtype=jnp.float32, **PLATE)
    face = Retinaface(
        state_dict=from_jax_variables(_numpy_tree(jface.variables)),
        dtype=torch.float32, device="cpu", **FACE,
    )
    plate = PlateDetector(
        state_dict=from_jax_variables(_numpy_tree(jplate.variables)),
        dtype=torch.float32, device="cpu", **PLATE,
    )
    return jface, jplate, face, plate


@pytest.fixture(scope="module", params=[True, False], ids=["shared", "per-detector"])
def engines(request, detectors):
    share = request.param
    jface, jplate, face, plate = detectors
    return (
        JaxEngine(jface, jplate, mosaic_level=8, share_letterbox=share),
        DesensitizationEngine(face, plate, mosaic_level=8, share_letterbox=share),
    )


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (2, 96, 160, 3), dtype=np.uint8)


def test_engine_matches_jax(engines, frames):
    jax_engine, engine = engines
    got = engine.process_batch(frames)
    assert engine.last_letterbox.startswith("shared-") == engine.share_letterbox
    blurred, face_px, face_keep, plate_px, plate_keep = (
        np.asarray(o) for o in jax_engine.program()(
            jax_engine.face.variables, jax_engine.plate.variables,
            jnp.asarray(frames.reshape(2, 96, 160 * 3)),
            jnp.asarray(np.tile(np.array([[96, 160]], np.float32), (2, 1))),
        )
    )
    _, p_face_px, p_face_keep, p_plate_px, p_plate_keep = engine.program(
        torch.from_numpy(frames.copy()), torch.tensor([[96.0, 160.0]] * 2)
    )
    np.testing.assert_array_equal(p_face_keep.numpy(), face_keep)
    np.testing.assert_array_equal(p_plate_keep.numpy(), plate_keep)
    assert face_keep.any() and plate_keep.any()
    np.testing.assert_allclose(p_face_px.numpy()[..., :4], face_px[..., :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(p_plate_px.numpy()[..., :4], plate_px[..., :4], rtol=0, atol=1e-3)

    want = jax_engine.process_batch(frames)
    assert got.num_faces == want.num_faces and got.num_plates == want.num_plates
    for g, w in zip(got.face_boxes + got.plate_boxes, want.face_boxes + want.plate_boxes):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.frames, want.frames)
    np.testing.assert_array_equal(got.frames, blurred.reshape(frames.shape))

    # The port's mosaic on the JAX engine's own int32 boxes, so that float
    # noise in the boxes can never decide a pixel.
    boxes = np.concatenate([face_px[..., :4], plate_px[..., :4]], 1).astype(np.int32)
    valid = np.concatenate([face_keep, plate_keep], 1)
    mine = mosaic_boxes_batch(
        torch.from_numpy(frames), torch.from_numpy(boxes), torch.from_numpy(valid), 8
    )
    np.testing.assert_array_equal(mine.numpy(), want.frames)


def test_dispatch_finalize_and_gaussian(engines, frames):
    _, engine = engines
    handles = [engine.dispatch_batch(frames), engine.dispatch_batch(frames[::-1].copy())]
    a, b = (engine.finalize_batch(h) for h in handles)
    np.testing.assert_array_equal(a.frames, b.frames[::-1])
    gauss = DesensitizationEngine(engine.face, engine.plate, anonymizer="gaussian")
    g = gauss.process_batch(frames)
    assert g.num_faces == a.num_faces and g.frames.shape == frames.shape


def test_share_letterbox_guard(engines, frames):
    """The shared canvas is built from the buffer shape, so a smaller
    image_shapes claim is refused there and accepted per detector."""
    _, engine = engines
    shapes = np.array([[90, 150]] * 2, np.float32)
    if engine.share_letterbox:
        with pytest.raises(ValueError, match="share_letterbox"):
            engine.process_batch(frames, image_shapes=shapes)
    else:
        assert engine.process_batch(frames, image_shapes=shapes).frames.shape == frames.shape


def test_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Retinaface(**FACE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PlateDetector(**PLATE)


def test_detector_entry_points_match_the_engine(detectors, frames):
    """``Retinaface.detect_images`` and ``PlateDetector.__call__`` give the
    per-detector engine's boxes (held against JAX above); images of another
    shape are grouped into their own batch."""
    _, _, face, plate = detectors
    engine = DesensitizationEngine(face, plate, share_letterbox=False)
    want = engine.process_batch(frames)
    other = np.ascontiguousarray(frames[0, :64, :100])
    images = [frames[0], other, frames[1]]
    got_face = face.detect_images(images)
    got_plate = plate(images)
    for got, boxes in ((got_face, want.face_boxes), (got_plate, want.plate_boxes)):
        assert got[0][0] is images[0] and got[2][0] is images[2]
        assert got[0][1] == boxes[0] and got[2][1] == boxes[1]
    assert got_face[1][1] == face.detect_images([other])[0][1]
    assert got_plate[1][1] == plate([other], conf=0.0)[0][1]


@pytest.mark.parametrize("name", ["model_path", "backbone", "confidence", "nms_iou", "input_shape",
                                  "letterbox_image", "max_detections", "mesh", "no_such_option"])
def test_get_defaults_matches_jax(name):
    """The class's defaults and the message for an unknown name; ``dtype``
    is bfloat16 in both, each package's own type."""
    assert Retinaface.get_defaults(name) == JaxRetinaface.get_defaults(name)
    assert Retinaface.get_defaults("dtype") == torch.bfloat16
    assert JaxRetinaface.get_defaults("dtype") == jnp.bfloat16
