"""The port's keyframe tracking (``pipeline/tracking.py``) against the JAX
package's: the box math (IoU, greedy matching, propagation, the coasting
tracker, coast boxes, one segment's emission) exactly, since both are the
same float64 numpy; ``TrackingEngine`` over one deterministic fake base in
both packages, every frame's boxes and pixels equal on RGB and I420 with
both anonymizers; the gaussian I420 branch at H = 2 mod 4 (the port cuts
the chroma planes at byte offsets, the JAX package raises);
``CameraTracker``; the privacy gate of ``benchmarks/tracking_coverage.py``
run on the port's functions; the stream's I420 gate through the wrapper;
and the CLI with ``detect_interval = 4`` against the JAX CLI on one small
video with the stream tests' small detectors (boxes within 1e-3 px, pixels
equal where the boxes are)."""

import importlib.util
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_desensitization_tpu.cli import main as jax_cli
from video_desensitization_tpu.detect import face as jax_face_mod
from video_desensitization_tpu.detect import plate as jax_plate_mod
from video_desensitization_tpu.pipeline import engine as jax_engine_mod
from video_desensitization_tpu.pipeline import streaming as jax_streaming
from video_desensitization_tpu.pipeline import tracking as jt

from video_desensitization_torch.api.config import load_config
from video_desensitization_torch.cli import main as cli
from video_desensitization_torch.detect import face as face_mod
from video_desensitization_torch.detect import plate as plate_mod
from video_desensitization_torch.models.convert import from_jax_variables
from video_desensitization_torch.ops.mosaic import mosaic_host_reference, mosaic_i420_host_inplace
from video_desensitization_torch.pipeline import engine as engine_mod
from video_desensitization_torch.pipeline import streaming
from video_desensitization_torch.pipeline import tracking as pt
from video_desensitization_torch.pipeline.engine import DesensitizationEngine
from video_desensitization_torch.pipeline.throughput import TieredPipeline
from video_desensitization_torch.video import av

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are small and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _boxes(rng, n, h=256, w=256):
    x1 = rng.uniform(-20, w - 10, n)
    y1 = rng.uniform(-20, h - 10, n)
    return np.stack([x1, y1, x1 + rng.uniform(1, 90, n), y1 + rng.uniform(1, 90, n)], -1)


def _equal_results(a, b):
    """Two EngineResult lists, frames bitwise and boxes exactly."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.frames, y.frames)
        assert x.face_boxes == y.face_boxes and x.plate_boxes == y.plate_boxes
        assert (x.num_faces, x.num_plates) == (y.num_faces, y.num_plates)


# -- the box math ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_iou_and_greedy_match_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    b[:3] = a[:3] + rng.normal(0, 4, (3, 4))  # some overlapping pairs
    np.testing.assert_array_equal(pt.iou_matrix(a, b), jt.iou_matrix(a, b))
    assert pt.iou_matrix(np.zeros((0, 4)), b).shape == (0, 5)
    for thresh in (0.1, 0.3, 0.7):
        assert pt.greedy_match(a, b, thresh) == jt.greedy_match(a, b, thresh)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_gap", [1, 2, 4, 7])
def test_propagate_boxes_equals_jax(seed, n_gap):
    rng = np.random.default_rng(seed)
    d0 = _boxes(rng, 5).tolist()
    d1 = (np.asarray(d0[:3]) + rng.normal(0, 8, (3, 4))).tolist() + _boxes(rng, 2).tolist()
    for nxt in (d1, None, []):
        kw = dict(margin=0.1 + 0.1 * seed, appear_slack=0.25 * seed)
        got = pt.propagate_boxes(d0, nxt, n_gap, (200, 240), **kw)
        assert got == jt.propagate_boxes(d0, nxt, n_gap, (200, 240), **kw)
        assert len(got) == max(0, n_gap - 1)


def _keyframe_sequence(seed, n=24):
    """Keyframe detections of four moving objects: misses (30%), one fast
    mover (displacement larger than its box), one that leaves for good
    (expiry), one that appears late, with detector jitter."""
    rng = np.random.default_rng(seed)
    start = np.array([[20, 30, 60, 70], [200, 40, 230, 80], [100, 150, 140, 200],
                      [300, 300, 340, 350]], np.float64)
    vel = np.array([[3, 1, 3, 1], [-45, 5, -45, 5], [0, 2, 0, 2], [-2, -2, -2, -2]], np.float64)
    seq = []
    for k in range(n):
        det = []
        for i in range(4):
            if (i == 2 and k > 10) or (i == 3 and k < 6) or rng.random() < 0.3:
                continue
            det.append((start[i] + vel[i] * k + rng.normal(0, 1.5, 4)).tolist())
        seq.append(det)
    return seq


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("coast", [0, 1, 3])
def test_keyframe_tracker_sequences_equal_jax(seed, coast):
    mine, theirs = pt.KeyframeTracker(coast=coast), jt.KeyframeTracker(coast=coast)
    saw_coast = False
    for det in _keyframe_sequence(seed):
        a, b = mine.observe(det), theirs.observe(det)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x["miss"] == y["miss"]
            np.testing.assert_array_equal(x["box"], y["box"])
            np.testing.assert_array_equal(x["vel"], y["vel"])
        saw_coast |= bool(a)
        assert [(t["miss"], t["box"].tolist(), t["vel"].tolist()) for t in mine.tracks] == [
            (t["miss"], t["box"].tolist(), t["vel"].tolist()) for t in theirs.tracks]
    assert saw_coast == (coast > 0)


def test_keyframe_tracker_hand_cases():
    """The JAX package's own cases: coast snapshots extrapolated, expiry,
    a rematch after a miss re-learning the velocity, fast motion matched by
    distance."""
    kt = pt.KeyframeTracker(coast=2)
    assert kt.observe([[0.0, 0.0, 10.0, 10.0]]) == []
    assert kt.observe([[10.0, 0.0, 20.0, 10.0]]) == []
    np.testing.assert_allclose(kt.observe([])[0]["box"], [20.0, 0.0, 30.0, 10.0])
    np.testing.assert_allclose(kt.observe([])[0]["box"], [30.0, 0.0, 40.0, 10.0])
    assert kt.observe([]) == [] and kt.tracks == []
    kt = pt.KeyframeTracker(coast=3)
    kt.observe([[0.0, 0.0, 10.0, 10.0]])
    kt.observe([[30.0, 0.0, 40.0, 10.0]])
    assert len(kt.observe([])) == 1
    assert kt.observe([[90.0, 0.0, 100.0, 10.0]]) == [] and len(kt.tracks) == 1
    np.testing.assert_allclose(kt.tracks[0]["vel"], [30.0, 0.0, 30.0, 0.0])
    kt = pt.KeyframeTracker(coast=2)
    kt.observe([[0.0, 0.0, 10.0, 10.0]])
    assert kt.observe([[20.0, 0.0, 30.0, 10.0]]) == [] and len(kt.tracks) == 1


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_gap", [1, 3, 6])
def test_coast_boxes_equal_jax(seed, n_gap):
    rng = np.random.default_rng(seed)
    coasted = [{"box": b, "vel": rng.normal(0, 10, 4), "miss": int(m)}
               for b, m in zip(_boxes(rng, 6), rng.integers(1, 4, 6))]
    got = pt.coast_boxes(coasted, n_gap, (256, 256), motion_slack=0.3 * seed)
    assert got == jt.coast_boxes(coasted, n_gap, (256, 256), motion_slack=0.3 * seed)


def _frames(rng, n, h=64, w=96, i420=False):
    shape = (n, h * 3 // 2, w) if i420 else (n, h, w, 3)
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("anonymizer", ["mosaic", "gaussian"])
@pytest.mark.parametrize("i420", [False, True], ids=["rgb", "i420"])
def test_emit_segment_equals_jax(anonymizer, i420):
    """One segment with coasting tracks, a gap of 3 and a next keyframe (and
    the same at the stream's tail): the emitted frames bitwise, the boxes
    exactly, the counts."""
    rng = np.random.default_rng(5)
    frames = _frames(rng, 4, i420=i420)
    faces, plates = _boxes(rng, 3, 64, 96).tolist(), _boxes(rng, 1, 64, 96).tolist()
    nxt = (None, (np.asarray(faces) + 3).tolist(), [])
    coast = ([{"box": np.array([10.0, 10.0, 30.0, 40.0]), "vel": np.array([2.0, 1.0, 2.0, 1.0]),
               "miss": 1}], [])
    for next_det in (nxt, None):
        out = []
        for pkg in (pt, jt):
            seg = {"det": (frames[0].copy(), faces, plates), "coast": coast,
                   "gap": [f.copy() for f in frames[1:]]}
            with ThreadPoolExecutor(2) as pool:
                out.append(list(pkg.emit_segment(seg, next_det, pool, level=6,
                                                 anonymizer=anonymizer)))
        _equal_results(*out)
        assert len(out[0]) == 4 and out[0][0].num_faces == 4  # 3 detected + 1 coasted


# -- TrackingEngine over one fake base, in both packages ------------------------------------


def _truth_box(idx: int):
    x, y = 20.0 + 3.0 * idx, 30.0 + 2.0 * idx
    return [x, y, x + 40.0, y + 32.0]


def _fake_base(pkg, i420=False, plates=False, anonymizer="mosaic", pipelined=False, miss_at=()):
    """A deterministic stand-in engine of ``pkg`` (either package's tracking
    module and EngineResult): it 'detects' the box encoded by the frame's
    index byte (none on ``miss_at``) and blurs it as the engines do."""

    class FakeBase:
        mosaic_level = 8

        def __init__(self):
            self.anonymizer = anonymizer
            self.batches = []

        @staticmethod
        def frame_idx(frame):
            return int(frame[0, 0] if frame.ndim == 2 else frame[0, 0, 0])

        def process_batch(self, frames):
            self.batches.append(frames.shape[0])
            out = np.array(frames)
            fb, pb = [], []
            for i in range(out.shape[0]):
                idx = self.frame_idx(out[i])
                faces = [] if idx in miss_at else [_truth_box(idx)]
                plist = [[70.0, 10.0, 100.0, 24.0]] if plates else []
                pkg.tracking.blur_host_inplace(out[i], faces + plist, self.mosaic_level,
                                               anonymizer)
                fb.append(faces)
                pb.append(plist)
            return pkg.EngineResult(frames=out, face_boxes=fb, plate_boxes=pb,
                                    num_faces=sum(map(len, fb)), num_plates=sum(map(len, pb)))

    class FakePipelinedBase(FakeBase):
        def dispatch_batch(self, frames, image_shapes=None):
            return np.array(frames)

        def finalize_batch(self, handle):
            return self.process_batch(handle)

    return FakePipelinedBase() if pipelined else FakeBase()


PORT = SimpleNamespace(tracking=pt, EngineResult=engine_mod.EngineResult)
JAX = SimpleNamespace(tracking=jt, EngineResult=jax_engine_mod.EngineResult)


def _stamped(n, h=128, w=128, i420=False, seed=7):
    frames = _frames(np.random.default_rng(seed), n, h, w, i420)
    if i420:
        frames[:, 0, 0] = np.arange(n)
    else:
        frames[:, 0, 0, 0] = np.arange(n)
    return frames


def _tracked(pkg, frames, bs=5, depth=pt.DEPTH, **kw):
    """``pkg``'s TrackingEngine over a fake base, ``depth`` keyframe batches
    in flight: the port's module constant, patched for the one stream; the
    JAX package's constructor argument."""
    base_kw = {k: kw.pop(k) for k in ("i420", "plates", "anonymizer", "pipelined", "miss_at")
               if k in kw}
    base = _fake_base(pkg, **base_kw)
    if pkg is JAX:
        kw["depth"] = depth
    eng = pkg.tracking.TrackingEngine(base, **kw)
    batches = (np.array(frames[i : i + bs]) for i in range(0, len(frames), bs))
    with mock.patch.object(pt, "DEPTH", depth):
        results = list(eng.process_stream(batches))
    assert all(r.frames.shape[0] == 1 for r in results)
    return results, base


@pytest.mark.parametrize("anonymizer", ["mosaic", "gaussian"])
@pytest.mark.parametrize("i420", [False, True], ids=["rgb", "i420"])
@pytest.mark.parametrize("pipelined", [False, True], ids=["process_batch", "dispatch_batch"])
def test_tracking_engine_equals_jax(anonymizer, i420, pipelined):
    """23 frames at interval 4, detect batches of 3 (the tail padded), plates
    on every frame, the detector blinking on two keyframes: every result of
    the port equals the JAX package's, frames bitwise, boxes exactly."""
    frames = _stamped(23, i420=i420)
    kw = dict(interval=4, detect_batch=3, depth=1, coast=2, i420=i420, plates=True,
              anonymizer=anonymizer, pipelined=pipelined, miss_at={8, 12})
    mine, base = _tracked(PORT, frames, **dict(kw))
    theirs, jbase = _tracked(JAX, frames, **dict(kw))
    _equal_results(mine, theirs)
    assert len(mine) == 23 and base.batches == jbase.batches == [3, 3]
    assert [r.num_faces for r in mine[8:13]] == [1, 1, 1, 1, 1]  # a blink coasted


def test_gap_frames_are_the_host_mosaic_of_their_boxes():
    """Keyframes are the base engine's frames; gap frames are the cv2 mosaic
    of the raw frame under the boxes their result reports (RGB and I420)."""
    for i420 in (False, True):
        frames = _stamped(13, i420=i420)
        results, _ = _tracked(PORT, frames, bs=4, interval=3, detect_batch=2, i420=i420)
        oracle = _fake_base(PORT, i420=i420)
        for idx, r in enumerate(results):
            boxes = r.face_boxes[0] + r.plate_boxes[0]
            if idx % 3 == 0:
                want = oracle.process_batch(frames[idx : idx + 1]).frames[0]
            elif i420:
                want = mosaic_i420_host_inplace(np.array(frames[idx]), boxes, 8)
            else:
                want = mosaic_host_reference(frames[idx], boxes, 8)
            np.testing.assert_array_equal(r.frames[0], want)


def test_interval_one_delegates_and_padding_reaches_the_base():
    frames = _stamped(8)
    base = _fake_base(PORT)
    results = list(pt.TrackingEngine(base, interval=1).process_stream(
        iter([frames[:4], frames[4:]])))
    assert len(results) == 2 and base.batches == [4, 4]
    np.testing.assert_array_equal(results[0].frames, _fake_base(PORT).process_batch(frames[:4]).frames)
    _, base = _tracked(PORT, _stamped(24), interval=4, detect_batch=4, depth=1, pipelined=True)
    assert base.batches == [4, 4]  # 6 keyframes: the tail of 2 padded to 4
    eng = pt.TrackingEngine(_fake_base(PORT), interval=4)
    assert eng.mosaic_level == 8 and not hasattr(eng, "dispatch_batch")
    assert hasattr(pt.TrackingEngine(_fake_base(PORT, pipelined=True), interval=2), "dispatch_batch")
    with pytest.raises(ValueError):
        pt.TrackingEngine(_fake_base(PORT), interval=0)


@pytest.mark.parametrize("h", [98, 100], ids=["h%4==2", "h%4==0"])
def test_gaussian_i420_cuts_chroma_at_byte_offsets(h):
    """cv2's I420 layout: H x W of Y, then H/2 x W/2 of U, then of V, each
    plane contiguous. The port blurs exactly those planes; at H = 2 mod 4
    the JAX package's row split raises (ROADMAP §3), at H = 0 mod 4 both
    agree."""
    import cv2

    w = 160
    rgb = np.random.default_rng(3).integers(0, 256, (h, w, 3), dtype=np.uint8)
    yuv = cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420)
    boxes = [[10.0, 12.0, 70.0, 61.0], [90.5, 40.2, 150.0, 97.0]]
    got = yuv.copy()
    pt.blur_host_inplace(got, boxes, anonymizer="gaussian")
    flat = yuv.copy().reshape(-1)
    q = (h // 2) * (w // 2)
    y, u, v = flat[: h * w].reshape(h, w), flat[h * w : h * w + q], flat[h * w + q :]
    cb = [[x1 / 2, y1 / 2, (x2 + 1) / 2, (y2 + 1) / 2] for x1, y1, x2, y2 in boxes]
    want_y = pt.gaussian_blur_host_inplace(y.copy(), boxes)
    want_u = pt.gaussian_blur_host_inplace(u.reshape(h // 2, w // 2).copy(), cb, 3.0, 6)
    want_v = pt.gaussian_blur_host_inplace(v.reshape(h // 2, w // 2).copy(), cb, 3.0, 6)
    want = np.concatenate([want_y.reshape(-1), want_u.reshape(-1), want_v.reshape(-1)])
    np.testing.assert_array_equal(got.reshape(-1), want)
    assert not np.array_equal(want_u, u.reshape(h // 2, w // 2))  # the chroma was blurred
    theirs = yuv.copy()
    if h % 4:
        with pytest.raises(ValueError):
            jt.blur_host_inplace(theirs, boxes, anonymizer="gaussian")
    else:
        jt.blur_host_inplace(theirs, boxes, anonymizer="gaussian")
        np.testing.assert_array_equal(got, theirs)


# -- CameraTracker -------------------------------------------------------------------------


def _push(pkg, frames, interval, base, pool):
    ct = pkg.tracking.CameraTracker(interval, pool, coast=2)
    out = []
    for f in frames:
        f = np.array(f)
        if ct.push_frame(f):
            r = base.process_batch(f[None])
            out.extend(ct.push_detection(r.frames[0], r.face_boxes[0], r.plate_boxes[0]))
    return out + ct.flush()


def test_camera_tracker_equals_tracking_engine_and_jax():
    frames = _stamped(13)
    pull, _ = _tracked(PORT, frames, interval=3, detect_batch=1, depth=0, coast=2,
                       plates=True, miss_at={6})
    with ThreadPoolExecutor(2) as pool:
        mine = _push(PORT, frames, 3, _fake_base(PORT, plates=True, miss_at={6}), pool)
        theirs = _push(JAX, frames, 3, _fake_base(JAX, plates=True, miss_at={6}), pool)
    _equal_results(pull, mine)
    _equal_results(mine, theirs)
    with ThreadPoolExecutor(1) as pool:
        ct = pt.CameraTracker(2, pool)
        assert ct.push_frame(np.zeros((8, 8, 3), np.uint8))
        with pytest.raises(RuntimeError, match="outstanding"):
            ct.flush()


# -- the privacy gate ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def coverage_module():
    """``benchmarks/tracking_coverage.py``, loaded read-only as a module."""
    spec = importlib.util.spec_from_file_location(
        "tracking_coverage_of_port", os.path.join(REPO, "benchmarks", "tracking_coverage.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_privacy_gate_on_the_port(coverage_module, monkeypatch):
    """The CI gate (``tracking_coverage.py --frames 120 --gate 4``) with the
    port's KeyframeTracker, propagate_boxes, coast_boxes and CameraTracker:
    every scenario at interval <= 4 covers every gap frame whole, no frame
    goes unseen, multicam routing equals the single stream, and every row
    equals the JAX package's."""
    mod = coverage_module
    rows = {}
    for name, pkg in (("jax", jt), ("port", pt)):
        for fn in ("KeyframeTracker", "propagate_boxes", "coast_boxes"):
            monkeypatch.setattr(mod, fn, getattr(pkg, fn))
        monkeypatch.setattr(jt, "CameraTracker", pkg.CameraTracker)
        rows[name] = [mod.run_scenario(s, i, 120, 0) for s in mod.SCENARIOS for i in (2, 4, 8)]
        assert all(mod.multicam_parity(i, 120, 0) for i in (2, 4, 8))
    assert rows["port"] == rows["jax"]
    gated = [r for r in rows["port"] if r["interval"] <= 4 and r["coverage_min"] is not None]
    assert len(gated) == 2 * len(mod.SCENARIOS)
    assert min(r["coverage_min"] for r in gated) == 1.0
    assert sum(r["unseen_frames"] for r in rows["port"]) == 0


# -- the stream and the CLI with real engines --------------------------------------------


FACE = dict(backbone="mobilenet", input_shape=[128, 128, 3], max_detections=16)
PLATE = dict(variant="n", input_shape=(128, 128), max_detections=8)
H, W = 96, 160


@pytest.fixture(scope="module")
def detectors():
    """JAX detectors (random init, confidence 0.01) and the port's on the
    same weights."""
    jface = jax_face_mod.Retinaface(dtype=jnp.float32, confidence=0.01, **FACE)
    jplate = jax_plate_mod.PlateDetector(dtype=jnp.float32, confidence=0.01, **PLATE)
    tree = lambda v: jax.tree.map(np.asarray, dict(v))  # noqa: E731
    face = face_mod.Retinaface(state_dict=from_jax_variables(tree(jface.variables)),
                               dtype=torch.float32, device="cpu", confidence=0.01, **FACE)
    plate = plate_mod.PlateDetector(state_dict=from_jax_variables(tree(jplate.variables)),
                                    dtype=torch.float32, device="cpu", confidence=0.01, **PLATE)
    return jface, jplate, face, plate


@pytest.fixture(scope="module")
def native():
    if not av.native_available():
        pytest.skip(f"native av layer unavailable: {av.codec_path()}")


def _source(path, n, seed=0):
    rng = np.random.default_rng(seed)
    with av.VideoEncoder(str(path), W, H, fps=10, codec="mpeg4") as enc:
        for _ in range(n):
            enc.write(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    return str(path)


class RecordingEncoder:
    """Stands in for ``VideoEncoder`` and keeps every frame written."""

    written = {}

    def __init__(self, path, width, height, fps=30.0, **kwargs):
        self.frames = RecordingEncoder.written.setdefault(path, [])

    def write(self, frame):
        self.frames.append(("rgb", np.array(frame)))

    def write_i420(self, frame):
        self.frames.append(("i420", np.array(frame)))

    def close(self):
        pass


@pytest.fixture
def recording(monkeypatch):
    RecordingEncoder.written = {}
    monkeypatch.setattr(streaming, "VideoEncoder", RecordingEncoder)
    monkeypatch.setattr(jax_streaming, "VideoEncoder", RecordingEncoder)
    return RecordingEncoder.written


def test_stream_through_the_wrapper_keeps_the_i420_gate(native, recording, detectors, tmp_path):
    """``process_video_stream`` needs no change for tracking: a tracked fused
    engine gets I420 frames under transport yuv420 (its gate finds
    ``process_batch_yuv`` through the wrapper), a tracked tiered pipeline
    falls back to RGB, each result is one frame, and the encoder gets
    every frame in order."""
    _, _, face, plate = detectors
    src = _source(tmp_path / "in.mp4", 10)
    fused = pt.TrackingEngine(DesensitizationEngine(face, plate), interval=4, detect_batch=2)
    tiered = pt.TrackingEngine(TieredPipeline(face, plate), interval=4, detect_batch=2)
    assert hasattr(fused, "process_batch_yuv") and not hasattr(tiered, "process_batch_yuv")
    for name, eng, kind, shape in (("fused", fused, "i420", (H * 3 // 2, W)),
                                   ("tiered", tiered, "rgb", (H, W, 3))):
        stats = streaming.process_video_stream(src, name, eng, batch_size=4, transport="yuv420")
        assert stats.frames == 10
        assert [(k, f.shape) for k, f in recording[name]] == [(kind, shape)] * 10
    assert stats.faces > 0


def _cli_config(tmp_path):
    ini = tmp_path / "config.ini"
    ini.write_text(
        "[PATHS]\nmodel_path=random\nmodel_weights=random\nrecord_dir=\n"
        "output_h265_dir=\noutput_videos_dir=\ntemp_directory_base=\nrecord_output_dir=\n"
        "[SETTINGS]\nbatch_size=4\n"
        "[TPU]\nengine=fused\nmesh_data=1\ninput_size=128\nmax_detections=16\n"
        "dtype=float32\nconfidence=0.01\ndetect_interval=4\n"
    )
    return str(ini)


def test_cli_detect_interval_matches_jax_cli(native, recording, detectors, tmp_path, monkeypatch):
    """Both CLIs on one 18-frame video with ``detect_interval = 4`` (5
    keyframes: a batch of 4, then the tail padded), their detectors the
    shared small ones: the same frame count, each frame's boxes within
    1e-3 px, and the frames bitwise where the boxes cast to the same
    integers (the mosaic's input): here on every frame."""
    jface, jplate, face, plate = detectors
    monkeypatch.setattr(face_mod, "Retinaface", lambda **kw: face)
    monkeypatch.setattr(plate_mod, "PlateDetector", lambda **kw: plate)
    monkeypatch.setattr(jax_face_mod, "Retinaface", lambda **kw: jface)
    monkeypatch.setattr(jax_plate_mod, "PlateDetector", lambda **kw: jplate)
    boxes = {}
    for name, pkg in (("port", pt), ("jax", jt)):
        stream_of = pkg.TrackingEngine.process_stream

        def spy(self, batches, _of=stream_of, _name=name):
            for r in _of(self, batches):
                boxes.setdefault(_name, []).append(r.face_boxes[0] + r.plate_boxes[0])
                yield r

        monkeypatch.setattr(pkg.TrackingEngine, "process_stream", spy)
    src = _source(tmp_path / "in.mp4", 18)
    ini = _cli_config(tmp_path)
    assert cli.main([ini, "--video", src, "--out", "port.mp4", "--device", "cpu"]) == 0
    assert jax_cli.main([ini, "--video", src, "--out", "jax.mp4"]) == 0
    mine, theirs = recording["port.mp4"], recording["jax.mp4"]
    assert len(mine) == len(theirs) == len(boxes["port"]) == len(boxes["jax"]) == 18
    equal_frames = 0
    for (_, a), (_, b), ba, bb in zip(mine, theirs, boxes["port"], boxes["jax"]):
        assert len(ba) == len(bb)
        if ba:
            np.testing.assert_allclose(np.asarray(ba), np.asarray(bb), rtol=0, atol=1e-3)
        if np.array_equal(np.asarray(ba, np.float64).astype(np.int64).reshape(-1, 4),
                          np.asarray(bb, np.float64).astype(np.int64).reshape(-1, 4)):
            np.testing.assert_array_equal(a, b)
            equal_frames += 1
    assert equal_frames == 18 and sum(map(len, boxes["port"])) > 0


def test_build_engine_wraps_in_tracking(tmp_path):
    """``detect_interval > 1``: the engine comes wrapped, ``detect_batch`` is
    ``track_detect_batch`` or else ``batch_size``, ``coast`` is
    ``track_coast``, as the JAX package's ``build_engine`` does."""
    ini = tmp_path / "b.ini"

    def built(extra):
        ini.write_text("[PATHS]\nmodel_path=random\nmodel_weights=random\n"
                       "[SETTINGS]\nbatch_size=6\n[TPU]\ninput_size=64\nmax_detections=4\n"
                       f"dtype=float32\ndetect_interval=3\n{extra}")
        return cli.build_engine(load_config(str(ini), strict=False), with_plates=False,
                                device="cpu")

    eng = built("")
    assert isinstance(eng, pt.TrackingEngine) and isinstance(eng.base, TieredPipeline)
    assert (eng.interval, eng.detect_batch, eng.coast) == (3, 6, 3)
    eng = built("track_detect_batch=2\ntrack_coast=1\nengine=fused\n")
    assert isinstance(eng.base, DesensitizationEngine) and (eng.detect_batch, eng.coast) == (2, 1)
    ini.write_text(ini.read_text().replace("detect_interval=3", "detect_interval=1"))
    assert isinstance(cli.build_engine(load_config(str(ini), strict=False), with_plates=False,
                                       device="cpu"), DesensitizationEngine)
