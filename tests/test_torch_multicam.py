"""The port's co-batched cameras (``pipeline/multicam.py``) and the record
job's ``co_batch`` branch against the JAX package's.

The cases of ``tests/test_multicam.py`` on the port (round trip with mixed
resolutions, encode settings, an isolated failed camera and dead decoder,
the fused engine, an engine error that aborts everything, yuv420,
per-camera tracking, tracking equal to a single stream); per-camera
outputs held bitwise against the JAX package's ``process_videos_cobatched``
on the same small videos and weights (what each camera's encoder was
handed); the record job with ``co_batch = true`` against the JAX one; and
the port's CLI with ``co_batch`` and ``detect_interval`` together.

Small sizes: 96x160 and 64x128 frames, RetinaFace-mobilenet (+ YOLOv8n) at
128 in float32 with the JAX package's weights. Tests that write or read
video files need the native codec layer and skip without it."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_record import CHATTER, hevc_packets, write_camera_record

from video_desensitization_tpu.api.config import load_config as jax_load_config
from video_desensitization_tpu.detect.face import Retinaface as JaxRetinaface
from video_desensitization_tpu.detect.plate import PlateDetector as JaxPlateDetector
from video_desensitization_tpu.pipeline import multicam as jax_multicam
from video_desensitization_tpu.pipeline.engine import DesensitizationEngine as JaxEngine
from video_desensitization_tpu.pipeline.throughput import TieredPipeline as JaxTiered
from video_desensitization_tpu.pipeline.video_pipeline import process_record_job as jax_record_job
from video_desensitization_tpu.record.reader import RecordReader as JaxRecordReader

from video_desensitization_torch.api.config import load_config
from video_desensitization_torch.cli.main import main
from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.detect.plate import PlateDetector
from video_desensitization_torch.models.convert import from_jax_variables
from video_desensitization_torch.ops.mosaic import mosaic_host_inplace
from video_desensitization_torch.pipeline import multicam
from video_desensitization_torch.pipeline import tracking as tr
from video_desensitization_torch.pipeline.engine import DesensitizationEngine, EngineResult
from video_desensitization_torch.pipeline.multicam import process_videos_cobatched
from video_desensitization_torch.pipeline.throughput import TieredPipeline
from video_desensitization_torch.pipeline.video_pipeline import process_record_job
from video_desensitization_torch.record.reader import RecordReader
from video_desensitization_torch.record.topics import CAMERA_TOPICS
from video_desensitization_torch.video import av


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are small and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module", autouse=True)
def native():
    if not av.native_available():
        pytest.skip(f"native av layer unavailable: {av.codec_path()}")


FACE = dict(backbone="mobilenet", input_shape=[128, 128, 3], max_detections=8)
PLATE = dict(variant="n", input_shape=(128, 128), max_detections=8)
SHAPES = {"front": (96, 160), "rear": (64, 128)}


@pytest.fixture(scope="module")
def detectors():
    """JAX detectors (random init, confidence 0.3 for faces, 0.01 for
    plates) and the port's on the same weights."""
    jface = JaxRetinaface(dtype=jnp.float32, confidence=0.3, **FACE)
    jplate = JaxPlateDetector(dtype=jnp.float32, confidence=0.01, **PLATE)
    tree = lambda v: jax.tree.map(np.asarray, dict(v))  # noqa: E731
    face = Retinaface(state_dict=from_jax_variables(tree(jface.variables)),
                      dtype=torch.float32, device="cpu", confidence=0.3, **FACE)
    plate = PlateDetector(state_dict=from_jax_variables(tree(jplate.variables)),
                          dtype=torch.float32, device="cpu", confidence=0.01, **PLATE)
    return jface, jplate, face, plate


def _write(path, n, h, w, seed=0, codec="mpeg4", frame_fn=None):
    rng = np.random.default_rng(seed)
    kw = dict(bitrate=300_000, preset="ultrafast") if codec == "libx265" else {}
    with av.VideoEncoder(str(path), w, h, fps=10, codec=codec, **kw) as enc:
        for i in range(n):
            enc.write(frame_fn(i) if frame_fn else rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return str(path)


def _jobs(tmp_path, counts, shapes=SHAPES, codec="mpeg4", ext="mp4"):
    return {
        cam: (_write(tmp_path / f"{cam}.{ext}", n, *shapes[cam], seed=k, codec=codec),
              str(tmp_path / f"{cam}_out.{ext}"))
        for k, (cam, n) in enumerate(counts.items())
    }


def _decoded(path):
    with av.VideoDecoder(path) as dec:
        return [f.shape for f in dec]


def test_cobatched_streams_roundtrip(tmp_path, detectors):
    """Two cameras of different sizes through the tiered pipeline, batch 4:
    every frame back at its camera's size."""
    engine = TieredPipeline(detectors[2], None, mosaic_level=8)
    counts = {"front": 11, "rear": 7}
    jobs = _jobs(tmp_path, counts)
    stats = process_videos_cobatched(jobs, engine, batch_size=4)
    for cam, n in counts.items():
        assert stats[cam].error is None and stats[cam].frames == n
        assert os.path.getsize(jobs[cam][1]) > 500
        assert _decoded(jobs[cam][1]) == [(*SHAPES[cam], 3)] * n


def test_cobatched_encode_kwargs_reach_writer(tmp_path, detectors):
    engine = TieredPipeline(detectors[2], None, mosaic_level=8)
    jobs = _jobs(tmp_path, {"front": 6}, codec="libx265", ext="h265")
    stats = process_videos_cobatched(jobs, engine, batch_size=4,
                                     encode_kwargs={"preset": "ultrafast", "bitrate": 500_000})
    assert stats["front"].frames == 6 and not stats["front"].error
    assert len(_decoded(jobs["front"][1])) == 6


def test_cobatched_failed_camera_is_isolated(tmp_path, detectors):
    """A dead encoder neither hangs the job nor stops the other camera."""
    engine = TieredPipeline(detectors[2], None, mosaic_level=8)
    jobs = _jobs(tmp_path, {"good": 6, "bad": 6}, shapes={"good": (64, 128), "bad": (64, 128)})
    jobs["bad"] = (jobs["bad"][0], str(tmp_path / "no_such_dir" / "out.mp4"))
    stats = process_videos_cobatched(jobs, engine, batch_size=4)
    assert stats["bad"].error is not None and stats["good"].error is None
    assert stats["good"].frames == 6 and len(_decoded(jobs["good"][1])) == 6


def test_cobatched_dead_decoder_is_isolated(tmp_path, detectors):
    engine = TieredPipeline(detectors[2], None, mosaic_level=8)
    jobs = _jobs(tmp_path, {"good": 5}, shapes={"good": (64, 128)})
    garbage = tmp_path / "bad.mp4"
    garbage.write_bytes(b"not a video at all")
    jobs["bad"] = (str(garbage), str(tmp_path / "bad_out.mp4"))
    stats = process_videos_cobatched(jobs, engine, batch_size=4)
    assert stats["bad"].error is not None and stats["good"].frames == 5


def test_cobatched_with_fused_engine(tmp_path, detectors):
    engine = DesensitizationEngine(detectors[2], None, mosaic_level=8)
    jobs = _jobs(tmp_path, {"front": 5})
    stats = process_videos_cobatched(jobs, engine, batch_size=4)
    assert stats["front"].frames == 5 and len(_decoded(jobs["front"][1])) == 5


def test_cobatched_device_error_aborts_everything(tmp_path):
    """An engine failure (unlike a camera's codec failure) poisons the
    whole job: it is raised to the caller, nothing hangs."""

    class FailingEngine:
        def process_batch(self, frames):
            raise RuntimeError("device program exploded")

    jobs = _jobs(tmp_path, {"a": 6, "b": 6}, shapes={"a": (64, 128), "b": (64, 128)})
    with pytest.raises(RuntimeError, match="device program exploded"):
        process_videos_cobatched(jobs, FailingEngine(), batch_size=4)


def test_cobatched_yuv420_transport(tmp_path, detectors):
    """yuv420 with the fused engine: every camera's frames travel as I420
    through process_batch_yuv into I420 encoders, mixed sizes co-batched by
    full shape."""
    engine = DesensitizationEngine(detectors[2], None, mosaic_level=8)
    counts = {"front": 9, "rear": 5}
    jobs = _jobs(tmp_path, counts, codec="libx265", ext="h265")
    stats = process_videos_cobatched(jobs, engine, batch_size=4, transport="yuv420",
                                     encode_kwargs={"preset": "ultrafast"})
    for cam, n in counts.items():
        assert stats[cam].error is None and stats[cam].frames == n
        assert _decoded(jobs[cam][1]) == [(*SHAPES[cam], 3)] * n


class CountingEngine:
    """Blurs one fixed box on every frame it is given, and counts them."""

    mosaic_level = 8
    anonymizer = "mosaic"

    def __init__(self):
        self.frames_detected = 0

    def process_batch(self, frames):
        self.frames_detected += frames.shape[0]
        out = np.array(frames)
        fb = [[[2.0, 2.0, 30.0, 30.0]]] * len(out)
        for i in range(len(out)):
            mosaic_host_inplace(out[i], fb[i], self.mosaic_level)
        return EngineResult(frames=out, face_boxes=fb, plate_boxes=[[] for _ in out],
                            num_faces=len(out), num_plates=0)


def test_cobatched_detect_interval_per_camera_tracking(tmp_path):
    """detect_interval 2: only each camera's keyframes reach the engine
    (front 6 of 11, rear 4 of 7; partial batches padded to 4, so 10 to 12
    frames), every frame comes back in order and carries the box."""
    engine = CountingEngine()
    counts = {"front": 11, "rear": 7}
    jobs = _jobs(tmp_path, counts)
    stats = process_videos_cobatched(jobs, engine, batch_size=4, detect_interval=2)
    assert 10 <= engine.frames_detected <= 12
    for cam, n in counts.items():
        assert stats[cam].error is None and stats[cam].frames == stats[cam].faces == n
        assert _decoded(jobs[cam][1]) == [(*SHAPES[cam], 3)] * n


def test_cobatched_tracking_matches_single_stream(tmp_path, monkeypatch):
    """Two cameras with different motions, co-batched with detect_interval
    3: each camera's per-frame boxes (recorded from its CameraTracker)
    equal those of its stream run alone, and cover its moving subject."""
    h, w, n, interval = 96, 160, 19, 3

    def truth_box(cam, i):
        if cam == "front":
            x, y = 8 + 4 * i, 10 + 2 * i
        else:
            x, y = int(40 + 30 * np.sin(i / 3.0)), int(30 + 20 * np.cos(i / 4.0))
        return [float(x), float(y), float(x + 36), float(y + 28)]

    class ContentDetector:
        """The bounding box of the bright pixels: detections follow the
        content, so results routed to the wrong camera would show."""

        mosaic_level = 8
        anonymizer = "mosaic"

        def process_batch(self, frames):
            out = np.array(frames)
            fb = []
            for i in range(len(out)):
                ys, xs = np.where(out[i, :, :, 0] > 127)
                box = ([float(xs.min()), float(ys.min()), float(xs.max() + 1), float(ys.max() + 1)]
                       if len(xs) else None)
                fb.append([box] if box else [])
                if box:
                    mosaic_host_inplace(out[i], [box], self.mosaic_level)
            return EngineResult(frames=out, face_boxes=fb, plate_boxes=[[] for _ in out],
                                num_faces=sum(map(len, fb)), num_plates=0)

    created = []
    init, push, flush = tr.CameraTracker.__init__, tr.CameraTracker.push_detection, tr.CameraTracker.flush

    def spy_init(self, *a, **k):
        init(self, *a, **k)
        self.rec = []
        created.append(self)

    def spy_push(self, *a):
        res = push(self, *a)
        self.rec.extend(r.face_boxes[0] for r in res)
        return res

    def spy_flush(self):
        res = flush(self)
        self.rec.extend(r.face_boxes[0] for r in res)
        return res

    monkeypatch.setattr(tr.CameraTracker, "__init__", spy_init)
    monkeypatch.setattr(tr.CameraTracker, "push_detection", spy_push)
    monkeypatch.setattr(tr.CameraTracker, "flush", spy_flush)

    def frame_fn(cam):
        def make(i):
            f = np.zeros((h, w, 3), np.uint8)
            x1, y1, x2, y2 = (int(v) for v in truth_box(cam, i))
            f[y1:y2, x1:x2] = 255
            return f
        return make

    srcs = {cam: _write(tmp_path / f"{cam}.h265", n, h, w, codec="libx265", frame_fn=frame_fn(cam))
            for cam in ("front", "rear")}

    def run(cams):
        created.clear()
        jobs = {cam: (srcs[cam], str(tmp_path / f"{cam}_{len(cams)}.mp4")) for cam in cams}
        stats = process_videos_cobatched(jobs, ContentDetector(), batch_size=4,
                                         detect_interval=interval)
        assert all(stats[c].error is None and stats[c].frames == n for c in cams)
        return {cam: created[k].rec for k, cam in enumerate(cams)}

    both = run(["front", "rear"])
    solo = {**run(["front"]), **run(["rear"])}
    for cam in ("front", "rear"):
        assert len(both[cam]) == n and both[cam] == solo[cam]
        for i in range(n):
            tx1, ty1, tx2, ty2 = truth_box(cam, i)
            assert any(b[0] <= tx1 + 1 and b[1] <= ty1 + 1 and b[2] >= tx2 - 1
                       and b[3] >= ty2 - 1 for b in both[cam][i]), (cam, i)


# -- against the JAX package -----------------------------------------------------


class RecordingEncoder:
    """Stands in for ``VideoEncoder`` in both packages' multicam modules and
    keeps a copy of every frame written, with how it was written."""

    written = {}

    def __init__(self, path, width, height, fps=30.0, **kwargs):
        self.frames = RecordingEncoder.written.setdefault(path, [])

    def write(self, frame):
        self.frames.append(("rgb", np.array(frame)))

    def write_i420(self, frame):
        self.frames.append(("i420", np.array(frame)))

    def close(self):
        pass


@pytest.mark.parametrize("kind, transport, interval",
                         [("tiered", "rgb", 1), ("fused", "rgb", 1), ("fused", "yuv420", 1),
                          ("fused", "rgb", 3)],
                         ids=["tiered", "fused", "fused-yuv420", "fused-interval3"])
def test_cobatched_equals_jax(tmp_path, detectors, monkeypatch, kind, transport, interval):
    """Two 96x160 cameras (7 and 5 frames, batch 4) through both packages'
    process_videos_cobatched on the same weights: each camera's encoder is
    handed the same frames, bitwise and in the same form, and the stats
    are equal."""
    jface, jplate, face, plate = detectors
    if kind == "tiered":
        engines = TieredPipeline(face, plate), JaxTiered(jface, jplate)
    else:
        engines = DesensitizationEngine(face, plate), JaxEngine(jface, jplate)
    RecordingEncoder.written = {}
    monkeypatch.setattr(multicam, "VideoEncoder", RecordingEncoder)
    monkeypatch.setattr(jax_multicam, "VideoEncoder", RecordingEncoder)
    shapes = {"front": (96, 160), "rear": (96, 160)}
    srcs = _jobs(tmp_path, {"front": 7, "rear": 5}, shapes=shapes)
    stats = []
    for name, fn, eng in (("mine", process_videos_cobatched, engines[0]),
                          ("theirs", jax_multicam.process_videos_cobatched, engines[1])):
        jobs = {cam: (src, f"{name}_{cam}.mp4") for cam, (src, _) in srcs.items()}
        stats.append(fn(jobs, eng, batch_size=4, transport=transport, detect_interval=interval))
    assert {c: dataclasses.astuple(s) for c, s in stats[0].items()} == {
        c: dataclasses.astuple(s) for c, s in stats[1].items()}
    kind_of = "i420" if transport == "yuv420" else "rgb"
    for cam, n in (("front", 7), ("rear", 5)):
        mine, theirs = RecordingEncoder.written[f"mine_{cam}.mp4"], RecordingEncoder.written[f"theirs_{cam}.mp4"]
        assert len(mine) == len(theirs) == n == stats[0][cam].frames
        for (k1, a), (k2, b) in zip(mine, theirs):
            assert k1 == k2 == kind_of
            np.testing.assert_array_equal(a, b)
    assert sum(s.faces + s.plates for s in stats[0].values()) > 0


@pytest.fixture(scope="module")
def job_record(tmp_path_factory):
    """Two 96x160 cameras of 8 HEVC frames, the first led by two
    pre-keyframe messages, and a chatter channel, in LZ4 chunks."""
    from video_desensitization_torch.record.proto import cyber_record_pb2 as rp

    d = tmp_path_factory.mktemp("job")
    a = [bytes(p.data) for p in hevc_packets(8, 96, 160, 90, str(d / "a.h265"))]
    b = [bytes(p.data) for p in hevc_packets(8, 96, 160, 160, str(d / "b.h265"))]
    (d / "in").mkdir()
    write_camera_record(str(d / "in" / "job.record"),
                        {CAMERA_TOPICS[0]: a[-2:] + a, CAMERA_TOPICS[1]: b},
                        compress=rp.COMPRESS_LZ4, chunk_message_limit=8)
    return str(d / "in")


def _job_config(tmp_path, name, record_dir, tpu=""):
    root = tmp_path / name
    ini = tmp_path / f"{name}.ini"
    ini.write_text(
        f"[PATHS]\nmodel_path=random\nmodel_weights=random\nrecord_dir={record_dir}\n"
        f"output_h265_dir={root / 'h265'}\noutput_videos_dir={root / 'videos'}\n"
        f"temp_directory_base={root / 'tmp'}\nrecord_output_dir={root / 'out'}\n"
        "[SETTINGS]\nbatch_size=4\nencode_preset=ultrafast\n"
        "[TPU]\ninput_size=128\nmax_detections=8\ndtype=float32\nconfidence=0.01\n"
        f"output_fps=30\nco_batch=true\n{tpu}"
    )
    return str(ini)


def test_cobatched_record_job_matches_jax(tmp_path, detectors, job_record):
    """process_record_job with co_batch in both packages, the fused engine
    on the same weights: the same stats, channels, per-topic message times
    and sequence numbers, the chatter byte for byte, and camera payloads
    that decode to bitwise-equal frames."""
    jface, jplate, face, plate = detectors
    mine = process_record_job(load_config(_job_config(tmp_path, "mine", job_record)),
                              DesensitizationEngine(face, plate))
    theirs = jax_record_job(jax_load_config(_job_config(tmp_path, "theirs", job_record)),
                            JaxEngine(jface, jplate))
    assert (mine.videos_processed, mine.videos_failed) == (2, 0) and mine.frames == 16
    assert dataclasses.astuple(mine)[:6] == dataclasses.astuple(theirs)[:6]
    assert sorted(os.listdir(tmp_path / "mine" / "videos")) == sorted(
        os.listdir(tmp_path / "theirs" / "videos"))
    a, b = RecordReader(mine.record_path), JaxRecordReader(theirs.record_path)
    assert set(a.channels) == set(b.channels) == {*CAMERA_TOPICS[:2], CHATTER}
    assert [m for _, m, _ in a.read_messages(CHATTER)] == [m for _, m, _ in b.read_messages(CHATTER)]
    for k, topic in enumerate(CAMERA_TOPICS[:2]):
        ma, mb = list(a.read_messages(topic)), list(b.read_messages(topic))
        assert len(ma) == len(mb) == 8
        assert [(ts, m.header.sequence_num) for _, m, ts in ma] == [
            (ts, m.header.sequence_num) for _, m, ts in mb]
        frames = []
        for name, msgs in (("a", ma), ("b", mb)):
            path = tmp_path / f"{name}{k}.h265"
            path.write_bytes(b"".join(bytes(m.data) for _, m, _ in msgs))
            with av.VideoDecoder(str(path)) as dec:
                frames.append([np.array(f) for f in dec])
        assert len(frames[0]) == len(frames[1]) == 8
        for x, y in zip(*frames):
            np.testing.assert_array_equal(x, y)


def test_cli_record_job_cobatched_and_tracked(tmp_path, job_record):
    """``main([config.ini])`` with co_batch and detect_interval 4 together
    (the tiered engine, its own ResNet-50 at 128 on the CPU): every camera
    message comes back in the final record."""
    ini = _job_config(tmp_path, "cli", job_record, tpu="detect_interval=4\n")
    cfg = load_config(ini)
    assert cfg.co_batch and cfg.detect_interval == 4
    assert main([ini, "--device", "cpu", "--no-plates"]) == 0
    final = RecordReader(str(tmp_path / "cli" / "out" / "job.record"))
    assert [final.message_count(t) for t in CAMERA_TOPICS[:2]] == [8, 8]
    assert final.message_count(CHATTER) == 10
