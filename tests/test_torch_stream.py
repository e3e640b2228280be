"""The port's entry points against the JAX package's: ``process_video_stream``
(transports rgb, yuv420 and auto, and the fallback to rgb for a source with
no I420 form or an engine without an I420 program), and the CLI
(``--video``, ``--images``, ``--profile``, ``engine = auto``, the refusals)
with one config.ini parsed the same by both packages.

Small sizes: 96x160 frames, RetinaFace-mobilenet + YOLOv8n at 128 in float32
with the JAX package's weights for the stream; the CLI's own ResNet-50 at
128 on the CPU (``--device cpu``). Tests that need the native codec layer
skip without it."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_desensitization_tpu.api.config import load_config as jax_load_config
from video_desensitization_tpu.cli import main as jax_cli
from video_desensitization_tpu.detect.face import Retinaface as JaxRetinaface
from video_desensitization_tpu.detect.plate import PlateDetector as JaxPlateDetector
from video_desensitization_tpu.pipeline import streaming as jax_streaming
from video_desensitization_tpu.pipeline.engine import DesensitizationEngine as JaxEngine

from video_desensitization_torch.api.config import load_config
from video_desensitization_torch.cli.main import build_engine, main, pick_engine, probe_link_gib_s
from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.detect.plate import PlateDetector
from video_desensitization_torch.models.convert import from_jax_variables
from video_desensitization_torch.pipeline import streaming
from video_desensitization_torch.pipeline.engine import DesensitizationEngine
from video_desensitization_torch.pipeline.throughput import TieredPipeline
from video_desensitization_torch.video import av


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are small and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def native():
    """The port's native codec layer (built at first use); the tests that
    write and read video files skip without it."""
    if not av.native_available():
        pytest.skip(f"native av layer unavailable: {av.codec_path()}")


H, W = 96, 160


def _source(path, n, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    with av.VideoEncoder(str(path), w, h, fps=10, codec="mpeg4") as enc:
        for _ in range(n):
            enc.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return str(path)


class RecordingEncoder:
    """Stands in for ``VideoEncoder`` in both packages' streaming modules and
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


@pytest.fixture
def recording(monkeypatch):
    RecordingEncoder.written = {}
    monkeypatch.setattr(streaming, "VideoEncoder", RecordingEncoder)
    monkeypatch.setattr(jax_streaming, "VideoEncoder", RecordingEncoder)
    return RecordingEncoder.written


FACE = dict(backbone="mobilenet", input_shape=[128, 128, 3], max_detections=16)
PLATE = dict(variant="n", input_shape=(128, 128), max_detections=8)


@pytest.fixture(scope="module")
def engines():
    """The JAX engine (random init) and the port's on the same weights."""
    jface = JaxRetinaface(dtype=jnp.float32, **FACE)
    jplate = JaxPlateDetector(dtype=jnp.float32, **PLATE)
    tree = lambda v: jax.tree.map(np.asarray, dict(v))  # noqa: E731
    face = Retinaface(state_dict=from_jax_variables(tree(jface.variables)),
                      dtype=torch.float32, device="cpu", **FACE)
    plate = PlateDetector(state_dict=from_jax_variables(tree(jplate.variables)),
                          dtype=torch.float32, device="cpu", **PLATE)
    return JaxEngine(jface, jplate, mosaic_level=8), DesensitizationEngine(face, plate, mosaic_level=8)


@pytest.mark.parametrize("transport", ["rgb", "yuv420"])
def test_stream_hands_the_encoder_what_jax_does(native, recording, engines, tmp_path, transport):
    """Four frames in batches of two (two batches in flight in the port):
    the encoder gets bitwise the JAX package's frames, written the same way."""
    jax_engine, engine = engines
    src = _source(tmp_path / "in.mp4", 4)
    kind = {"rgb": "rgb", "yuv420": "i420"}[transport]
    stats = streaming.process_video_stream(src, "port.mp4", engine, batch_size=2, transport=transport)
    jax_streaming.process_video_stream(src, "jax.mp4", jax_engine, batch_size=2, transport=transport)
    mine, theirs = recording["port.mp4"], recording["jax.mp4"]
    assert stats.frames == 4 and len(mine) == len(theirs) == 4
    shape = (H * 3 // 2, W) if kind == "i420" else (H, W, 3)
    for (k1, a), (k2, b) in zip(mine, theirs):
        assert k1 == k2 == kind and a.shape == shape
        np.testing.assert_array_equal(a, b)
    assert stats.faces > 0


def test_stream_auto_is_yuv420_and_odd_sizes_fall_back_to_rgb(native, recording, engines, tmp_path):
    _, engine = engines
    src = _source(tmp_path / "in.mp4", 3)
    assert streaming.process_video_stream(src, "auto.mp4", engine, batch_size=2,
                                          transport="auto").frames == 3
    assert [k for k, _ in recording["auto.mp4"]] == ["i420"] * 3
    odd = _source(tmp_path / "odd.mp4", 5, h=95, w=161, seed=1)
    stats = streaming.process_video_stream(odd, "odd.mp4", engine, batch_size=2, transport="yuv420")
    assert stats.frames == 5
    assert [(k, f.shape) for k, f in recording["odd.mp4"]] == [("rgb", (95, 161, 3))] * 5


def test_stream_falls_back_to_rgb_for_an_engine_without_i420(native, recording, engines, tmp_path):
    """The tiered pipeline has no I420 program: transport yuv420 or auto
    hands it RGB frames (the JAX package's gate), and the encoder gets its
    process_batch results."""
    _, engine = engines
    tiered = TieredPipeline(engine.face, engine.plate, mosaic_level=8)
    src = _source(tmp_path / "in.mp4", 3)
    with av.VideoDecoder(src) as dec:
        want = tiered.process_batch(np.stack(list(dec))).frames
    for transport in ("yuv420", "auto"):
        stats = streaming.process_video_stream(src, f"{transport}.mp4", tiered, batch_size=2,
                                               transport=transport)
        got = recording[f"{transport}.mp4"]
        assert stats.frames == 3 and [k for k, _ in got] == ["rgb"] * 3
        np.testing.assert_array_equal(np.stack([f for _, f in got]), want)


def _config(tmp_path, model="random", extra="", engine="fused"):
    """A config.ini for the CLI on the CPU: the fused engine at input 128."""
    ini = tmp_path / "config.ini"
    ini.write_text(
        f"[PATHS]\nmodel_path={model}\nmodel_weights={model}\nrecord_dir=\n"
        "output_h265_dir=\noutput_videos_dir=\ntemp_directory_base=\nrecord_output_dir=\n"
        "[SETTINGS]\nbatch_size=4\n"
        f"[TPU]\nengine={engine}\ninput_size=128\nmax_detections=8\ndtype=float32\n"
        f"confidence=0.01\n{extra}"
    )
    return str(ini)


@pytest.mark.parametrize("transfer", ["rgb", "yuv420"])
def test_cli_video_mode(native, tmp_path, transfer):
    src = _source(tmp_path / "in.mp4", 6)
    out = str(tmp_path / "out.mp4")
    rc = main([_config(tmp_path, extra=f"transfer={transfer}\n"), "--video", src, "--out", out,
               "--device", "cpu"])
    assert rc == 0
    with av.VideoDecoder(out) as dec:
        frames = list(dec)
    assert len(frames) == 6 and frames[0].shape == (H, W, 3)


def _image_dir(tmp_path, n):
    import cv2

    rng = np.random.default_rng(1)
    imgdir = tmp_path / "imgs"
    imgdir.mkdir()
    for i in range(n):
        shape = (H, W, 3) if i % 2 else (64, 80, 3)  # two shapes, two batches
        cv2.imwrite(str(imgdir / f"f{i}.jpg"), rng.integers(0, 256, shape, dtype=np.uint8))
    return str(imgdir)


def test_cli_images_mode_and_profile(tmp_path):
    outdir, trace = str(tmp_path / "out"), tmp_path / "trace"
    rc = main([_config(tmp_path), "--images", _image_dir(tmp_path, 3), "--out", outdir,
               "--device", "cpu", "--no-plates", "--profile", str(trace)])
    assert rc == 0
    assert sorted(os.listdir(outdir)) == [f"processed_f{i}.jpg" for i in range(3)]
    assert (trace / "trace.json").stat().st_size > 0


def test_cli_refuses_random_weights_without_opt_in(tmp_path):
    cfg = load_config(_config(tmp_path, model=""), strict=False)
    with pytest.raises(ValueError, match="RANDOM weights"):
        build_engine(cfg, with_plates=False, device="cpu")
    assert build_engine(cfg, with_plates=False, allow_random=True, device="cpu") is not None


@pytest.mark.parametrize(
    "setting, item, record_job",
    [(dict(extra="detect_interval=4\n"), "item 12", False),
     (dict(extra="mesh_data=2\n"), "item 17", False),
     (dict(extra="co_batch=true\n"), "item 13", True)],
    ids=["detect_interval", "mesh_data", "co_batch"],
)
def test_cli_refuses_what_is_not_ported(tmp_path, setting, item, record_job):
    mode = [] if record_job else ["--images", str(tmp_path)]
    with pytest.raises(ValueError, match=item):
        main([_config(tmp_path, **setting), *mode, "--device", "cpu"])


def test_cli_refuses_the_record_job_and_needs_a_device(tmp_path, monkeypatch):
    """The record job (no --video or --images) is driven by the config, so
    it refuses a missing one or one without every [PATHS] key, as the JAX
    CLI does, where the one-file modes run with the defaults. No CUDA and
    no --device: the engine refuses to start."""
    with pytest.raises(FileNotFoundError):
        main([str(tmp_path / "missing.ini"), "--device", "cpu"])
    partial = tmp_path / "partial.ini"
    partial.write_text("[PATHS]\nmodel_path=random\nmodel_weights=random\n")
    for cli in (main, jax_cli.main):
        with pytest.raises(ValueError, match="record_dir"):
            cli([str(partial), "--device", "cpu"] if cli is main else [str(partial)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_engine(load_config(_config(tmp_path), strict=False))


def test_engine_auto_probes_the_link_and_picks_as_jax_does(tmp_path):
    """engine=auto: the port's thresholds pick what the JAX package's pick
    at every rate and transfer; the probe gives a positive rate; the build
    resolves to an engine without changing the config; tiered builds the
    tiered pipeline."""
    for rate in (0.5, 2.99, 3.0, 4.0, 5.99, 6.0, 10.0):
        for transfer in ("rgb", "yuv420"):
            assert pick_engine(rate, transfer) == jax_cli.pick_engine(rate, transfer)
    assert pick_engine(4.0) == "tiered" and pick_engine(4.0, "yuv420") == "fused"
    assert probe_link_gib_s("cpu", size_mb=1, reps=1) > 0
    cfg = load_config(_config(tmp_path, engine="auto"), strict=False)
    engine = build_engine(cfg, with_plates=False, device="cpu")
    assert isinstance(engine, (TieredPipeline, DesensitizationEngine)) and cfg.engine == "auto"
    cfg.engine = "tiered"
    assert isinstance(build_engine(cfg, with_plates=False, device="cpu"), TieredPipeline)


def test_one_config_parses_the_same_in_both_packages(tmp_path):
    ini = tmp_path / "full.ini"
    ini.write_text(
        "[PATHS]\nmodel_path = a.pth\nmodel_weights = b.pt\nrecord_dir = r\n"
        "output_h265_dir = h\noutput_videos_dir = v\ntemp_directory_base = t\n"
        "record_output_dir = o\n"
        "[SETTINGS]\nvideo_formats = h265, MP4\ncleanup_temp = false\n"
        "copy_unprocessed_videos = no\nbatch_size = 12\nencode_preset = fast\n"
        "encode_bitrate = 4000000\nencode_threads = 3\n"
        "[TPU]\ndtype = float32\nmesh_data = 1\nmosaic_level = 6\nmax_detections = 40\n"
        "input_size = 320\nconfidence = 0.3\nnms_iou = 0.5\nplate_confidence = 0.25\n"
        "output_fps = 25\nengine = fused\nresume = false\ntransfer = yuv420\n"
        "co_batch = true\nanonymizer = gaussian\ndetect_interval = 2\ntrack_coast = 5\n"
        "track_detect_batch = 4\n"
    )
    mine, theirs = load_config(str(ini)), jax_load_config(str(ini))
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.encode_kwargs == theirs.encode_kwargs
    assert mine.transfer == "yuv420" and mine.batch_size == 12
    text = ini.read_text()
    for old, bad in [("engine = fused", "engine = fast"), ("transfer = yuv420", "transfer = nv12")]:
        ini.write_text(text.replace(old, bad))
        with pytest.raises(ValueError):
            load_config(str(ini))
        with pytest.raises(ValueError):
            jax_load_config(str(ini))
