"""The port's device mesh (``parallel/mesh.py``) in one process against the
JAX package's on its 8 virtual CPU devices: mesh shapes and errors, the
padding, the fused engine on an 8-shard CPU mesh (RGB and I420, an odd
batch of 5), both detectors' ``detect_padded`` and ``get_FPS``, the
co-batched record job on a mesh, ``data_parallel_program`` with no
collective, ``shard_batch_multihost`` in one process; and the mosaic
kernel's device guard and launch count, through a stub library.

Small sizes: 96x160 frames, RetinaFace-mobilenet + YOLOv8n at 128 in
float32 with the JAX package's weights. A CPU mesh repeats the one CPU
device, as the JAX tests' 8 virtual devices stand in for chips.
"""

import contextlib
import dataclasses
import sys
import threading
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from test_torch_multicam import RecordingEncoder, _job_config, _jobs, job_record  # noqa: F401

from video_desensitization_tpu.detect.face import Retinaface as JaxRetinaface
from video_desensitization_tpu.detect.plate import PlateDetector as JaxPlateDetector
from video_desensitization_tpu.parallel import mesh as jax_mesh
from video_desensitization_tpu.pipeline import multicam as jax_multicam
from video_desensitization_tpu.pipeline.engine import DesensitizationEngine as JaxEngine

from video_desensitization_torch.api.config import load_config
from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.detect.plate import PlateDetector
from video_desensitization_torch.models.convert import from_jax_variables
from video_desensitization_torch.ops import cuda_mosaic
from video_desensitization_torch.ops.yuv import rgb_to_i420_host
from video_desensitization_torch.parallel.mesh import (
    batch_sharding,
    data_parallel_program,
    make_mesh,
    pad_batch_to_devices,
    replicated,
    shard_batch,
    shard_batch_multihost,
    shard_params,
)
from video_desensitization_torch.pipeline import multicam
from video_desensitization_torch.pipeline.engine import DesensitizationEngine
from video_desensitization_torch.pipeline.multicam import process_videos_cobatched
from video_desensitization_torch.pipeline.video_pipeline import process_record_job
from video_desensitization_torch.video import av

CPU8 = [torch.device("cpu")] * 8
FACE = dict(backbone="mobilenet", input_shape=[128, 128, 3], max_detections=16)
PLATE = dict(variant="n", input_shape=(128, 128), max_detections=8)
H, W = 96, 160


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are small and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


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
def jax_mesh_engine(detectors):
    """One JAX engine on make_mesh() for the module: its program compiles
    once per shape."""
    jface, jplate, _, _ = detectors
    return JaxEngine(jface, jplate, mosaic_level=8, mesh=jax_mesh.make_mesh())


def test_make_mesh_shapes_and_errors(monkeypatch):
    """The JAX rules and messages on 8 devices; no devices and no CUDA:
    raise (no CPU mesh by default); a repeated card outside gloo: raise."""
    assert make_mesh(CPU8).shape == dict(jax_mesh.make_mesh().shape) == {"data": 8, "model": 1}
    assert make_mesh(CPU8, data=4, model=2).shape == dict(jax_mesh.make_mesh(data=4, model=2).shape)
    assert make_mesh(CPU8, data=4, model=2).devices.shape == (4, 2)
    for kwargs in (dict(data=3, model=3), dict(model=3), dict(data=2)):
        with pytest.raises(ValueError) as mine:
            make_mesh(CPU8, **kwargs)
        with pytest.raises(ValueError) as theirs:
            jax_mesh.make_mesh(**kwargs)
        assert str(mine.value) == str(theirs.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError, match="gloo"):
        make_mesh([torch.device("cuda", 0)] * 2)
    mesh = make_mesh(CPU8, data=4, model=2)
    assert batch_sharding(mesh, 2).spec == ("data", None) and replicated(mesh).spec == ()


def test_pad_batch_to_devices():
    x = np.arange(5 * 2).reshape(5, 2)
    padded, n = pad_batch_to_devices(x, 8)
    assert padded.shape == (8, 2) and n == 5
    np.testing.assert_array_equal(padded[5:], np.tile(x[-1:], (3, 1)))
    theirs, n_theirs = jax_mesh.pad_batch_to_devices(x, 8)
    np.testing.assert_array_equal(padded, theirs)
    assert n_theirs == n
    same, n4 = pad_batch_to_devices(x[:4], 4)
    assert n4 == 4 and same.shape == (4, 2)


def _assert_results(got, want, n):
    assert len(got.face_boxes) == len(got.plate_boxes) == n
    assert got.num_faces == want.num_faces and got.num_plates == want.num_plates
    for g, w in zip(got.face_boxes + got.plate_boxes, want.face_boxes + want.plate_boxes):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got.frames, want.frames)


@pytest.mark.parametrize("form", ["rgb", "i420"])
def test_engine_on_a_mesh_matches_jax(detectors, jax_mesh_engine, form):
    """An odd batch of 5 on 8 shards: the port's mesh engine against the JAX
    engine on make_mesh() and against the port's single-device engine:
    frames bitwise, boxes within rtol 1e-5 and atol 1e-3, the caller's
    batch length."""
    _, _, face, plate = detectors
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (5, H, W, 3), dtype=np.uint8)
    if form == "i420":
        frames = np.stack([rgb_to_i420_host(f) for f in frames])
    engine = DesensitizationEngine(face, plate, mosaic_level=8, mesh=make_mesh(CPU8))
    solo = DesensitizationEngine(face, plate, mosaic_level=8)
    run = (lambda e: e.process_batch_yuv(frames)) if form == "i420" else (
        lambda e: e.process_batch(frames))
    got = run(engine)
    assert got.frames.shape == frames.shape and got.num_faces + got.num_plates > 0
    _assert_results(got, run(jax_mesh_engine), 5)
    _assert_results(got, run(solo), 5)
    handles = [engine.dispatch_batch(frames), engine.dispatch_batch(frames[:3])]
    first, second = (engine.finalize_batch(h) for h in handles)
    np.testing.assert_array_equal(first.frames, got.frames)
    np.testing.assert_array_equal(second.frames, got.frames[:3])


def test_detectors_on_a_mesh(detectors):
    """detect_padded on 8 shards (a batch of 10: padded to 16) against the
    JAX detectors on make_mesh(): keep masks equal, boxes within rtol 1e-5
    and atol 1e-3; get_FPS through the pad path (one frame on 8 shards)."""
    jface, jplate, face, plate = detectors
    mesh, jmesh = make_mesh(CPU8), jax_mesh.make_mesh()
    tree = lambda v: jax.tree.map(np.asarray, dict(v))  # noqa: E731
    mface = Retinaface(state_dict=from_jax_variables(tree(jface.variables)),
                       dtype=torch.float32, device="cpu", mesh=mesh, **FACE)
    mplate = PlateDetector(state_dict=from_jax_variables(tree(jplate.variables)),
                           dtype=torch.float32, device="cpu", mesh=mesh, **PLATE)
    jmface = JaxRetinaface(variables=jface.variables, dtype=jnp.float32, mesh=jmesh, **FACE)
    jmplate = JaxPlateDetector(variables=jplate.variables, dtype=jnp.float32, mesh=jmesh, **PLATE)
    imgs = np.random.default_rng(5).integers(0, 256, (10, H, W, 3), dtype=np.uint8)
    _, px, keep = mface.detect_padded(imgs)
    _, jpx, jkeep = jmface.detect_padded(imgs)
    assert px.shape[0] == 10 and keep.any()
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(px.numpy(), np.asarray(jpx), rtol=1e-5, atol=1e-3)
    dets, keep = mplate.detect_padded(imgs)
    jdets, jkeep = jmplate.detect_padded(imgs)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(dets.numpy(), np.asarray(jdets), rtol=1e-5, atol=1e-3)
    single = face.detect_padded(imgs)
    np.testing.assert_array_equal(single[2].numpy(), mface.detect_padded(imgs)[2].numpy())
    assert mface.get_FPS(imgs[0], test_interval=1) > 0
    assert mface.get_map_txt(imgs[0]).shape[1] == 15


def test_data_parallel_program_runs_no_collective(detectors, monkeypatch):
    """No torch.distributed call on the inference path: every collective
    raises, and the engine and a detector still run on 8 shards."""
    _, _, face, plate = detectors

    def refuse(*args, **kwargs):
        raise AssertionError("a collective ran at inference")

    for name in ("all_reduce", "all_gather", "broadcast", "reduce_scatter", "all_to_all",
                 "send", "recv", "barrier", "new_group", "init_process_group"):
        monkeypatch.setattr(dist, name, refuse)
    mesh = make_mesh(CPU8)
    frames = np.random.default_rng(1).integers(0, 256, (3, H, W, 3), dtype=np.uint8)
    res = DesensitizationEngine(face, plate, mesh=mesh).process_batch(frames)
    assert res.frames.shape == frames.shape
    prog = data_parallel_program(mesh, lambda net, x: net(x)[:1], 1, 1, 1)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(16, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        (out,) = prog(shard_params(mesh, face.net), shard_batch(mesh, x))
        torch.testing.assert_close(out, face.net(x)[0], rtol=1e-5, atol=1e-5)


def test_shard_batch_multihost_equals_shard_batch():
    """In one process the local-feed path is shard_batch: the same shards
    on the same devices, a dict batch included."""
    mesh = make_mesh(CPU8, data=4, model=2)
    rng = np.random.default_rng(7)
    batch = {"frames": rng.integers(0, 255, (8, 16, 16, 3), dtype=np.uint8),
             "shapes": rng.normal(size=(8, 2)).astype(np.float32)}
    a, b = shard_batch(mesh, batch), shard_batch_multihost(mesh, batch)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        for k in batch:
            assert x[k].device == y[k].device and x[k].shape[0] == 2
            np.testing.assert_array_equal(x[k].numpy(), y[k].numpy())
    np.testing.assert_array_equal(np.concatenate([s["frames"].numpy() for s in a]), batch["frames"])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, batch["frames"][:6])


def test_cobatched_cameras_on_a_mesh_match_jax(tmp_path, detectors, jax_mesh_engine, monkeypatch):
    """process_videos_cobatched with the mesh engine in both packages (two
    96x160 cameras of 7 and 5 frames, batch 4 on 8 shards): each camera's
    encoder is handed the same frames, bitwise, and the stats are equal."""
    if not av.native_available():
        pytest.skip(f"native av layer unavailable: {av.codec_path()}")
    _, _, face, plate = detectors
    RecordingEncoder.written = {}
    monkeypatch.setattr(multicam, "VideoEncoder", RecordingEncoder)
    monkeypatch.setattr(jax_multicam, "VideoEncoder", RecordingEncoder)
    srcs = _jobs(tmp_path, {"front": 7, "rear": 5}, shapes={"front": (H, W), "rear": (H, W)})
    engine = DesensitizationEngine(face, plate, mosaic_level=8, mesh=make_mesh(CPU8))
    stats = []
    for name, fn, eng in (("mine", process_videos_cobatched, engine),
                          ("theirs", jax_multicam.process_videos_cobatched, jax_mesh_engine)):
        jobs = {cam: (src, f"{name}_{cam}.mp4") for cam, (src, _) in srcs.items()}
        stats.append(fn(jobs, eng, batch_size=4))
    assert {c: dataclasses.astuple(s) for c, s in stats[0].items()} == {
        c: dataclasses.astuple(s) for c, s in stats[1].items()}
    for cam, n in (("front", 7), ("rear", 5)):
        mine, theirs = RecordingEncoder.written[f"mine_{cam}.mp4"], RecordingEncoder.written[f"theirs_{cam}.mp4"]
        assert len(mine) == len(theirs) == n
        for (_, a), (_, b) in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)


def test_record_job_cobatched_on_a_mesh(tmp_path, detectors, job_record):
    """The whole record job (unpack, the co-batched fused engine on 8
    shards, repack) against the same job on one device: the same stats,
    and every camera message comes back in the final record."""
    if not av.native_available():
        pytest.skip(f"native av layer unavailable: {av.codec_path()}")
    from video_desensitization_torch.record.reader import RecordReader
    from video_desensitization_torch.record.topics import CAMERA_TOPICS

    _, _, face, plate = detectors
    runs = {}
    for name, mesh in (("mesh", make_mesh(CPU8)), ("solo", None)):
        cfg = load_config(_job_config(tmp_path, name, job_record))
        runs[name] = process_record_job(cfg, DesensitizationEngine(face, plate, mesh=mesh))
    mine = runs["mesh"]
    assert (mine.videos_processed, mine.videos_failed, mine.frames) == (2, 0, 16)
    assert dataclasses.astuple(mine)[:6] == dataclasses.astuple(runs["solo"])[:6]
    final = RecordReader(mine.record_path)
    assert [final.message_count(t) for t in CAMERA_TOPICS[:2]] == [8, 8]


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on cuda:1, so that the wrappers take
    their card branch without a card."""

    @property
    def device(self):
        return torch.device("cuda", 1)

    def to(self, *args, **kwargs):
        kwargs.pop("device", None)
        return super().to(*args, **kwargs)


def test_mosaic_launch_enters_the_frames_device_and_counts_exactly(monkeypatch):
    """Both wrappers, through a stub library, from 8 threads whose current
    device is another one: every launch runs inside torch.cuda.device of
    the frames' card, and 8 threads x 100 calls (50 RGB, 50 I420: 2 kernel
    calls each) count exactly 1200, with the thread switch interval cut
    so that an unlocked count would lose updates."""
    entered = threading.local()
    seen = []

    @contextlib.contextmanager
    def device_guard(device):
        previous = getattr(entered, "device", None)
        entered.device = torch.device(device)
        try:
            yield
        finally:
            entered.device = previous

    def launch(*args):
        seen.append(getattr(entered, "device", None))
        return 0

    lib = types.SimpleNamespace(vdt_mosaic_launch=launch,
                                vdt_mosaic_scratch_bytes=lambda b, h, w, c: 64)
    monkeypatch.setattr(cuda_mosaic, "load_library", lambda: lib)
    monkeypatch.setattr(cuda_mosaic, "_device_table",
                        lambda level, maxdim, device: torch.zeros(1, dtype=torch.int16))
    monkeypatch.setattr(torch.cuda, "device", device_guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    rgb = torch.zeros((1, 8, 8, 3), dtype=torch.uint8).as_subclass(_OnCard)
    yuv = torch.zeros((1, 12, 8), dtype=torch.uint8).as_subclass(_OnCard)
    boxes = torch.tensor([[[0, 0, 4, 4]]], dtype=torch.int32).as_subclass(_OnCard)
    valid = torch.ones((1, 1), dtype=torch.bool).as_subclass(_OnCard)

    def work():
        entered.device = torch.device("cuda", 0)  # the thread's own current device
        for _ in range(50):
            cuda_mosaic.mosaic_boxes_batch_cuda_(rgb, boxes, valid, 8)
            cuda_mosaic.mosaic_i420_batch_cuda_(yuv, boxes, valid, 8)

    cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(seen) == 1200 and set(seen) == {torch.device("cuda", 1)}
    assert cuda_mosaic.mosaic_boxes_batch_cuda_.launches == 1200
