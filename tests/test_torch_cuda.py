"""The mosaic kernel against its plain PyTorch version, on a CUDA card.

Edge cases beyond chip_smoke.py's full-width ones: level 1, 1x1 and
full-frame boxes, boxes wholly outside the frame or empty, many nested
boxes, odd frame sizes, batch 1; and what the kernel's design makes risky:
many overlapping boxes, boxes that read what another writes, more boxes
than one pass takes, uneven box counts per frame, frames whose rows are not
16-byte aligned, repeat launches and host synchronisation. Then the I420
wrapper (two kernel calls on views of the I420 buffer) against the plain
I420 mosaic, and the I420 engine on the card. Skipped without a CUDA
device. This file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from video_desensitization_torch.ops import cuda_mosaic
from video_desensitization_torch.ops.mosaic import mosaic_boxes_batch, mosaic_i420_batch

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
    bx = torch.from_numpy(np.asarray(boxes, np.int32)).to(cuda)
    ok = torch.from_numpy(np.asarray(valid, bool)).to(cuda)
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


@pytest.mark.parametrize("level", [3, 8])
def test_kernel_many_overlapping_boxes(cuda, level):
    """K = 64 boxes piled on the middle of the frame, each meeting most others."""
    rng = np.random.default_rng(level)
    h, w = 540, 960
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    cx = rng.integers(w // 3, 2 * w // 3, (2, 64))
    cy = rng.integers(h // 3, 2 * h // 3, (2, 64))
    hw = rng.integers(10, w // 3, (2, 64))
    hh = rng.integers(10, h // 3, (2, 64))
    boxes = np.stack([cx - hw, cy - hh, cx + hw, cy + hh], -1)
    _check(cuda, frames, boxes, rng.random((2, 64)) > 0.05, level)


def test_kernel_uneven_box_counts(cuda):
    """B = 16: frame i has i % 6 valid boxes, so several frames have none."""
    rng = np.random.default_rng(16)
    h, w = 270, 480
    frames = rng.integers(0, 256, (16, h, w, 3), dtype=np.uint8)
    boxes, _ = _boxes(rng, 16, 8, h, w)
    valid = np.arange(8)[None, :] < (np.arange(16) % 6)[:, None]
    _check(cuda, frames, boxes, valid, 8)


@pytest.mark.parametrize("last", [[0, 0, 300, 200], [-40, -40, 340, 260]], ids=["exact", "spilling"])
def test_kernel_frame_covered_by_last_box(cuda, last):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (2, 200, 300, 3), dtype=np.uint8)
    boxes, valid = _boxes(rng, 2, 6, 200, 300)
    boxes = np.concatenate([boxes, np.array([[last]] * 2, np.int32)], 1)
    valid = np.concatenate([valid, np.ones((2, 1), bool)], 1)
    _check(cuda, frames, boxes, valid, 8)


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_kernel_boxes_read_each_other(cuda, channels):
    """Frame 0: the second box reads where the first wrote. Frame 1, the
    reverse order: the first box reads where the second then writes."""
    rng = np.random.default_rng(channels)
    frames = rng.integers(0, 256, (2, 203, 310, channels), dtype=np.uint8)
    pair = [[0, 0, 170, 150], [120, 95, 310, 203]]
    boxes = [pair, pair[::-1]]
    _check(cuda, frames, boxes, np.ones((2, 2), bool), 8)


@pytest.mark.parametrize("level", [50, 400])
def test_kernel_level_beyond_box_and_frame(cuda, level):
    """Every box is smaller than the level, and at 400 so is the frame."""
    rng = np.random.default_rng(level)
    h, w = 40, 333
    frames = rng.integers(0, 256, (3, h, w, 2), dtype=np.uint8)
    boxes, valid = _boxes(rng, 3, 12, h, w)
    _check(cuda, frames, boxes, valid, level)


def test_kernel_boxes_in_passes(cuda):
    """K = 300 takes three passes of the kernel, each on the frame the one
    before it left."""
    rng = np.random.default_rng(300)
    h, w = 180, 320
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    boxes, valid = _boxes(rng, 2, 300, h, w)
    _check(cuda, frames, boxes, valid, 8)


@pytest.mark.parametrize("channels", [1, 3])
def test_kernel_unaligned_frames(cuda, channels):
    """A contiguous batch one byte into its storage: the scatter copies a
    byte at a time."""
    rng = np.random.default_rng(channels + 7)
    h, w = 96, 256
    data = rng.integers(0, 256, 2 * h * w * channels + 1, dtype=np.uint8)
    boxes, valid = _boxes(rng, 2, 10, h, w)
    storage = torch.from_numpy(data).to(cuda)
    frames = storage[1:].view(2, h, w, channels)
    assert frames.is_contiguous() and frames.data_ptr() % 16 != 0
    bx, ok = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
    want = mosaic_boxes_batch(frames, bx, ok, 8)
    cuda_mosaic.mosaic_boxes_batch_cuda_(frames, bx, ok, 8)
    torch.cuda.synchronize()
    assert torch.equal(frames, want)
    assert storage[0].item() == data[0]


def test_kernel_is_deterministic(cuda):
    rng = np.random.default_rng(2)
    h, w = 1080, 1920
    frames = torch.from_numpy(rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)).to(cuda)
    boxes, valid = _boxes(rng, 2, 24, h, w)
    bx, ok = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
    first = cuda_mosaic.mosaic_boxes_batch_cuda_(frames.clone(), bx, ok, 8)
    second = cuda_mosaic.mosaic_boxes_batch_cuda_(frames.clone(), bx, ok, 8)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, mosaic_boxes_batch(frames, bx, ok, 8))


def test_kernel_call_does_not_wait_for_the_device(cuda):
    """The boxes stay on the device: after a first call has built the
    library and the table, a call makes no synchronising CUDA call."""
    frames = torch.zeros((2, 64, 96, 3), dtype=torch.uint8, device=cuda)
    boxes = torch.tensor([[[5, 5, 60, 40]], [[-9, 3, 50, 99]]], dtype=torch.int32, device=cuda)
    valid = torch.ones((2, 1), dtype=torch.bool, device=cuda)
    cuda_mosaic.mosaic_boxes_batch_cuda_(frames, boxes, valid, 8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cuda_mosaic.mosaic_boxes_batch_cuda_(frames, boxes, valid, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _check_i420(cuda, yuv, boxes, valid, level):
    """The I420 wrapper against the plain I420 mosaic on the card: in
    place, two kernel calls (none without boxes), bitwise equal."""
    frames = torch.from_numpy(yuv).to(cuda)
    bx = torch.from_numpy(np.asarray(boxes, np.int32).reshape(len(yuv), -1, 4)).to(cuda)
    ok = torch.from_numpy(np.asarray(valid, bool).reshape(len(yuv), -1)).to(cuda)
    want = mosaic_i420_batch(frames, bx, ok, level)
    before = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    got = cuda_mosaic.mosaic_i420_batch_cuda_(frames, bx, ok, level)
    torch.cuda.synchronize()
    assert got is frames
    assert cuda_mosaic.mosaic_boxes_batch_cuda_.launches == before + (2 if bx.shape[1] else 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("level", [1, 3, 8])
@pytest.mark.parametrize("hw", [(1080, 1920), (98, 162)], ids=["1080p", "98x162"])
def test_i420_matches_plain(cuda, hw, level):
    """Boxes with odd and negative edges, spilling past every edge; frame 1
    has no valid box. At 98 rows a chroma plane ends mid-row."""
    rng = np.random.default_rng(level)
    h, w = hw
    yuv = rng.integers(0, 256, (3, h * 3 // 2, w), dtype=np.uint8)
    boxes, valid = _boxes(rng, 3, 30, h, w)
    boxes |= 1  # every edge odd
    valid[1] = False
    _check_i420(cuda, yuv, boxes, valid, level)


def test_i420_special_boxes(cuda):
    rng = np.random.default_rng(420)
    h, w = 120, 200
    yuv = rng.integers(0, 256, (2, h * 3 // 2, w), dtype=np.uint8)
    bl = [
        [-31, -17, w + 33, h + 9],  # past every edge: the whole frame
        [-7, -5, -1, -1],  # wholly outside, above and left
        [w - 1, h - 1, w + 50, h + 50],  # one pixel at the corner
        [13, 7, 14, 8],  # one odd pixel
        [-3, 101, 61, h + 1],  # spills left and into the chroma rows' place
        [199, 0, 201, 119],  # one column at the right edge
    ]
    _check_i420(cuda, yuv, [bl, bl[::-1]], np.ones((2, len(bl)), bool), 8)
    _check_i420(cuda, yuv, np.zeros((2, 0, 4)), np.zeros((2, 0)), 8)  # K = 0
    _check_i420(cuda, yuv, [bl, bl], np.zeros((2, len(bl)), bool), 8)  # none valid


def test_i420_call_does_not_wait_for_the_device(cuda):
    yuv = torch.zeros((2, 96, 96), dtype=torch.uint8, device=cuda)
    boxes = torch.tensor([[[5, 5, 60, 40]], [[-9, 3, 50, 99]]], dtype=torch.int32, device=cuda)
    valid = torch.ones((2, 1), dtype=torch.bool, device=cuda)
    cuda_mosaic.mosaic_i420_batch_cuda_(yuv, boxes, valid, 8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cuda_mosaic.mosaic_i420_batch_cuda_(yuv, boxes, valid, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_engine_process_batch_yuv_on_the_card(cuda):
    """The I420 engine on the card: its blurred frames are the plain I420
    mosaic of its own boxes, and two kernel calls made them."""
    from video_desensitization_torch.detect.face import Retinaface
    from video_desensitization_torch.detect.plate import PlateDetector
    from video_desensitization_torch.pipeline.engine import DesensitizationEngine

    face = Retinaface(backbone="mobilenet", input_shape=[128, 128, 3], max_detections=16,
                      dtype=torch.float32, device=cuda)
    plate = PlateDetector(variant="n", input_shape=(128, 128), max_detections=8,
                          dtype=torch.float32, device=cuda)
    engine = DesensitizationEngine(face, plate, mosaic_level=8)
    yuv = np.random.default_rng(7).integers(0, 256, (2, 144, 160), dtype=np.uint8)
    before = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    res = engine.process_batch_yuv(yuv)
    assert cuda_mosaic.mosaic_boxes_batch_cuda_.launches == before + 2
    assert res.frames.shape == yuv.shape and res.num_faces + res.num_plates > 0
    kept = [f + p for f, p in zip(res.face_boxes, res.plate_boxes)]
    k = max(len(b) for b in kept)
    boxes = np.zeros((2, k, 4), np.float32)
    valid = np.zeros((2, k), bool)
    for i, bl in enumerate(kept):
        boxes[i, : len(bl)] = bl
        valid[i, : len(bl)] = True
    want = mosaic_i420_batch(torch.from_numpy(yuv), torch.from_numpy(boxes.astype(np.int32)),
                             torch.from_numpy(valid), 8)
    np.testing.assert_array_equal(res.frames, want.numpy())


class _Eager:
    """A ``SegmentGraphs`` backend that never captures: the eager path."""

    @staticmethod
    def usable(device):
        return False


def _eager_and_graphed(det, run):
    """``run()`` with the detector's graphs, then with its segments eager."""
    graphed = tuple(t.clone() for t in run())
    own, det._graphs = det._graphs, type(det._graphs)(det._graphs.span_name, _Eager)
    try:
        eager = run()
    finally:
        det._graphs = own
    torch.cuda.synchronize()
    return graphed, eager


def _main_path_detectors(cuda, seed=0, input_hw=(640, 640), backbone="resnet50",
                         dtype=torch.bfloat16):
    from video_desensitization_torch.detect.face import Retinaface
    from video_desensitization_torch.detect.plate import PlateDetector

    face = Retinaface(backbone=backbone, input_shape=[*input_hw, 3], max_detections=128,
                      dtype=dtype, device=cuda, seed=seed)
    plate = PlateDetector(variant="n", input_shape=input_hw, max_detections=64, dtype=dtype,
                          device=cuda, seed=seed)
    return face, plate


def _programs(face, plate, canvas, shapes, lb_geom):
    return {"face": (face, lambda: face._detect_program(canvas, shapes)),
            "plate": (plate, lambda: plate._detect_letterboxed_program(canvas, shapes, lb_geom))}


@pytest.mark.parametrize("which", ["face", "plate"])
def test_graph_replays_are_bitwise_eager_at_batch_16_640(cuda, which):
    """The shared-canvas programs at the main path's sizes: the first call
    eager, the second captures and replays, then replays; each against the
    same detector with its segments run eagerly."""
    from video_desensitization_torch.ops.image import letterbox_params
    from video_desensitization_torch.utils.timers import StageTimer, activate

    face, plate = _main_path_detectors(cuda)
    rng = np.random.default_rng(11)
    shapes = torch.tensor([[1080.0, 1920.0]] * 16, device=cuda)
    lb_geom = torch.tensor([letterbox_params((1080, 1920), (640, 640))] * 16,
                           dtype=torch.float32, device=cuda)
    timer = StageTimer()
    for i in range(4):
        canvas = torch.from_numpy(rng.integers(0, 256, (16, 640, 640, 3), dtype=np.uint8)).to(cuda)
        det, run = _programs(face, plate, canvas, shapes, lb_geom)[which]
        with activate(timer):
            graphed, eager = _eager_and_graphed(det, run)
        for g, e in zip(graphed, eager):
            assert torch.equal(g, e), (i, which)
        assert graphed[-1].any()  # boxes kept
    assert timer.counts[f"{which}.graph"] == 3 and len(det._graphs._graphs) == 1


def test_a_replay_after_load_state_dict_matches_eager_on_the_new_weights(cuda):
    from video_desensitization_torch.ops.image import letterbox_params

    face, plate = _main_path_detectors(cuda, input_hw=(128, 128), backbone="mobilenet",
                                       dtype=torch.float32)
    new_face, new_plate = _main_path_detectors(cuda, seed=7, input_hw=(128, 128),
                                               backbone="mobilenet", dtype=torch.float32)
    rng = np.random.default_rng(12)
    canvas = torch.from_numpy(rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(cuda)
    shapes = torch.tensor([[96.0, 128.0]] * 2, device=cuda)
    lb_geom = torch.tensor([letterbox_params((96, 128), (128, 128))] * 2, dtype=torch.float32,
                           device=cuda)
    for which, (det, run) in _programs(face, plate, canvas, shapes, lb_geom).items():
        before = [t.clone() for t in run()]
        run()  # captured on the old weights
        assert len(det._graphs._graphs) == 1
        det.net.load_state_dict((new_face if which == "face" else new_plate).net.state_dict())
        graphed, eager = _eager_and_graphed(det, run)
        for g, e in zip(graphed, eager):
            assert torch.equal(g, e), which
        assert any(not torch.equal(b, g) for b, g in zip(before, graphed)), which


@pytest.mark.parametrize("which", ["face", "plate", "plate-letterboxed"])
def test_a_replay_after_other_geometries_fill_the_caches_matches_eager(cuda, which):
    """The per-detector programs read cached device constants (the BGR mean,
    the resize tables, the pad) by address from inside their graphs. After
    hundreds of other geometries went through those caches and the freed
    blocks, had there been any, were written over, a replay still equals
    eager bitwise."""
    from video_desensitization_torch.ops.image import _axis_tables
    from video_desensitization_torch.utils.graphs import device_constant

    face, plate = _main_path_detectors(cuda, input_hw=(128, 128), backbone="mobilenet",
                                       dtype=torch.float32)
    from video_desensitization_torch.ops.image import letterbox_params

    det = face if which == "face" else plate
    rng = np.random.default_rng(17)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 96, 160, 3), dtype=np.uint8)).to(cuda)
    shapes = torch.tensor([[96.0, 160.0]] * 2, device=cuda)
    if which == "plate-letterboxed":
        canvas = torch.from_numpy(rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(cuda)
        lb_geom = torch.tensor([letterbox_params((96, 160), (128, 128))] * 2,
                               dtype=torch.float32, device=cuda)
        run = lambda: plate._detect_letterboxed_program(canvas, shapes, lb_geom)
    else:
        run = lambda: det._detect_program(frames, shapes)
    run(), run()  # eager, then captured
    assert len(det._graphs._graphs) == 1
    for i in range(300):
        device_constant((float(i), 0.5, 0.25), torch.float32, cuda)
        device_constant(i % 256, torch.uint8, cuda)
        _axis_tables(97 + i, 128, cuda)
    litter = [torch.full((n,), 7777, dtype=torch.int32, device=cuda)
              for n in (1, 3, 4, 128, 160) for _ in range(200)]
    del litter
    graphed, eager = _eager_and_graphed(det, run)
    for g, e in zip(graphed, eager):
        assert torch.equal(g, e), which


def _engine_batches(seed, n, b=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (b, 1080, 1920, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture
def main_engine(cuda):
    from video_desensitization_torch.pipeline.engine import DesensitizationEngine

    face, plate = _main_path_detectors(cuda)
    return DesensitizationEngine(face, plate, mosaic_level=8)


def test_engine_process_batch_on_graphs_is_bitwise_eager(main_engine):
    """Frames, boxes and keep counts of the main-path engine at batch 16 on
    1080p frames, graphs on against the same engine's segments eager; a
    tail batch of 5 is a key of its own."""
    from video_desensitization_torch.utils.timers import StageTimer, activate

    engine = main_engine
    batches = _engine_batches(13, 4) + _engine_batches(14, 3, b=5)
    timer = StageTimer()
    with activate(timer):
        graphed = [engine.process_batch(f.copy()) for f in batches]
    assert timer.counts["face.graph"] == timer.counts["plate.graph"] == 3 + 2
    dets = (engine.face, engine.plate)
    own = [d._graphs for d in dets]
    for d in dets:
        d._graphs = type(d._graphs)(d._graphs.span_name, _Eager)
    try:
        eager = [engine.process_batch(f.copy()) for f in batches]
    finally:
        for d, g in zip(dets, own):
            d._graphs = g
    for g, e in zip(graphed, eager):
        np.testing.assert_array_equal(g.frames, e.frames)
        assert g.face_boxes == e.face_boxes and g.plate_boxes == e.plate_boxes
        assert (g.num_faces, g.num_plates) == (e.num_faces, e.num_plates)
    assert sum(r.num_faces + r.num_plates for r in graphed) > 0


def test_host_syncs_of_a_batch_on_graphs_are_the_nms_reads(main_engine):
    """In one batch on replayed graphs, every synchronising call the CUDA
    sync debug mode reports is one of NMS's convergence reads."""
    from video_desensitization_torch.profile_engine import host_syncs
    from video_desensitization_torch.utils.timers import StageTimer, activate

    engine = main_engine
    frames = _engine_batches(15, 1)[0]
    for _ in range(3):
        engine.process_batch(frames)
    timer = StageTimer()
    with activate(timer):
        syncs = host_syncs(engine.process_batch, frames)
    assert timer.counts["face.graph"] == timer.counts["plate.graph"] == 1
    assert syncs == timer.counts["nms.flag_read"] > 0
