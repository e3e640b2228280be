"""The multi-scale deformable attention kernel and the RT-DETR plate
program on a CUDA card.

The kernel (``csrc/msda.cu``) against its plain PyTorch form
(``ops/msda.py::msda_plain``, ``F.grid_sample`` a level) at RT-DETR-R50's
published shapes in float32 and bfloat16, with points outside the maps and
on their edges; one call, one count, no host sync. Then the RT-DETR
detector's program (``detect/detr.py``: one CUDA graph from the frames to
the rows) against the same detector run eagerly, bitwise, at batch 16 on
1080p frames, also after ``load_state_dict``; and the engine's host syncs
a batch with RT-DETR in the plate slot: the face's NMS reads alone.
Skipped without a CUDA device; imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_rtdetr.py -q
"""

import numpy as np
import pytest
import torch

from video_desensitization_torch.ops import cuda_msda
from video_desensitization_torch.ops.msda import msda_plain

pytestmark = pytest.mark.cuda

PUBLISHED_SHAPES = ((80, 80), (40, 40), (20, 20))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _msda_inputs(device, dtype, b=16, q=300, heads=8, d=32, shapes=PUBLISHED_SHAPES, points=4,
                 seed=0, spread=2.0):
    """Seeded value, offsets, logits and boxes; ``spread`` scales the
    offsets so that many points leave the maps."""
    g = torch.Generator().manual_seed(seed)
    s = sum(h * w for h, w in shapes)
    value = torch.randn(b, s, heads, d, generator=g).to(device, dtype)
    ref = torch.rand(b, q, 4, generator=g)
    ref[..., 2:] *= 0.6
    offsets = torch.randn(b, q, heads, len(shapes), points, 2, generator=g) * spread
    logits = torch.randn(b, q, heads, len(shapes) * points, generator=g) * 2
    return value, offsets.to(device), logits.to(device), ref.to(device)


def _assert_close(got, want, dtype):
    """float32: the kernel sums in another order, with fused multiply-adds;
    bfloat16: its output is rounded once more, to half a bf16 step."""
    want = want.float()
    slack = 1e-4 + (2.0 ** -8 * want.abs() if dtype == torch.bfloat16 else 1e-4 * want.abs())
    gap = (got.float() - want).abs()
    assert bool((gap <= slack).all()), float(gap.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_kernel_matches_plain_at_the_published_shapes(cuda, dtype):
    value, offsets, logits, ref = _msda_inputs(cuda, dtype)
    before = cuda_msda.msda_cuda.launches
    got = cuda_msda.msda_cuda(value, PUBLISHED_SHAPES, offsets, logits, ref)
    torch.cuda.synchronize()
    assert cuda_msda.msda_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (16, 300, 256)
    _assert_close(got, msda_plain(value.float(), PUBLISHED_SHAPES, offsets, logits, ref), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_kernel_on_edges_and_outside_the_maps(cuda, dtype):
    """Points exactly on a map's edges and corners, on its first and last
    sample centres, and wholly outside; levels that are not square."""
    shapes = ((5, 7), (3, 4), (1, 2))
    value, offsets, logits, _ = _msda_inputs(cuda, dtype, b=2, q=12, shapes=shapes)
    xy = torch.tensor([0.0, 1.0, 0.5 / 7, 1 - 0.5 / 7, -0.3, 1.3, 0.5, -1e-7, 1 + 1e-7, 0.25,
                       0.75, 2.0])
    ref = torch.stack([xy, xy.flip(0), torch.zeros(12), torch.zeros(12)], -1)
    ref = ref[None].expand(2, -1, -1).contiguous().to(cuda)  # zero sides: loc is the centre
    got = cuda_msda.msda_cuda(value, shapes, offsets, logits, ref)
    _assert_close(got, msda_plain(value.float(), shapes, offsets, logits, ref), dtype)
    wide = ref.clone()
    wide[..., 2:] = 1.0
    got = cuda_msda.msda_cuda(value, shapes, offsets * 4, logits, wide)
    _assert_close(got, msda_plain(value.float(), shapes, offsets * 4, logits, wide), dtype)


def test_msda_cuda_tensors_never_take_the_plain_path(cuda, monkeypatch):
    def refuse(*args):
        raise AssertionError("the plain path ran on a CUDA tensor")

    monkeypatch.setattr(cuda_msda, "msda_plain", refuse)
    value, offsets, logits, ref = _msda_inputs(cuda, torch.bfloat16, b=1, q=4)
    cuda_msda.msda_cuda(value, PUBLISHED_SHAPES, offsets, logits, ref)
    with pytest.raises(ValueError):
        cuda_msda.msda_cuda(value, PUBLISHED_SHAPES, offsets.double(), logits, ref)


def test_msda_call_does_not_wait_for_the_device(cuda):
    args = _msda_inputs(cuda, torch.bfloat16, b=2, q=16)
    cuda_msda.msda_cuda(args[0], PUBLISHED_SHAPES, *args[1:])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cuda_msda.msda_cuda(args[0], PUBLISHED_SHAPES, *args[1:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


class _Eager:
    """A ``SegmentGraphs`` backend that never captures: the eager path."""

    @staticmethod
    def usable(device):
        return False


def _eager_and_graphed(det, run):
    graphed = tuple(t.clone() for t in run())
    own, det._graphs = det._graphs, type(det._graphs)(det._graphs.span_name, _Eager)
    try:
        eager = run()
    finally:
        det._graphs = own
    torch.cuda.synchronize()
    return graphed, eager


def _detector(cuda, seed=0, input_hw=(640, 640), dtype=torch.bfloat16):
    from video_desensitization_torch.detect.detr import RtDetrPlateDetector

    return RtDetrPlateDetector(input_shape=input_hw, max_detections=64, dtype=dtype,
                               device=cuda, seed=seed)


def test_the_rtdetr_program_replays_bitwise_eager_at_batch_16(cuda):
    """The whole program, frames to rows, at the published size on 1080p
    frames: eager, captured, replayed, replayed; each against eager."""
    from video_desensitization_torch.utils.timers import StageTimer, activate

    det = _detector(cuda)
    rng = np.random.default_rng(21)
    shapes = torch.tensor([[1080.0, 1920.0]] * 16, device=cuda)
    timer = StageTimer()
    before = cuda_msda.msda_cuda.launches
    for i in range(4):
        frames = torch.from_numpy(rng.integers(0, 256, (16, 1080, 1920, 3),
                                               dtype=np.uint8)).to(cuda)
        with activate(timer):
            graphed, eager = _eager_and_graphed(det, lambda: det._detect_program(frames, shapes))
        for g, e in zip(graphed, eager):
            assert torch.equal(g, e), i
        assert graphed[1].any()
    assert timer.counts["plate.graph"] == 3 and len(det._graphs._graphs) == 1
    assert "nms.flag_read" not in timer.counts
    # six decoder layers a program: 4 eager runs, the first eager run and the capture
    assert cuda_msda.msda_cuda.launches - before == 6 * (4 + 2)


def test_an_rtdetr_replay_after_load_state_dict_matches_eager(cuda):
    det, new = _detector(cuda, input_hw=(128, 128), dtype=torch.float32), _detector(
        cuda, seed=7, input_hw=(128, 128), dtype=torch.float32)
    frames = torch.from_numpy(np.random.default_rng(22).integers(
        0, 256, (2, 96, 160, 3), dtype=np.uint8)).to(cuda)
    shapes = torch.tensor([[96.0, 160.0]] * 2, device=cuda)
    run = lambda: det._detect_program(frames, shapes)  # noqa: E731
    before = [t.clone() for t in run()]
    run()
    assert len(det._graphs._graphs) == 1
    det.net.load_state_dict(new.net.state_dict())
    graphed, eager = _eager_and_graphed(det, run)
    for g, e in zip(graphed, eager):
        assert torch.equal(g, e)
    assert any(not torch.equal(b, g) for b, g in zip(before, graphed))


@pytest.fixture
def detr_engine(cuda):
    from video_desensitization_torch.detect.face import Retinaface
    from video_desensitization_torch.pipeline.engine import DesensitizationEngine

    face = Retinaface(backbone="resnet50", input_shape=[640, 640, 3], max_detections=128,
                      dtype=torch.bfloat16, device=cuda, seed=0)
    return DesensitizationEngine(face, _detector(cuda), mosaic_level=8)


def test_engine_with_rtdetr_on_graphs_is_bitwise_eager(detr_engine):
    from video_desensitization_torch.utils.timers import StageTimer, activate

    engine = detr_engine
    rng = np.random.default_rng(23)
    batches = [rng.integers(0, 256, (16, 1080, 1920, 3), dtype=np.uint8) for _ in range(3)]
    timer = StageTimer()
    with activate(timer):
        graphed = [engine.process_batch(f.copy()) for f in batches]
    assert timer.counts["plate.graph"] == 2
    own = [d._graphs for d in (engine.face, engine.plate)]
    for d in (engine.face, engine.plate):
        d._graphs = type(d._graphs)(d._graphs.span_name, _Eager)
    try:
        eager = [engine.process_batch(f.copy()) for f in batches]
    finally:
        engine.face._graphs, engine.plate._graphs = own
    for g, e in zip(graphed, eager):
        np.testing.assert_array_equal(g.frames, e.frames)
        assert g.face_boxes == e.face_boxes and g.plate_boxes == e.plate_boxes
    assert sum(r.num_plates for r in graphed) > 0


def test_host_syncs_of_a_batch_with_rtdetr_are_the_face_nms_reads(detr_engine):
    """With RT-DETR in the plate slot, every synchronising call of a batch
    on replayed graphs is one of the face's NMS reads."""
    from video_desensitization_torch.profile_engine import host_syncs
    from video_desensitization_torch.utils.timers import StageTimer, activate

    engine = detr_engine
    frames = np.random.default_rng(24).integers(0, 256, (16, 1080, 1920, 3), dtype=np.uint8)
    for _ in range(3):
        engine.process_batch(frames)
    timer = StageTimer()
    with activate(timer):
        syncs = host_syncs(engine.process_batch, frames)
    assert timer.counts["face.graph"] == timer.counts["plate.graph"] == 1
    assert syncs == timer.counts["nms.flag_read"] > 0
