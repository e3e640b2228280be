"""The capture policy of ``utils/graphs.py::SegmentGraphs`` on the CPU, with
a fake in place of the CUDA graph: which call runs eagerly, which captures
and which replays, the key, the cap and the replay spans, on a toy segment
and on the detectors and engine at tiny sizes (their results equal the
eager path's bitwise). The graphs themselves are held against eager on the
card by ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from video_desensitization_torch.utils import graphs
from video_desensitization_torch.utils.graphs import MAX_KEYS, SegmentGraphs
from video_desensitization_torch.utils.timers import StageTimer, activate


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are tiny and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


class FakeGraph:
    """``CudaGraph`` on the CPU: static input buffers and outputs kept as a
    CUDA graph keeps them; a replay copies the inputs in, runs the segment
    on the static buffers and writes the result into the static outputs."""

    def __init__(self, fn, inputs):
        self.fn = fn
        self.static = [torch.zeros_like(t, memory_format=torch.contiguous_format)
                       for t in inputs]
        self.outputs = fn(*self.static)
        self.replays = 0

    def replay(self, inputs):
        self.replays += 1
        for static, t in zip(self.static, inputs):
            static.copy_(t)
        for out, new in zip(self.outputs, self.fn(*self.static)):
            out.copy_(new)
        return self.outputs


class FakeCuda:
    """A backend that takes every device and captures ``FakeGraph``s."""

    def __init__(self):
        self.graphs = []

    @staticmethod
    def usable(device):
        return True

    def capture(self, fn, inputs):
        self.graphs.append(FakeGraph(fn, inputs))
        return self.graphs[-1]


def _calls(seg, fn, xs):
    """(outputs, spans) of ``seg(fn, x)`` for each x, under a timer."""
    timer = StageTimer()
    outs = []
    with activate(timer):
        for x in xs:
            outs.append(tuple(t.clone() for t in seg(fn, x)))
    return outs, timer.counts.get(seg.span_name, 0)


def test_the_cpu_always_runs_eagerly():
    seg, calls = SegmentGraphs("face.graph"), []

    def segment(x):
        calls.append(x)
        return (x + 1,)

    outs, spans = _calls(seg, segment, [torch.arange(4.0)] * 5)
    assert len(calls) == 5 and spans == 0 and not seg._graphs
    assert all(torch.equal(o[0], torch.arange(4.0) + 1) for o in outs)


@pytest.mark.parametrize("n, eager, captures, replays", [
    (1, 1, 0, 0), (2, 1, 1, 1), (3, 1, 1, 2), (6, 1, 1, 5)])
def test_first_sight_runs_eagerly_the_second_captures_later_ones_replay(n, eager, captures,
                                                                         replays):
    backend, seen = FakeCuda(), []
    seg = SegmentGraphs("plate.graph", backend)

    def segment(x):
        seen.append(x)
        return x * 2, x.sum(-1)

    xs = [torch.full((2, 3), float(i)) for i in range(n)]
    outs, spans = _calls(seg, segment, xs)
    # eager calls see the caller's tensor; the capture sees the static buffer
    assert sum(any(s is x for x in xs) for s in seen) == eager
    assert len(backend.graphs) == captures
    assert sum(g.replays for g in backend.graphs) == replays == spans
    for x, (doubled, summed) in zip(xs, outs):
        assert torch.equal(doubled, x * 2) and torch.equal(summed, x.sum(-1))
    if captures:  # a replay returns the graph's own output buffers
        assert seg(segment, xs[0])[0] is backend.graphs[0].outputs[0]


@pytest.mark.parametrize("what", ["batch", "dtype", "segment", "settings"])
def test_a_new_batch_size_dtype_segment_or_setting_is_a_new_key(what):
    backend = FakeCuda()
    seg = SegmentGraphs("face.graph", backend)

    def segment(x):
        return (x * 3,)

    def other(x):
        return (x * 3,)

    a = torch.ones((16, 4))
    b = {"batch": torch.ones((5, 4)), "dtype": torch.ones((16, 4), dtype=torch.float64)}.get(
        what, a)
    fn_b = other if what == "segment" else segment
    settings = (0.5, 0.4, 64 if what == "settings" else 128)
    seg(segment, a, settings=(0.5, 0.4, 128)), seg(segment, a, settings=(0.5, 0.4, 128))
    assert len(backend.graphs) == 1
    seg(fn_b, b, settings=settings)  # first sight of the new key: eager
    assert len(backend.graphs) == 1 and len(seg._graphs) == 1
    out = seg(fn_b, b, settings=settings)
    assert len(backend.graphs) == 2 and len(seg._graphs) == 2
    assert torch.equal(out[0], b * 3)


def test_past_the_cap_the_segment_runs_eagerly():
    backend = FakeCuda()
    seg = SegmentGraphs("face.graph", backend)
    xs, eager = [], []

    def segment(x):
        if any(x is c for c in xs):  # the caller's tensor, not a static buffer
            eager.append(x.shape[0])
        return (x + 1,)

    for b in range(1, MAX_KEYS + 3):
        for _ in range(3):
            xs.append(torch.full((b, 2), float(b)))
            assert torch.equal(seg(segment, xs[-1])[0], xs[-1] + 1)
    assert len(backend.graphs) == MAX_KEYS
    assert sum(g.replays for g in backend.graphs) == 2 * MAX_KEYS
    # the first MAX_KEYS shapes ran eagerly once; the two past the cap always
    assert eager == list(range(1, MAX_KEYS + 1)) + [
        b for b in range(MAX_KEYS + 1, MAX_KEYS + 3) for _ in range(3)]


@pytest.mark.parametrize("before", ["one-off keys", "a key seen before the last capture"])
def test_keys_seen_once_take_no_slot(before):
    """One-off calls and stream tails count against no cap: only graphs do,
    and a key seen once is forgotten at the next capture."""
    backend = FakeCuda()
    seg = SegmentGraphs("face.graph", backend)

    def segment(x):
        return (x + 1,)

    def key(b):
        return torch.zeros((b, 2))

    if before == "one-off keys":
        for b in range(100, 100 + 3 * MAX_KEYS):
            seg(segment, key(b))
        assert not backend.graphs
        for b in range(1, MAX_KEYS + 1):
            seg(segment, key(b)), seg(segment, key(b))
        assert len(backend.graphs) == MAX_KEYS
    else:
        seg(segment, key(5))  # a tail, seen once
        seg(segment, key(16)), seg(segment, key(16))  # captured: 5 forgotten
        seg(segment, key(5))
        assert len(backend.graphs) == 1
        seg(segment, key(5))
        assert len(backend.graphs) == 2


def test_the_keys_seen_once_are_bounded():
    seg = SegmentGraphs("face.graph", FakeCuda())
    for b in range(1, 3 * graphs.MAX_SEEN):
        seg(lambda x: (x,), torch.zeros((b,)))
        assert len(seg._seen) <= graphs.MAX_SEEN
    assert not seg._graphs


@pytest.mark.parametrize("cache", ["device_constant", "axis_tables"])
def test_a_cached_constant_outlives_any_number_of_other_geometries(cache):
    """A captured graph reads these by address and keeps none alive, so no
    later geometry may evict them."""
    from video_desensitization_torch.ops.image import _axis_tables

    cpu = torch.device("cpu")
    if cache == "device_constant":
        def make(i):
            return graphs.device_constant((float(i), 1.0, 2.0), torch.float32, cpu)
    else:
        def make(i):
            return _axis_tables(1080 + i, 640, cpu)[0][0]
    first = make(0)
    for i in range(1, 400):
        make(i)
    assert make(0) is first


def test_the_cuda_backend_refuses_a_cpu_tensor():
    assert not graphs.CudaGraphs.usable(torch.device("cpu"))


def test_device_constant_is_made_once_and_outside_inference_mode():
    with torch.inference_mode():
        a = graphs.device_constant((104.0, 117.0, 123.0), torch.float32, torch.device("cpu"))
    b = graphs.device_constant((104.0, 117.0, 123.0), torch.float32, torch.device("cpu"))
    assert a is b and not a.is_inference()
    assert torch.equal(a, torch.tensor([104.0, 117.0, 123.0]))


@pytest.fixture(scope="module")
def engine_pair():
    """Two engines on the same weights: one eager, one whose detectors
    capture fake graphs."""
    from video_desensitization_torch.bench_util import main_path_engine

    eager = main_path_engine(device="cpu", backbone="mobilenet", input_hw=(64, 64),
                             dtype=torch.float32)
    graphed = main_path_engine(device="cpu", backbone="mobilenet", input_hw=(64, 64),
                               dtype=torch.float32)
    graphed.face._graphs = SegmentGraphs("face.graph", FakeCuda())
    graphed.plate._graphs = SegmentGraphs("plate.graph", FakeCuda())
    return eager, graphed


@pytest.mark.parametrize("share_letterbox", [True, False], ids=["shared", "per-detector"])
def test_each_replay_opens_one_span_and_the_engine_matches_eager(engine_pair, share_letterbox):
    eager, graphed = engine_pair
    eager.share_letterbox = graphed.share_letterbox = share_letterbox
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, (2, 48, 96, 3), dtype=np.uint8) for _ in range(4)]
    timer = StageTimer()
    graphed_before = {n: sum(g.replays for g in d._graphs.backend.graphs)
                      for n, d in (("face", graphed.face), ("plate", graphed.plate))}
    with activate(timer):
        results = [graphed.process_batch(f) for f in batches]
    for frames, got in zip(batches, results):
        want = eager.process_batch(frames)
        np.testing.assert_array_equal(got.frames, want.frames)
        assert got.face_boxes == want.face_boxes and got.plate_boxes == want.plate_boxes
    for name, det in (("face", graphed.face), ("plate", graphed.plate)):
        replays = sum(g.replays for g in det._graphs.backend.graphs) - graphed_before[name]
        assert timer.counts[f"{name}.graph"] == replays
        assert timer.counts[f"{name}.program"] == len(batches)
    # each detector's key is new to it: the first batch eager, the rest replays
    assert timer.counts["face.graph"] == timer.counts["plate.graph"] == len(batches) - 1


def test_each_mesh_replica_keeps_its_own_graphs():
    from video_desensitization_torch.detect.face import Retinaface
    from video_desensitization_torch.detect.plate import PlateDetector
    from video_desensitization_torch.parallel.mesh import make_mesh

    mesh = make_mesh([torch.device("cpu")] * 2)
    face = Retinaface(backbone="mobilenet", input_shape=[64, 64, 3], dtype=torch.float32,
                      device="cpu")
    plate = PlateDetector(input_shape=(64, 64), dtype=torch.float32, device="cpu")
    for det, name in ((face, "face.graph"), (plate, "plate.graph")):
        replicas = det.replicate(mesh)
        owned = [det._graphs] + [r._graphs for r in replicas]
        assert len({id(g) for g in owned}) == 3
        assert all(g.span_name == name for g in owned)
