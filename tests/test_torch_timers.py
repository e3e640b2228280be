"""The port's stage timer and its nested spans: ``StageTimer.child``,
``activate`` and ``span`` (``utils/timers.py``), and the spans the fused
engine, the detectors and NMS open on the CPU."""

import contextlib
import queue
import threading
import time

import numpy as np
import pytest
import torch

from video_desensitization_torch.ops.nms import batched_nms_padded
from video_desensitization_torch.utils.timers import StageTimer, activate, span


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tensors are tiny and the suite runs
    several workers at once, so more threads only contend for the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _recording(items):
    """A subclass that keeps each span (name, start, end) in ``items`` and
    calls its instance's ``hook`` as each of its stages opens, as a
    benchmark's timer does."""

    class Recording(StageTimer):
        hook = None

        @contextlib.contextmanager
        def stage(self, name):
            if self.hook is not None:
                self.hook(name)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                self.totals[name] += t1 - t0
                self.counts[name] += 1
                items.append((name, t0, t1))

    return Recording()


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_child_spans_nest_and_report_includes_them():
    timer = StageTimer()
    child = timer.child()
    assert type(child) is StageTimer and timer.children == [child]
    with timer.stage("dispatch"), activate(child):
        with span("engine.stage_in"):
            pass
        with span("engine.stage_in"):
            with span("nms.flag_read"):
                pass
    assert dict(timer.counts) == {"dispatch": 1}
    assert dict(child.counts) == {"engine.stage_in": 2, "nms.flag_read": 1}
    report = timer.report()
    assert set(report) == {"dispatch", "engine.stage_in", "nms.flag_read"}
    assert report["engine.stage_in"] == child.totals["engine.stage_in"]
    assert report["dispatch"] >= report["engine.stage_in"]
    assert "engine.stage_in" in timer.summary() and "(x2)" in timer.summary()
    grandchild = child.child()  # a child's children are reported too
    with grandchild.stage("deep"):
        pass
    assert "deep" in timer.report() and "deep" in timer.summary()


def test_a_span_without_a_current_timer_records_nothing():
    with span("engine.stage_in"):
        pass  # no timer current: a null context
    timer = StageTimer()
    seen = []

    def other_thread():
        with span("engine.stage_in"):
            seen.append(True)

    with activate(timer):
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
    with span("engine.stage_in"):
        pass  # the block ended: no timer current again
    assert seen == [True] and dict(timer.counts) == {}


def test_a_span_raising_inside_is_recorded_and_activate_restores():
    outer, inner = StageTimer(), StageTimer()
    with activate(outer):
        with pytest.raises(ValueError), activate(inner), span("engine.wait"):
            raise ValueError("inside")
        with span("engine.gather"):
            pass
    assert dict(inner.counts) == {"engine.wait": 1} and dict(outer.counts) == {"engine.gather": 1}


def test_a_subclass_child_records_where_the_subclass_records_without_its_hook():
    items, hooked = [], []
    timer = _recording(items)
    timer.hook = hooked.append
    child = timer.child()
    assert type(child) is type(timer) and child.hook is None
    with timer.stage("dispatch"), activate(child):
        with span("engine.stage_in"):
            pass
        with span("nms.flag_read"):
            pass
    assert hooked == ["dispatch"]
    assert [n for n, _, _ in items] == ["engine.stage_in", "nms.flag_read", "dispatch"]
    assert dict(child.counts) == {"engine.stage_in": 1, "nms.flag_read": 1}


@pytest.fixture(scope="module")
def engine():
    from video_desensitization_torch.bench_util import main_path_engine

    return main_path_engine(device="cpu", backbone="mobilenet", input_hw=(128, 128),
                            dtype=torch.float32)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(3).integers(0, 256, (2, 96, 160, 3), dtype=np.uint8)


def test_the_cpu_engine_records_its_spans_nested_as_listed(engine, frames):
    items = []
    timer = _recording(items)
    with activate(timer):
        res = engine.process_batch(frames)
    assert res.frames.shape == frames.shape
    names = [n for n, _, _ in items]
    # the CPU path: no pinned copies, no event to wait on
    assert "engine.stage_out" not in names and "engine.wait" not in names
    top = [s for s in items if s[0] != "nms.flag_read"]
    # closed in order, none inside another: the stage-in copy, the shared
    # letterbox, both detector programs, the mosaic, the gather
    assert [n for n, _, _ in sorted(top, key=lambda s: s[1])] == [
        "engine.stage_in", "engine.letterbox", "face.program", "plate.program",
        "engine.mosaic", "engine.gather"]
    for a, b in zip(sorted(top, key=lambda s: s[1]), sorted(top, key=lambda s: s[1])[1:]):
        assert a[2] <= b[1]
    face = next(s for s in items if s[0] == "face.program")
    plate = next(s for s in items if s[0] == "plate.program")
    reads = [s for s in items if s[0] == "nms.flag_read"]
    in_face = [r for r in reads if _inside(r, face)]
    in_plate = [r for r in reads if _inside(r, plate)]
    assert len(in_face) >= 2 and len(in_plate) >= 2  # at least one round and its check
    assert len(in_face) + len(in_plate) == len(reads) == timer.counts["nms.flag_read"]


def test_the_stream_stage_times_its_stages_and_the_engine_spans_on_a_child(engine, frames):
    from video_desensitization_torch.pipeline.streaming import (
        _SENTINEL,
        StreamStats,
        _run_device_stage,
    )

    items, hooked = [], []
    timer = _recording(items)
    timer.hook = hooked.append
    in_q, out_q = queue.Queue(), queue.Queue()
    for _ in range(3):
        in_q.put(frames)
    in_q.put(_SENTINEL)
    _run_device_stage(engine, in_q, out_q, StreamStats(), timer)
    assert out_q.qsize() == 3
    assert dict(timer.counts) == {"wait_decode": 4, "dispatch": 3, "device": 3,
                                  "wait_encode": 3}
    assert set(hooked) == set(timer.counts) and len(hooked) == 13  # top-level stages only
    (child,) = timer.children
    assert child.counts["engine.stage_in"] == child.counts["engine.gather"] == 3
    assert child.counts["face.program"] == child.counts["plate.program"] == 3
    dispatches = [s for s in items if s[0] == "dispatch"]
    devices = [s for s in items if s[0] == "device"]
    for name, t0, t1 in items:
        if name in ("engine.stage_in", "engine.letterbox", "face.program", "plate.program",
                    "engine.mosaic", "nms.flag_read"):
            assert any(_inside((name, t0, t1), d) for d in dispatches), name
        elif name == "engine.gather":
            assert any(_inside((name, t0, t1), d) for d in devices)
    assert set(timer.report()) == set(timer.counts) | set(child.counts)


BELOW = [0.0, 0.0, 0.0, 0.0, 0.1]  # under the confidence: never valid


def _chain(n, rows=8):
    """``n`` boxes 10 wide, each 3 to the right of the one before and scored
    lower, padded to ``rows`` with boxes that are never valid: each box
    overlaps its neighbours by IoU 7/13 and the box two along by at most
    4/16, so box i suppresses only box i+1."""
    return [[3.0 * i, 0.0, 3.0 * i + 10.0, 10.0, 0.9 - 0.01 * i] for i in range(n)] + [
        BELOW] * (rows - n)


def _reads(detections, top_k=8):
    timer = StageTimer()
    with activate(timer):
        _, keep = batched_nms_padded(torch.tensor(detections, dtype=torch.float32),
                                     0.5, 0.45, top_k)
    return timer.counts["nms.flag_read"], keep


@pytest.mark.parametrize("n, reads", [(1, 2), (2, 3), (3, 4), (4, 5), (6, 7)])
def test_nms_flag_reads_count_the_convergence_rounds(n, reads):
    """A chain of n boxes converges after n rounds (keep alternates from
    the end of the chain back); the loop reads the flag once a round and
    once more to see nothing changed."""
    count, keep = _reads([_chain(n)])
    assert count == reads
    assert keep[0].tolist() == [i % 2 == 0 for i in range(n)] + [False] * (8 - n)


def test_nms_flag_reads_follow_the_deepest_chain_of_the_batch():
    far = [[200.0 + 30 * i, 0.0, 210.0 + 30 * i, 10.0, 0.8] for i in range(4)]  # no overlaps
    count, keep = _reads([_chain(4), far + [BELOW] * 4])
    assert count == 5
    assert keep[1].tolist() == [True] * 4 + [False] * 4
    assert _reads([far + [BELOW] * 4])[0] == 2  # nothing suppressed: one round and its check
    assert _reads([[BELOW] * 8])[0] == 2  # nothing valid: the same
    # the loop makes at most top_k rounds: a chain of 3 in 3 rows stops
    # after its third round, unread
    assert _reads([_chain(3, rows=3)], top_k=3)[0] == 3
