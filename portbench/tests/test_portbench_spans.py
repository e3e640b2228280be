"""The readers of the engine's nested spans (``portbench/spans.py``) on
hand-made windows, and the timer of ``drivers/fused_stream.py``: the
program's nested spans land in the run's span list, while the hook that
opens and stops the profiler runs only as one of the stage's own spans
opens."""

import time

import numpy as np
import pytest
import torch

from portbench import common
from portbench.trace import DeviceTrace, Spans

NEW = ("nms_wait_ms.engine", "nms_syncs.engine", "stage_in_ms.engine", "dispatch_idle.engine")


def _read(metric, obs):
    return common.load_metric(metric).read(obs)


def _trace(t_start, t_end, ops=()):
    dt = DeviceTrace(False, "cpu")
    dt.t_start, dt.t_end = t_start, t_end
    dt.ops = [(f"k{i}", "kernel", a, b) for i, (a, b) in enumerate(ops)]
    return dt


def _obs(items, trace):
    """The obs of a window as ``drivers/fused_stream.py`` makes it: the
    totals and counts of the spans that start inside the window, beside
    the spans and the trace."""
    spans = Spans()
    totals, counts = {}, {}
    for name, t0, t1 in items:
        spans.add(name, t0, t1)
        if trace.t_start <= t0 < trace.t_end:
            totals[name] = totals.get(name, 0.0) + t1 - t0
            counts[name] = counts.get(name, 0) + 1
    return {"timer_totals": totals, "timer_counts": counts, "spans": spans, "trace": trace}


# Two batches in a 10 s window (seconds on the host's clock): each
# dispatch holds a stage-in copy, the face program and its NMS reads.
WINDOW = [
    ("wait_decode", 0.0, 1.0),
    ("dispatch", 1.0, 4.0),
    ("engine.stage_in", 1.0, 1.5),
    ("face.program", 1.5, 3.5),
    ("nms.flag_read", 2.0, 2.5),
    ("nms.flag_read", 3.0, 3.25),
    ("device", 4.0, 5.0),
    ("engine.wait", 4.0, 4.75),
    ("wait_encode", 5.0, 5.5),
    ("dispatch", 6.0, 8.0),
    ("engine.stage_in", 6.0, 6.25),
    ("face.program", 6.25, 7.75),
    ("nms.flag_read", 7.0, 7.5),
]
# The card busy 1.25-2.25 and 3.0-3.5 (two overlapping operations), 6.5-7.25.
OPS = [(1.25, 2.25), (3.0, 3.4), (3.2, 3.5), (6.5, 7.25)]


@pytest.mark.parametrize("metric", NEW)
def test_nothing_to_read_gives_none(metric):
    assert _read(metric, {}) is None
    # no dispatch span in the window
    assert _read(metric, _obs([("wait_decode", 0.0, 1.0), ("engine.stage_in", 0.2, 0.4)],
                              _trace(0.0, 10.0, OPS))) is None
    # a trace that never ran (the CPU's), with the spans of a window
    assert _read(metric, _obs(WINDOW, _trace(0.0, 0.0))) is None
    # a program that opens no span inside the stage's own four (before
    # the spans were added): nothing of these metrics to read
    top = [s for s in WINDOW if s[0] in ("wait_decode", "dispatch", "device", "wait_encode")]
    assert _read(metric, _obs(top, _trace(0.0, 10.0, OPS))) is None


@pytest.mark.parametrize("metric", ["nms_wait_ms.engine", "nms_syncs.engine",
                                    "stage_in_ms.engine"])
def test_dispatch_spans_without_the_metric_own_spans_read_zero(metric):
    own = {"nms_wait_ms.engine": "nms.flag_read", "nms_syncs.engine": "nms.flag_read",
           "stage_in_ms.engine": "engine.stage_in"}[metric]
    items = [s for s in WINDOW if s[0] != own]
    assert _read(metric, _obs(items, _trace(0.0, 10.0, OPS))) == 0.0


def test_the_span_readers_read_each_batch():
    obs = _obs(WINDOW, _trace(0.0, 10.0, OPS))
    assert _read("nms_wait_ms.engine", obs) == pytest.approx((0.5 + 0.25 + 0.5) / 2 * 1e3)
    assert _read("nms_syncs.engine", obs) == pytest.approx(1.5)
    assert _read("stage_in_ms.engine", obs) == pytest.approx((0.5 + 0.25) / 2 * 1e3)
    # the window opens at 5 s: one batch, its spans only
    obs = _obs(WINDOW, _trace(5.0, 10.0, OPS))
    assert _read("nms_syncs.engine", obs) == pytest.approx(1.0)
    assert _read("stage_in_ms.engine", obs) == pytest.approx(250.0)


def test_dispatch_idle_on_a_small_timeline():
    # In dispatch 1-4 and 6-8, outside the reads 2-2.5, 3-3.25 and 7-7.5,
    # the card idle: 1-1.25, 2.5-3, 3.5-4, 6-6.5, 7.5-8 (2.25-2.5 and
    # 7.25-7.5 are idle too, but inside a read).
    idle = 0.25 + 0.5 + 0.5 + 0.5 + 0.5
    obs = _obs(WINDOW, _trace(0.0, 10.0, OPS))
    assert _read("dispatch_idle.engine", obs) == pytest.approx(idle / 10.0 * 100.0)
    # the window cuts the first dispatch at 3.3: 1-1.25 and 2.5-3 remain
    obs = _obs(WINDOW, _trace(0.0, 3.3, OPS))
    assert _read("dispatch_idle.engine", obs) == pytest.approx(0.75 / 3.3 * 100.0)
    # the card busy all through: 0.0; no NMS reads: their time counts too
    busy = _obs(WINDOW, _trace(0.0, 10.0, [(0.0, 10.0)]))
    assert _read("dispatch_idle.engine", busy) == 0.0
    no_reads = _obs([s for s in WINDOW if s[0] != "nms.flag_read"], _trace(0.0, 10.0, OPS))
    assert _read("dispatch_idle.engine", no_reads) == pytest.approx(
        (idle + 0.25 + 0.25) / 10.0 * 100.0)


def test_a_child_of_the_stream_cell_timer_records_into_the_spans_without_the_hook():
    from video_desensitization_torch.utils.timers import activate, span

    spans, hooked = Spans(), []
    timer = common.load_driver("fused_stream")._timer(spans)
    timer.hook = lambda: hooked.append(time.perf_counter())
    child = timer.child()
    assert type(child) is type(timer)
    with timer.stage("dispatch"), activate(child):
        with span("engine.stage_in"):
            pass
        with span("face.program"), span("nms.flag_read"):
            pass
    with timer.stage("device"), activate(child), span("engine.wait"):
        pass
    assert len(hooked) == 2  # the two top-level stages, none of the four nested spans
    assert sorted(n for n, _, _ in spans.items) == sorted(
        ["dispatch", "engine.stage_in", "face.program", "nms.flag_read", "device", "engine.wait"])
    assert dict(timer.counts) == {"dispatch": 1, "device": 1}
    assert child.counts["nms.flag_read"] == 1


class _StopTimes:
    """A device trace that notes when the stage opens and stops it, and
    takes a while to stop, as the profiler does."""

    def __init__(self):
        self.calls = []

    def start(self):
        self.calls.append(("start", time.perf_counter()))

    def open(self):
        self.calls.append(("open", time.perf_counter()))

    def stop(self):
        self.calls.append(("stop", time.perf_counter()))
        time.sleep(0.05)


def test_no_dispatch_span_holds_the_profiler_stop():
    from video_desensitization_torch.bench_util import main_path_engine

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        engine = main_path_engine(device="cpu", backbone="mobilenet", input_hw=(64, 64),
                                  dtype=torch.float32)
        stream = common.load_driver("fused_stream")
        pool = [np.random.default_rng(j).integers(0, 256, (2, 48, 96, 3), dtype=np.uint8)
                for j in range(2)]
        spans, trace = Spans(), _StopTimes()
        stream._stage(engine, pool, 2, stream._timer(spans), seconds=1.5, trace=trace)
    finally:
        torch.set_num_threads(threads)
    stops = [t for what, t in trace.calls if what == "stop"]
    dispatches = [(t0, t1) for name, t0, t1 in spans.items if name == "dispatch"]
    assert stops and len(dispatches) >= 2
    assert any(name == "nms.flag_read" for name, _, _ in spans.items)
    for t in stops:
        assert not any(t0 <= t <= t1 for t0, t1 in dispatches)
