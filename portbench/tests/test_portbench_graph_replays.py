"""The reader of ``graph_replays.engine`` on hand-made windows: the CUDA
graph replays of both detectors a ``dispatch`` span, by the rules of
``portbench/spans.py``."""

import pytest

from portbench import common
from portbench.trace import DeviceTrace, Spans

# One batch a dispatch, 2 s apart; each runs both detector programs.
WINDOW = [
    span for i in range(3) for span in (
        ("dispatch", 2.0 * i, 2.0 * i + 1.5),
        ("engine.stage_in", 2.0 * i, 2.0 * i + 0.25),
        ("face.program", 2.0 * i + 0.25, 2.0 * i + 0.75),
        ("nms.flag_read", 2.0 * i + 0.5, 2.0 * i + 0.6),
        ("plate.program", 2.0 * i + 0.75, 2.0 * i + 1.25),
        ("device", 2.0 * i + 1.5, 2.0 * i + 1.75),
    )
]


def _read(items, t_start=0.0, t_end=6.0):
    trace = DeviceTrace(False, "cpu")
    trace.t_start, trace.t_end = t_start, t_end
    spans, totals, counts = Spans(), {}, {}
    for name, t0, t1 in items:
        spans.add(name, t0, t1)
        if t_start <= t0 < t_end:
            totals[name] = totals.get(name, 0.0) + t1 - t0
            counts[name] = counts.get(name, 0) + 1
    obs = {"timer_totals": totals, "timer_counts": counts, "spans": spans, "trace": trace}
    return common.load_metric("graph_replays.engine").read(obs)


def _graphs(items, every=1):
    """``items`` with one ``face.graph`` and one ``plate.graph`` span inside
    the programs of every ``every``-th batch."""
    out = list(items)
    for j, (name, t0, t1) in enumerate(items):
        if name in ("face.program", "plate.program") and (j // 6) % every == 0:
            out.append((name.split(".")[0] + ".graph", t0 + 0.01, t0 + 0.02))
    return out


def test_without_a_traced_window_or_nested_spans_it_reads_none():
    assert common.load_metric("graph_replays.engine").read({}) is None
    assert _read(_graphs(WINDOW), 0.0, 0.0) is None  # a trace that never ran
    top = [s for s in WINDOW if s[0] in ("dispatch", "device")]
    assert _read(top) is None  # a program without nested spans


def test_nested_spans_but_no_graph_spans_read_zero():
    assert _read(WINDOW) == 0.0


@pytest.mark.parametrize("every, window, want", [
    (1, (0.0, 6.0), 2.0), (1, (2.0, 4.0), 2.0), (3, (0.0, 6.0), 2.0 / 3)])
def test_one_face_and_one_plate_replay_a_dispatch_read_two(every, window, want):
    assert _read(_graphs(WINDOW, every), *window) == pytest.approx(want)
