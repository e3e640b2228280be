"""Readings of the fused engine's nested spans over a traced run's window.

The port's stream stage times its four stages (``wait_decode``,
``dispatch``, ``device``, ``wait_encode``) on its ``StageTimer``, and the
engine, the detectors and NMS open spans inside them on a child of that
timer (``video_desensitization_torch/utils/timers.py::span``), which the
harness's subclass keeps beside the stages (``drivers/fused_stream.py``).
The readers of ``nms_wait_ms.engine``, ``nms_syncs.engine``,
``stage_in_ms.engine`` and ``dispatch_idle.engine`` share these rules: a
batch is a ``dispatch`` span; each returns None where there is no traced
window (no trace, or one that never ran, as on the CPU), where the window
holds no ``dispatch`` span, and where the program opens no span inside
the stage's own four (a program without them); where it opens some, but
none of the metric's own, the reading is 0.0.
"""

from __future__ import annotations

from typing import Optional, Tuple

STAGE_SPANS = frozenset({"wait_decode", "dispatch", "device", "wait_encode"})
DISPATCH, FLAG_READ = "dispatch", "nms.flag_read"


def _traced(obs) -> bool:
    trace = obs.get("trace")
    return trace is not None and trace.window_s() > 0


def per_batch(obs, name: str) -> Optional[Tuple[float, float]]:
    """(seconds, spans) of ``name`` a batch over the traced window, from
    the windowed totals and counts (``obs["timer_totals"]``,
    ``obs["timer_counts"]``)."""
    counts = obs.get("timer_counts", {})
    batches = counts.get(DISPATCH, 0)
    if not _traced(obs) or not batches or not set(counts) - STAGE_SPANS:
        return None
    return obs["timer_totals"].get(name, 0.0) / batches, counts.get(name, 0) / batches


def dispatch_idle_percent(obs) -> Optional[float]:
    """Share of the traced window (``trace.t_start``..``trace.t_end``), in
    %, in which no device operation runs while the stage's thread is inside
    a ``dispatch`` span and outside every ``nms.flag_read`` span: the card
    starved while the host issues work. One sweep over the window's span
    and operation edges, sorted by time."""
    if not _traced(obs) or obs.get("spans") is None:
        return None
    trace = obs["trace"]
    w0, w1 = trace.t_start, trace.t_end
    edges = []
    nested = False
    for name, t0, t1 in obs["spans"].items:
        if t1 <= w0 or t0 >= w1:
            continue
        if name == DISPATCH:
            kind = 0
        elif name == FLAG_READ:
            kind = 1
        else:
            nested = nested or name not in STAGE_SPANS
            continue
        edges += ((max(t0, w0), kind, 1), (min(t1, w1), kind, -1))
    if not nested or not any(kind == 0 for _, kind, _ in edges):
        return None
    for _, _, a, b in trace.ops:
        edges += ((a, 2, 1), (b, 2, -1))
    edges.sort(key=lambda e: e[0])
    depth = [0, 0, 0]  # open dispatch spans, flag reads, device operations
    idle, last = 0.0, w0
    for t, kind, step in edges:
        if depth[0] and not depth[1] and not depth[2]:
            idle += t - last
        depth[kind] += step
        last = t
    return idle / (w1 - w0) * 100.0
