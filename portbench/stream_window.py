"""The timed window of a stream cell and what its traced part gives the
per-layer metrics, for the stream drivers that came after
``drivers/fused_stream.py`` (whose own copy is the fused YOLOv8n cell's):
``drivers/fused_stream_detr.py``.
"""

from __future__ import annotations

from collections import defaultdict
from types import SimpleNamespace
from typing import Dict

import numpy as np

from portbench import host
from portbench.common import subseed
from portbench.drivers import fused_stream as fs


def measure(ctx, rec, pool) -> SimpleNamespace:
    """Run ``rec`` (what ``_run_device_stage`` takes) through the stage for
    the run's seconds, holding the seed's sample of batches, under the
    device trace in a traced run. Returns the window: its times (``t_start``,
    ``put_t``, ``take_t``), ``held`` frames (every held batch, or the run
    fails), the stage ``timer``,
    ``host_window``, ``setup_s``, ``memory_peak``, ``frames_per_s``,
    ``batches_window``, ``n_total`` batches through the stage, and ``obs``
    for the per-layer metrics over the traced seconds (the window's
    without a trace)."""
    tp = ctx.traffic
    rng = np.random.default_rng(subseed(ctx.seed, "held"))
    hold = {int(j): np.ones_like(pool[0]) for j in
            rng.choice(tp["held_min_batches"], tp["held_batches"], replace=False)}
    timer = fs._timer(ctx.spans)
    host0 = host.snapshot()
    t_start, put_t, take_t, held = fs._stage(rec, pool, tp["queue_depth"], timer,
                                             seconds=ctx.seconds, hold=hold,
                                             trace=ctx.device_trace if ctx.trace else None)
    if len(held) < tp["held_batches"]:
        raise RuntimeError(f"the window reached {len(held)} of the {tp['held_batches']} held "
                           f"batches drawn from its first {tp['held_min_batches']}")
    w = SimpleNamespace(t_start=t_start, put_t=put_t, take_t=take_t, held=held, timer=timer,
                        host_window=host.delta(host0, host.snapshot()),
                        setup_s=t_start - ctx.t_process, memory_peak=ctx.memory_peak_bytes(),
                        n_total=len(take_t))
    t_end = t_start + ctx.seconds
    w.batches_window = sum(1 for t in take_t if t <= t_end)
    w.frames_per_s = tp["batch"] * w.batches_window / ctx.seconds

    dt = ctx.device_trace
    t_a, t_b = (dt.t_open, dt.t_end) if dt.t_end > dt.t_open > 0 else (t_start, t_end)
    w.traced = [j for j, t in enumerate(take_t) if t_a <= t <= t_b]
    totals: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for name, s0, s1 in ctx.spans.items:
        if t_a <= s0 < t_b:
            totals[name] += s1 - s0
            counts[name] += 1
    w.obs = {"batches": len(w.traced), "frames_window": tp["batch"] * len(w.traced),
             "window_s": t_b - t_a, "latencies_s": [take_t[j] - put_t[j] for j in w.traced],
             "timer_totals": dict(totals), "timer_counts": dict(counts)}
    return w


def host_note(w) -> str:
    """The window's host readings for the run's record."""
    return (f"median ms between two batches taken {float(np.median(np.diff(w.take_t))) * 1e3:.3f}"
            f" | host over the window {w.host_window} | process CPU ms a batch in the window "
            f"{w.host_window['cpu_s'] / max(w.batches_window, 1) * 1e3:.3f}")
