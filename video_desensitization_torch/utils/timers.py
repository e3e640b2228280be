"""Structured stage timing.

The reference sprinkles ``time.time()`` spans with print statements
(combine_detect.py:209-263, 612-644). Here timings are collected as
structured metrics that pipelines report and benchmarks consume; a
``torch.profiler`` trace can be layered on via ``profile_trace``.

A pipeline stage times itself with ``StageTimer.stage``. Code deeper down
(the engine, the detectors, NMS) opens ``span(name)``, which records on
the timer that ``activate`` made current on the calling thread and does
nothing where none is (one thread-local lookup).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import ContextManager, Dict, Iterator, List, Tuple

_current = threading.local()


class StageTimer:
    """Seconds and calls by stage name. Subclasses construct without
    arguments: ``child()`` makes its timer with ``type(self)()``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.children: List[StageTimer] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def child(self) -> "StageTimer":
        """A new timer of this timer's class for spans nested inside its
        stages, kept in ``children``. It records as the class records, but
        what was set on this instance (a hook run when one of its stages
        opens) is not set on the child."""
        timer = type(self)()
        self.children.append(timer)
        return timer

    def _all(self) -> Tuple[Dict[str, float], Dict[str, int]]:
        totals, counts = defaultdict(float, self.totals), defaultdict(int, self.counts)
        for timer in self.children:
            t, n = timer._all()
            for k in t:
                totals[k] += t[k]
                counts[k] += n[k]
        return totals, counts

    def report(self) -> Dict[str, float]:
        """Seconds by name: this timer's stages and its children's spans."""
        return dict(self._all()[0])

    def summary(self) -> str:
        totals, counts = self._all()
        return " | ".join(f"{k}: {v:.2f}s (x{counts[k]})" for k, v in totals.items())


@contextlib.contextmanager
def activate(timer: StageTimer) -> Iterator[StageTimer]:
    """Make ``timer`` the one ``span`` records on, on the calling thread,
    until the block ends."""
    previous = getattr(_current, "timer", None)
    _current.timer = timer
    try:
        yield timer
    finally:
        _current.timer = previous


def span(name: str) -> ContextManager:
    """``stage(name)`` of the timer current on this thread, or a context
    that records nothing where none is."""
    timer = getattr(_current, "timer", None)
    return contextlib.nullcontext() if timer is None else timer.stage(name)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Wrap a region in a ``torch.profiler`` trace of the host and, where
    there is one, the CUDA device, written to ``<log_dir>/trace.json``
    (Chrome trace format: chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
