"""The device trace of part of a run's window, and host spans to label its
gaps.

``DeviceTrace`` runs ``torch.profiler`` with CUDA activity only (no host
operator recording, which would slow the host-bound engine) and turns the
trace into device operations on the host's ``time.perf_counter`` clock: a
marker kernel launched right after a synchronise at a known host time
aligns the two clocks. The events are read from the profiler's chrome
trace, written under ``TMPDIR`` and deleted once read (the profiler's
in-memory events do not say which are kernels, copies or memsets).
``start``, ``open`` and ``stop`` are called from the thread that runs the
window's work (the profiler belongs to the thread that imported torch).
What ran before ``open`` (if called) or after ``stop`` is cut off when
read.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# A traced run traces this many seconds of its window: the profiler takes
# about 30 s to stop and 90 s to read a whole 51 s window of the engine (1.1
# million device operations), which a slow host would turn into more than
# the run may take.
TRACE_SECONDS = 15.0


class Spans:
    """Host spans (name, start, end) on the ``perf_counter`` clock, kept in
    memory; thread-safe appends."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.items.append((name, t0, t1))

    def totals(self) -> Dict[str, Tuple[float, int]]:
        out: Dict[str, list] = defaultdict(lambda: [0.0, 0])
        for name, t0, t1 in self.items:
            out[name][0] += t1 - t0
            out[name][1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}


class DeviceTrace:
    """With ``enabled`` False, ``start``, ``stop`` and ``read`` do nothing
    and ``ops`` stays empty."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.ops: List[Tuple[str, str, float, float]] = []  # name, category, start s, end s
        self.t_start = self.t_end = self.t_open = 0.0
        self.cost_s: Dict[str, float] = {}  # the trace's own seconds: stopping it, reading it
        self._prof = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t_start = time.perf_counter()
        torch.full((1,), 7, device=self.device)  # the clock marker: the trace's first device op

    def open(self) -> None:
        """Open the window now, on a trace already started: what ran
        before is left out."""
        if self._prof is not None and not self.t_open:
            self.t_open = time.perf_counter()

    def stop(self) -> None:
        """Close the window when the device has done what was launched
        before this call; what runs after is cut off when read. A second
        call does nothing."""
        if self._prof is None or self.t_end:
            return
        import torch

        torch.cuda.synchronize(self.device)
        self.t_end = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self.cost_s["stop"] = time.perf_counter() - self.t_end

    def read(self) -> None:
        """Device operations (name, category, start s, end s) inside the
        window, on the host's clock."""
        if self._prof is None or self.ops:
            return
        t0 = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        dev = sorted(((e["name"], e["cat"], e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6)
                      for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES),
                     key=lambda e: e[2])
        lo = self.t_open or float("-inf")
        if dev:
            offset = dev[0][2] - self.t_start  # the marker
            self.ops = [(name, cat, max(a - offset, lo), min(b - offset, self.t_end))
                        for name, cat, a, b in dev[1:] if b - offset > lo and a - offset < self.t_end]
        if self.t_open:
            self.t_start = self.t_open
        elif self.ops:  # the window opens with the program's first operation, not the harness's
            self.t_start = self.ops[0][2]
        self.cost_s["read"] = time.perf_counter() - t0

    # ---- what the run reports

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union)."""
        return sum(b - a for a, b in self._merged())

    def window_s(self) -> float:
        return self.t_end - self.t_start

    def _merged(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for _, _, a, b in sorted(self.ops, key=lambda o: o[2]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def top_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, _, a, b in self.ops:
            by_name[name] += b - a
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: Optional[Spans], n: int = 10) -> List[list]:
        """The ``n`` longest stretches with no device operation inside the
        window, each named by the host span it started in (``none``)."""
        merged = self._merged()
        edges = [self.t_start] + [x for ab in merged for x in ab] + [self.t_end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        items = sorted(spans.items, key=lambda s: s[1]) if spans else []
        out = []
        for a, b in gaps[:n]:
            label = "none"
            for name, t0, t1 in items:
                if t0 <= a < t1:
                    label = name  # the innermost span that holds the gap's start
            out.append([label, b - a])
        return out

    def device_seconds(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(b - a for name, cat, a, b in self.ops if cat == "kernel" and match(name))


def idle_percent(obs) -> Optional[float]:
    """Share of the traced window in which no operation ran on the card, in
    % (the reader of every ``device_idle.*`` metric)."""
    trace = obs.get("trace")
    if trace is None or not trace.ops or trace.window_s() <= 0:
        return None
    return (1.0 - trace.busy_s() / trace.window_s()) * 100.0
