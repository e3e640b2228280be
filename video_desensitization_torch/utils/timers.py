"""Structured stage timing.

The reference sprinkles ``time.time()`` spans with print statements
(combine_detect.py:209-263, 612-644). Here timings are collected as
structured metrics that pipelines report and benchmarks consume; a
``torch.profiler`` trace can be layered on via ``profile_trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> Dict[str, float]:
        return dict(self.totals)

    def summary(self) -> str:
        return " | ".join(
            f"{k}: {v:.2f}s (x{self.counts[k]})" for k, v in self.totals.items()
        )


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
