"""Readings of the host around a window, printed beside a run's numbers:
what else ran on the machine's CPUs (``/proc/stat``: busy and stolen
shares of all CPUs), the run's own CPU time, context switches and page
faults (``getrusage``), the load average, the CPUs the run may use, and
the speed of a host copy the size of a batch. They say whether a slow run
was slow for want of the host; they read nothing outside ``/proc``."""

from __future__ import annotations

import os
import resource
import time
from typing import Dict

import numpy as np


def _cpu_jiffies() -> Dict[str, int]:
    try:
        with open("/proc/stat") as f:
            fields = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return {}
    fields += [0] * (8 - len(fields))
    user, nice, system, idle, iowait, irq, softirq, steal = fields[:8]
    return {"busy": user + nice + system + irq + softirq, "idle": idle + iowait, "steal": steal}


def snapshot() -> Dict[str, float]:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "cpu_s": ru.ru_utime + ru.ru_stime, "sys_s": ru.ru_stime,
            "invol_cs": ru.ru_nivcsw, "vol_cs": ru.ru_nvcsw, "minflt": ru.ru_minflt,
            "majflt": ru.ru_majflt, **{f"jiffies_{k}": v for k, v in _cpu_jiffies().items()}}


def delta(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """What changed from snapshot ``a`` to ``b``, with the machine's CPU
    shares in % of all its CPUs' time."""
    out = {k: b[k] - a[k] for k in ("t", "cpu_s", "sys_s", "invol_cs", "vol_cs", "minflt", "majflt")}
    total = sum(b.get(f"jiffies_{k}", 0) - a.get(f"jiffies_{k}", 0) for k in ("busy", "idle", "steal"))
    if total > 0:
        out["all_cpus_busy_pct"] = 100.0 * (b["jiffies_busy"] - a["jiffies_busy"]) / total
        out["all_cpus_steal_pct"] = 100.0 * (b["jiffies_steal"] - a["jiffies_steal"]) / total
    out["load_avg_1m"] = os.getloadavg()[0]
    out["cpus_allowed"] = len(os.sched_getaffinity(0))
    out["cpus"] = os.cpu_count()
    return out


def copy_gbps(dst: np.ndarray, src: np.ndarray, repeats: int = 5) -> float:
    """Median GB/s of ``np.copyto(dst, src)``: the host's memory speed."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        times.append(time.perf_counter() - t0)
    return src.nbytes / float(np.median(times)) / 1e9
