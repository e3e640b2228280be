"""Run one cell of the port's benchmark once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell's ``BENCHMARK.json`` entry names its configuration
(``configs/<config>.json``); ``workloads/<cell>.json`` names its driver
(``drivers/<driver>.py``), its traffic and the limits of its comparison.
The driver builds the port, warms up, measures for ``--seconds`` and
hands back what the window produced; the plain reference judges it once
the window has closed. The last line of standard output is the result as
one JSON object; the compared numbers, each beside its limit, are also
the last lines of standard error. ``--trace 1`` runs the same window
under the device profiler and reports the cell's per-layer metrics
(``metrics/<metric>.py``) in place of its end-to-end ones.

Without CUDA, with fewer cards than the cell asks for, or with JAX or the
JAX package loaded once the window has closed, the run prints no result
and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, Optional, Tuple  # noqa: E402

CACHE_DIR = Path(__file__).resolve().parent / "_cache"
# Every compiler cache at a fixed path inside the checkout, so that only
# a cell's first run there compiles. The port builds its mosaic kernel
# into its own ``_build/`` inside the checkout.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(CACHE_DIR / _sub)

from portbench import common  # noqa: E402
from portbench.trace import DeviceTrace, Spans  # noqa: E402


class Ctx:
    """What a driver gets: the cell, its configuration, the run's
    arguments, the device, host spans and the device trace of the window."""

    def __init__(self, name: str, entry: Dict, workload: Dict, config: Dict, seed: int,
                 seconds: float, trace: bool, device, t_process: float):
        import torch

        self.name, self.entry, self.workload, self.config = name, entry, workload, config
        self.traffic = workload["traffic"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.t_process = t_process
        self.spans = Spans()
        self.device_trace = DeviceTrace(self.trace and self.device.type == "cuda", self.device)

    def note(self, text: str) -> None:
        """A line of the run's record, before the result's line."""
        print(f"portbench {self.name}: {text}", flush=True)

    def memory_peak_bytes(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0


def cell_metrics(spec: Dict, name: str, kind: str) -> Dict[str, Dict]:
    """The cell's ``end_to_end`` or ``per_layer`` entries of ``BENCHMARK.json``:
    those that list it under ``workloads``, and those without the key
    (per-layer ones: where the cell reports the metric they move)."""
    e2e_names = set(cell_metrics(spec, name, "end_to_end")) if kind == "per_layer" else set()
    out = {}
    for m in spec[kind]:
        if "workloads" in m:
            if name in m["workloads"]:
                out[m["name"]] = m
        elif kind == "end_to_end" or m["moves"] in e2e_names:
            out[m["name"]] = m
    return out


def run_cell(spec: Dict, name: str, seed: int, seconds: float, trace: bool, device,
             overrides: Optional[Dict] = None,
             t_process: float = T_PROCESS) -> Tuple[Dict[str, Any], Dict[str, Dict]]:
    """Run cell ``name`` once -> (result object, compared numbers with
    their limits). ``overrides`` ({"config": {...}, "traffic": {...},
    "limits": {...}}) updates the files' values: the CPU tests run the
    cell at a tiny size this way."""
    import torch

    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    workload = common.load_workload(name)
    if workload["config"] != entry["config"]:
        raise SystemExit(f"{name}: BENCHMARK.json says config {entry['config']!r}, "
                         f"workloads/{name}.json {workload['config']!r}")
    config = common.load_config(entry["config"])
    for key in ("config", "traffic", "limits"):
        if overrides and key in overrides:
            target = config if key == "config" else workload[key]
            target.update(overrides[key])
    ctx = Ctx(name, entry, workload, config, seed, seconds, trace, device, t_process)
    driver = common.load_driver(workload["driver"])
    out = driver.run(ctx)

    limits = workload["limits"]
    numbers = out["numbers"]
    if set(numbers) != set(limits):
        raise SystemExit(f"{name}: compared {sorted(numbers)}, limits for {sorted(limits)}")
    checks, correct = common.judged(numbers, limits, out["failed"])

    dev: Dict[str, Any] = {
        "platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
        "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
        "count": entry["chips"],
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    result: Dict[str, Any] = {"correct": bool(correct), "attempted": out["attempted"],
                              "failed": out["failed"]}
    if not trace:
        metrics = {}
        for m_name, m in cell_metrics(spec, name, "end_to_end").items():
            if m_name not in out["e2e"]:
                raise SystemExit(f"{name}: the driver gave no {m_name}")
            metrics[m_name] = {"value": out["e2e"][m_name], "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = dev
    else:
        dt = ctx.device_trace
        dt.read()
        ctx.note(f"device trace: {len(dt.ops)} device operations; seconds to stop and read it "
                 f"{dt.cost_s}")
        obs = dict(out["obs"], trace=dt, spans=ctx.spans)
        metrics = {}
        for m_name, m in cell_metrics(spec, name, "per_layer").items():
            value = common.load_metric(m_name).read(obs)
            if value is not None:
                metrics[m_name] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        dev["busy_s"] = dt.busy_s()
        dev["window_s"] = dt.window_s()
        result["device"] = dev
        result["breakdown"] = {"device_ops": dt.top_ops(), "idle_gaps": dt.idle_gaps(ctx.spans)}
    result["checks"] = checks
    return result, checks


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    spec = common.benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: cell {args.workload} needs {entry['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0))
    loaded = common.forbidden_loaded(sys.modules)
    if loaded:
        print(f"portbench: the run loaded {loaded}; no result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, c in checks.items():
        print(f"portbench check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
