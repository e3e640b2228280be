"""Finding the benchmark's pieces by name, and seeds.

Configurations, cells, drivers and per-layer metrics are files named
after the names ``BENCHMARK.json`` uses, so a later change adds a cell,
a configuration or a metric by adding files and an entry, never by
editing one.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Names the harness refuses to see loaded: the JAX package and what it
# runs on, and the JAX package's own benchmark scripts.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "video_desensitization_tpu", "bench", "benchmarks")


def benchmark_spec(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_config(name: str, here: Path = HERE) -> Dict[str, Any]:
    return json.loads((here / "configs" / f"{name}.json").read_text())


def load_workload(name: str, here: Path = HERE) -> Dict[str, Any]:
    return json.loads((here / "workloads" / f"{name}.json").read_text())


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name: str, here: Path = HERE) -> ModuleType:
    return _load_module(here / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def load_metric(name: str, here: Path = HERE) -> ModuleType:
    """The reader of per-layer metric ``name`` (``metrics/<name>.py``, whose
    ``read(obs)`` returns the value or None)."""
    return _load_module(here / "metrics" / f"{name}.py",
                        "portbench_metric_" + name.replace(".", "_").replace("-", "_"))


def subseed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's seed (weights of one network,
    frames, the sample of compared batches), the same on every machine."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def forbidden_loaded(modules) -> list:
    """Top-level names among ``modules`` (``sys.modules``' keys) that the
    benchmark must not load, compared whole: ``video_desensitization_torch``
    is not ``video_desensitization_tpu``, nor ``benchmarks_x`` ``benchmarks``."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN_MODULES))


def judged(numbers: Dict[str, float], limits: Dict[str, float],
           failed: int = 0) -> Tuple[Dict[str, Dict[str, float]], bool]:
    """The rule that decides ``correct``, for a run and for the control
    alike: the compared numbers beside their limits, and whether nothing
    failed and every number is finite and within its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in sorted(limits)}
    return checks, failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
