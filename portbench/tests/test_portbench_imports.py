"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the port."""

import ast
import subprocess
import sys

from portbench import common

IMPORT_ALL = """
import sys
import portbench.run, portbench.control, portbench.traffic, portbench.weights
from portbench import common
from portbench.arith import flops, mosaic_bytes, peaks
from portbench.reference import detect, nets, train
for d in ("fused_stream", "train_step"):
    common.load_driver(d)
for m in [m["name"] for m in common.benchmark_spec()["per_layer"]]:
    common.load_metric(m)
import video_desensitization_torch.cli.main, video_desensitization_torch.cli.train
import video_desensitization_torch.pipeline.streaming, video_desensitization_torch.train.step
import video_desensitization_torch.train.data
print(common.forbidden_loaded(sys.modules))
"""


def test_forbidden_names_are_compared_whole():
    assert common.forbidden_loaded(["video_desensitization_torch.ops", "jaxtyping",
                                    "benchmarks_x", "flaxen.y", "bench_util"]) == []
    assert common.forbidden_loaded(["jax.numpy", "video_desensitization_tpu.ops", "flax",
                                    "jaxlib._x", "bench", "benchmarks.tracking"]) == [
        "bench", "benchmarks", "flax", "jax", "jaxlib", "video_desensitization_tpu"]


def test_nothing_the_benchmark_runs_loads_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=common.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_and_arith_import_nothing_of_the_port():
    for folder in ("reference", "arith"):
        for path in (common.HERE / folder).glob("*.py"):
            tree = ast.parse(path.read_text())
            names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
            names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
            top = {n.split(".")[0] for n in names}
            assert not top & {"video_desensitization_torch", "video_desensitization_tpu", "jax",
                              "flax", "jaxlib"}, (path, top)
