"""A whole run of each cell at a tiny size on the CPU, past the harness's
look for a card; the command itself refuses to run without one."""

import json
import subprocess
import sys

import pytest

from portbench import common, run
from portbench.tests.tiny import SECONDS, SEED, TINY

SPEC = common.benchmark_spec()
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_tiny_run_is_correct_with_the_contract_keys(cell):
    result, checks = run.run_cell(SPEC, cell, SEED, SECONDS, False, "cpu", TINY[cell])
    line = json.loads(json.dumps(result))
    assert set(line) == RESULT_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, checks
    assert set(line["metrics"]) == set(run.cell_metrics(SPEC, cell, "end_to_end"))
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(checks) == set(common.load_workload(cell)["limits"])


def test_a_traced_tiny_run_reports_per_layer_metrics():
    cell = "r50y8n-fused-stream-1080p"
    result, _ = run.run_cell(SPEC, cell, SEED, SECONDS, True, "cpu", TINY[cell])
    assert set(result) == RESULT_KEYS | {"breakdown"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    # no device trace on the CPU: only the host's metrics are read (the
    # tail once twenty batches came back)
    assert "dispatch_ms.engine" in result["metrics"]
    assert set(result["metrics"]) <= {"dispatch_ms.engine", "batch_p95_ms.engine"}


def test_the_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "r50-train-640-b32", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=common.ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in TINY:
        out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                              "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                             cwd=common.ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
