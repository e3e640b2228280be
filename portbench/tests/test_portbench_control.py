"""The control of each cell's comparison (the reference in the program's
place, its convolutions in 8-bit floats) fails at least one of the cell's
limits, at a tiny size on the CPU; ``python -m portbench.control`` reads it
on the card at the cells' own sizes."""

import pytest
import torch

from portbench import common, control
from portbench.tests.tiny import SEED, TINY

FP8 = torch.float8_e4m3fn


# The engine's control at 160 (frames 240 x 480): at the tiny runs' 64,
# boxes clipped to a 96 x 192 frame hide the 8-bit convolutions' errors.
ENGINE_SIZE = {"config": {"input_size": 160}, "traffic": {"height": 240, "width": 480,
                                                         "square_px_min": 16,
                                                         "square_px_max": 60}}


def _setup(cell, size=None):
    workload = common.load_workload(cell)
    cfg = dict(common.load_config(workload["config"]), **TINY[cell]["config"])
    tp = dict(workload["traffic"], **TINY[cell]["traffic"])
    if size:
        cfg.update(size["config"])
        tp.update(size["traffic"])
        cfg["calibration_traffic"] = dict(cfg["calibration_traffic"], height=tp["height"],
                                          width=tp["width"])
    return workload, cfg, tp


def _fails(numbers, limits):
    checks, correct = common.judged(numbers, limits)
    failing = [k for k, c in checks.items() if not c["value"] <= c["limit"]]
    assert not correct and failing, checks  # the run's own rule turns it down
    return failing


def test_the_engine_control_fails_a_limit():
    workload, cfg, tp = _setup("r50y8n-fused-stream-1080p", ENGINE_SIZE)
    numbers = control.engine_numbers(cfg, tp, SEED, torch.device("cpu"), FP8)
    assert _fails(numbers, workload["limits"]), numbers
    assert numbers["mosaic_px"] == 0  # the control mosaics its own boxes


@pytest.mark.parametrize("qdtype, fault", [(FP8, None), (None, "half_batch")])
def test_the_trainer_control_and_fault_fail_a_limit(qdtype, fault):
    workload, cfg, tp = _setup("r50-train-640-b32")
    numbers = control.train_numbers(cfg, tp, SEED, torch.device("cpu"), qdtype, fault)
    assert _fails(numbers, workload["limits"]), numbers
