"""The RT-DETR stream cell at a tiny size on the CPU through
``run.run_cell``, its control, its plates judged by query, and the
arithmetic of its metrics: the deformable attention's least bytes on a
case worked by hand, and RT-DETR-R50's FLOPs against the paper's."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import common, control_detr, run
from portbench.arith import detr_flops, msda_bytes
from portbench.reference import rtdetr
from portbench.tests.tiny import SECONDS, SEED, TINY

SPEC = common.benchmark_spec()
DETR = "r50rtdetr-fused-stream-1080p"
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
# RT-DETR at a tiny width (the backbone at its published depth); the
# port's detector is built with the same values (``tiny_port``)
DETR_ARCH = {"hidden_dim": 64, "num_queries": 20, "num_decoder_layers": 2}
TINY_CELLS = {
    DETR: {"config": dict(TINY["r50y8n-fused-stream-1080p"]["config"], **DETR_ARCH),
           "traffic": TINY["r50y8n-fused-stream-1080p"]["traffic"]},
}


@pytest.fixture
def tiny_port(monkeypatch):
    from video_desensitization_torch.detect import detr

    monkeypatch.setattr(detr, "PUBLISHED", {**detr.PUBLISHED, **DETR_ARCH})


@pytest.mark.parametrize("cell", [DETR])
def test_a_tiny_run_of_a_new_cell_is_correct_with_the_contract_keys(cell, tiny_port):
    result, checks = run.run_cell(SPEC, cell, SEED, SECONDS, False, "cpu", TINY_CELLS[cell])
    line = json.loads(json.dumps(result))
    assert set(line) == RESULT_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, checks
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(checks) == set(common.load_workload(cell)["limits"])


def test_a_traced_tiny_rtdetr_run_reads_the_host_metrics(tiny_port):
    result, _ = run.run_cell(SPEC, DETR, SEED, SECONDS, True, "cpu", TINY_CELLS[DETR])
    assert set(result) == RESULT_KEYS | {"breakdown"}
    # no device trace on the CPU: the device metrics give nothing
    assert "dispatch_ms.engine" in result["metrics"]
    assert set(result["metrics"]) <= {"dispatch_ms.engine", "batch_p95_ms.engine"}


def test_the_new_cells_state_their_engines():
    cfg = common.load_config("retinaface-r50_rtdetr-r50vd-640")
    assert (cfg["plate_arch"], cfg["engine"], cfg["num_queries"]) == ("rtdetr-r50vd", "fused", 300)
    assert cfg["plate_max_detections"] == cfg["num_top_queries"] == 64
    assert common.load_driver("fused_stream_detr").run
    assert DETR in {w["name"] for w in SPEC["workloads"]}


def test_msda_bytes_by_hand():
    """Head rows of 2 float32 channels (8 bytes; 4 rows a sector) on a 4 x 4
    map. A location at the centre of cells (0, 0)-(1, 1) reads the rows of
    tokens 0, 1, 4, 5: tokens 0 and 1 share sector 0, tokens 4 and 5
    sector 1. A location left of the map reads only its in-map corners;
    one wholly outside reads nothing."""
    shapes = [(4, 4)]

    def at(x, y):
        return torch.tensor([x, y], dtype=torch.float32).view(1, 1, 1, 1, 1, 2)

    assert msda_bytes.value_sectors(at(0.25, 0.25), shapes, 2, 4) == 2
    # x = -0.125 * 4 - 0.5 = -1: corners at columns -1 (outside) and 0
    assert msda_bytes.value_sectors(at(-0.125, 0.25), shapes, 2, 4) == 2
    assert msda_bytes.value_sectors(at(-0.9, 0.5), shapes, 2, 4) == 0
    # two heads of 16 bfloat16 channels: 32 bytes, one sector a head row
    two = torch.cat([at(0.25, 0.25)] * 2, dim=2)
    assert msda_bytes.value_sectors(two, shapes, 16, 2) == 8
    # and a call adds offsets, logits, boxes (float32) and its output once
    assert msda_bytes.call_bytes(at(0.25, 0.25), shapes, 2, 4) == (
        32 * 2 + 4 * (1 * 1 * 3 + 4) + 2 * 4)


def test_detr_flops_at_640_lie_within_a_tenth_of_the_papers_136_gflops():
    flops = detr_flops.forward_flops(rtdetr.RTDETR(nc=80).to("meta"), (1, 3, 640, 640))
    assert abs(flops / 136e9 - 1) < 0.1, flops


def test_plates_are_judged_by_the_query_their_token_selected():
    """A kept plate whose token the reference selected is judged against
    that query's box and logit; one whose token it did not select (a swap
    at the query boundary) only counts in the set gap, as do the plates
    either side keeps and the other does not."""
    from portbench.drivers import fused_stream_detr as fsd

    boxes = torch.tensor([[0, 0, 10, 10], [20, 20, 40, 30], [50, 50, 60, 70], [0, 0, 1, 1]],
                         dtype=torch.float64)
    ref = {"tokens": np.array([10, 20, 30, 40]), "boxes": boxes,
           "margin": np.array([3.0, 2.5, 1.0, -1.0]), "kth": 2.0,
           "kept_tokens": np.array([10, 20])}
    ours = np.array([[21, 20, 40, 30], [50, 50, 60, 70], [5, 5, 9, 9]], np.float64)
    gaps, shorts, unmatched, n, swaps = fsd.judge_plates(ours, np.array([20, 30, 99]), ref)
    np.testing.assert_allclose(gaps, [1 / 20, 0.0])  # widest gap over the longer side
    np.testing.assert_allclose(shorts, [0.0, 1.0])  # the query of token 30 lies 1 below kth
    # ours {20, 30, 99} against kept {10, 20}: 30, 99 and 10 are unmatched
    assert (unmatched, n, swaps) == (3, 5, 1)


def test_the_port_tokens_follow_the_detectors_rows(tiny_port):
    """Each recorded plate box finds its row of the detector's rerun,
    whatever the order of the recorded list, and takes that row's token."""
    from portbench.drivers import fused_stream_detr as fsd
    from video_desensitization_torch.detect.detr import RtDetrPlateDetector

    det = RtDetrPlateDetector(confidence=0.0, input_shape=(64, 64), max_detections=6,
                              dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(3)
    pool = [torch.randint(0, 256, (2, 48, 80, 3), dtype=torch.uint8, generator=gen).numpy()
            for _ in range(2)]
    boxes, want = [], []
    for batch in pool:
        rows, keep, tok = det._segment(torch.from_numpy(batch), tokens=True)
        kept = [rows[i][keep[i]][:, :4].tolist() for i in range(2)]
        boxes.append(([[], []], [kept[0], kept[1][::-1]]))
        want.append([tok[0][keep[0]].numpy(), tok[1][keep[1]].numpy()[::-1]])
    tokens, widest = fsd.port_tokens(det, pool, boxes * 2, "cpu")
    assert widest == 0.0 and len(tokens) == 4
    for j, frames in enumerate(tokens):
        for got, expect in zip(frames, want[j % 2]):
            np.testing.assert_array_equal(got, expect)
            assert len(got) == 6


# The controls at 160 (frames 240 x 480), as test_portbench_control.py
# reads the fused cell's: at 64 boxes clipped to the frame hide the
# 8-bit layers' errors.
ENGINE_SIZE = {"input_size": 160}
FRAMES = {"height": 240, "width": 480, "square_px_min": 16, "square_px_max": 60}


@pytest.mark.parametrize("cell", [DETR])
def test_the_control_of_a_new_cell_fails_a_limit(cell, tiny_port):
    workload = common.load_workload(cell)
    cfg = {**common.load_config(workload["config"]), **TINY_CELLS[cell]["config"], **ENGINE_SIZE}
    tp = {**workload["traffic"], **TINY_CELLS[cell]["traffic"], **FRAMES}
    cfg["calibration_traffic"] = dict(cfg["calibration_traffic"], height=240, width=480)
    numbers = control_detr.NUMBERS[workload["driver"]](cfg, tp, SEED, torch.device("cpu"),
                                                       torch.float8_e4m3fn)
    checks, correct = common.judged(numbers, workload["limits"])
    assert not correct, checks
    assert numbers["mosaic_px"] == 0  # the control mosaics its own boxes


def test_the_new_modules_load_no_jax():
    code = ("import sys\nimport portbench.control_detr, portbench.seeding\n"
            "from portbench import common\n"
            "from portbench.arith import detr_flops, msda_bytes\n"
            "from portbench.reference import rtdetr\n"
            "common.load_driver('fused_stream_detr')\n"
            "for m in ('msda_roofline', 'engine_mfu.detr', 'msda_calls.detr'):\n"
            "    common.load_metric(m)\n"
            "import video_desensitization_torch.detect.detr\n"
            "print(common.forbidden_loaded(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
