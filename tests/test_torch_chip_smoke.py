"""The memory bound that ``chip_smoke.py`` reports for the mosaic kernel,
counted on the CPU against boxes whose traffic is known by hand."""

import importlib.util
from pathlib import Path

import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py"
)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _bound_bytes(boxes, valid, level, shape=(1, 64, 128, 3)):
    frames = torch.zeros(shape, dtype=torch.uint8)
    ms = chip_smoke.mosaic_bound_ms(
        frames, torch.tensor(boxes, dtype=torch.int32), torch.tensor(valid), level
    )
    return round(ms * 1e-3 * chip_smoke.HBM_BYTES_PER_S)


def test_one_box_reads_one_row_in_level():
    """A 64x64 box at level 8 maps offset t to 8 * (t // 8). Its 64 rows of
    192 bytes are written (6 sectors each; the pixels that are their own
    source share those sectors); 8 source rows are read, and their sources
    (every 8th pixel, 24 bytes apart) touch 6 sectors each."""
    assert _bound_bytes([[[0, 0, 64, 64]]], [[True]], 8) == 32 * (64 * 6 + 8 * 6)


@pytest.mark.parametrize(
    "boxes, valid",
    [
        ([[[0, 0, 64, 64], [0, 0, 64, 64]]], [[True, True]]),  # repeat: idempotent
        ([[[0, 0, 64, 64], [-9, -9, 300, 300]]], [[True, False]]),  # invalid
        ([[[0, 0, 64, 64], [128, 0, 200, 64]]], [[True, True]]),  # outside
    ],
    ids=["repeat", "invalid", "outside"],
)
def test_boxes_that_move_nothing_add_nothing(boxes, valid):
    assert _bound_bytes(boxes, valid, 8) == _bound_bytes([[[0, 0, 64, 64]]], [[True]], 8)


def test_level_one_is_the_identity():
    assert _bound_bytes([[[3, 5, 60, 40]]], [[True]], 1) == 0


class _Event:
    """One key-average row of a device kernel, as torch.profiler gives it."""

    def __init__(self, count, us):
        self.key, self.count, self.self_device_time_total = "kernel", count, us
        self.device_type = torch.autograd.DeviceType.CUDA


GOOD = [_Event(100, 1650.0)]


@pytest.mark.parametrize(
    "sessions, want",
    [
        ([[], GOOD, GOOD], (0.033, 2.0)),  # a session with no device event
        ([[_Event(100, 660.0)], GOOD, GOOD], (0.033, 2.0)),  # lost time
        ([[_Event(66, 900.0)], GOOD, GOOD], (0.033, 2.0)),  # lost kernels
        ([GOOD, [_Event(100, 1600.0)]], (0.032, 2.0)),  # two agree within 20%
        ([[]] * 6, (None, 0.0)),  # never two that agree
    ],
    ids=["empty", "lost-time", "lost-kernels", "agree", "never"],
)
def test_profiled_device_ms_takes_two_agreeing_sessions(monkeypatch, sessions, want):
    """The device time ``chip_smoke.py`` reports comes from two profiler
    sessions that saw whole kernels per call and agree; sessions that lost
    events are run again."""
    import torch.profiler

    from video_desensitization_torch import bench_util

    queue = list(sessions)

    class FakeProfile:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return queue.pop(0)

    monkeypatch.setattr(torch.profiler, "profile", lambda **kwargs: FakeProfile())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    ms, kernels = bench_util.profiled_device_ms(lambda: None, reps=50)
    assert (ms if ms is None else round(ms, 6), kernels) == want
