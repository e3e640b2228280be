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
