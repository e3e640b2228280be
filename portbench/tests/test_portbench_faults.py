"""Each fault a cell can have, planted under a whole tiny run on the CPU,
turns ``correct`` false. (One card each: no exchange between cards.)"""

import numpy as np
import pytest
import torch

from portbench import common, run
from portbench.tests.tiny import SECONDS, SEED, TINY

SPEC = common.benchmark_spec()
ENGINE, TRAIN = "r50y8n-fused-stream-1080p", "r50-train-640-b32"


def _run(cell):
    result, checks = run.run_cell(SPEC, cell, SEED, SECONDS, False, "cpu", TINY[cell])
    return result["correct"], checks


def test_engine_half_the_batch_left_out(monkeypatch):
    from video_desensitization_torch.pipeline import engine as eng

    real = eng.DesensitizationEngine.dispatch_batch

    def half(self, frames, image_shapes=None):
        out, pending = real(self, frames[: len(frames) // 2])
        rest = [np.concatenate([t.numpy(), np.zeros_like(t.numpy())[: len(frames) - len(t)]])
                if i else np.concatenate([t.numpy(), frames[len(frames) // 2:]])
                for i, t in enumerate(out)]
        return [torch.from_numpy(r) for r in rest], pending

    monkeypatch.setattr(eng.DesensitizationEngine, "dispatch_batch", half)
    correct, checks = _run(ENGINE)
    assert not correct, checks


def test_engine_a_pixel_altered_where_it_is_produced(monkeypatch):
    from video_desensitization_torch.pipeline import engine as eng

    real = eng.mosaic_boxes_batch_cuda_

    def altered(frames, boxes, valid, level):
        out = real(frames, boxes, valid, level)
        out[0, 0, 0, 0] ^= 1
        return out

    monkeypatch.setattr(eng, "mosaic_boxes_batch_cuda_", altered)
    correct, checks = _run(ENGINE)
    assert not correct and checks["mosaic_px"]["value"] > 0, checks


def test_engine_a_box_altered_where_it_is_produced(monkeypatch):
    from video_desensitization_torch.detect import face

    real = face.Retinaface._detect_program

    def shifted(self, frames, shapes):
        dets, px, keep = real(self, frames, shapes)
        px = px.clone()
        px[..., :4] += 0.25 * (px[..., 2:3] - px[..., 0:1])
        return dets, px, keep

    monkeypatch.setattr(face.Retinaface, "_detect_program", shifted)
    correct, checks = _run(ENGINE)
    assert not correct, checks


def test_train_a_step_that_returns_its_state_unchanged(monkeypatch):
    from video_desensitization_torch.train import step

    real = step.make_train_step

    def unchanged(dtype=torch.float32, mesh=None):
        inner = real(dtype, mesh)

        def train_step(state, batch):
            saved = [p.detach().clone() for p in state.model.parameters()]
            state, metrics = inner(state, batch)
            with torch.no_grad():
                for p, q in zip(state.model.parameters(), saved):
                    p.copy_(q)
            state.optimizer.state.clear()
            return state, metrics

        return train_step

    monkeypatch.setattr(step, "make_train_step", unchanged)
    correct, checks = _run(TRAIN)
    assert not correct, checks


def test_train_half_the_batch_left_out(monkeypatch):
    from video_desensitization_torch.train import step

    real = step.make_train_step

    def half(dtype=torch.float32, mesh=None):
        inner = real(dtype, mesh)
        return lambda state, batch: inner(
            state, {k: v[: len(v) // 2] for k, v in batch.items()})

    monkeypatch.setattr(step, "make_train_step", half)
    correct, checks = _run(TRAIN)
    assert not correct, checks


@pytest.mark.parametrize("cell", [ENGINE, TRAIN])
def test_the_sound_tiny_run_stays_correct(cell):
    assert _run(cell)[0]
