"""What the scripts that drive the main path on a card share: the main-path
engine with random weights, CUDA-event timing, and the frames/s loop.
Used by ``chip_smoke.py`` and ``profile_engine``."""

from __future__ import annotations

import statistics
import time

import torch


def main_path_engine(device="cuda", backbone="resnet50", input_hw=(640, 640),
                     dtype=torch.bfloat16, seed: int = 0):
    """The engine of the main path; the defaults are the CLI's full-width
    configuration (max 16 faces, 8 plates, mosaic level 8), with random
    weights from ``seed``."""
    from video_desensitization_torch.detect.face import Retinaface
    from video_desensitization_torch.detect.plate import PlateDetector
    from video_desensitization_torch.pipeline.engine import DesensitizationEngine

    face = Retinaface(backbone=backbone, input_shape=[*input_hw, 3], max_detections=16,
                      dtype=dtype, device=device, seed=seed)
    plate = PlateDetector(variant="n", input_shape=input_hw, max_detections=8,
                          dtype=dtype, device=device, seed=seed)
    return DesensitizationEngine(face, plate, mosaic_level=8)


def cuda_time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn``."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def engine_fps(engine, batches, warmup: int = 2, keep: bool = True):
    """Frames/s of ``engine.process_batch`` over ``batches`` by the host
    clock, after ``warmup`` untimed batches (cuDNN plans, tables, the
    kernel library). Returns (frames/s, results): every result when
    ``keep``, as a caller collecting a job's output holds them, else none
    (each result is dropped at the next batch)."""
    for frames in batches[:warmup]:
        engine.process_batch(frames)
    torch.cuda.synchronize()
    results = []
    t0 = time.perf_counter()
    for frames in batches:
        res = engine.process_batch(frames)
        if keep:
            results.append(res)
    elapsed = time.perf_counter() - t0
    return sum(len(f) for f in batches) / elapsed, results
