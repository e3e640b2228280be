"""What the scripts that drive the main path on a card share: the main-path
engine with random weights, CUDA-event and profiler timing, and the
frames/s loop. Used by ``chip_smoke.py`` and ``profile_engine``."""

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


def host_ms_per_call(fn, reps: int = 50) -> float:
    """Host ms per call over ``reps`` back-to-back calls of ``fn`` after one
    warm-up call: the host clock of their enqueueing, which does not wait
    for the device unless ``fn`` does."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s * 1e3 / reps


def device_time_us(evt) -> float:
    """Self device time of one ``torch.profiler`` key-average entry."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profiled_device_ms(fn, reps: int = 50) -> tuple[float | None, float]:
    """(device ms, CUDA kernels) per call of ``fn`` from ``torch.profiler``
    over ``reps`` calls (after one warm-up call). The device ms sum the
    device time of every kernel and copy the profiler saw, so gaps between
    them do not count and the host's time cannot leak in; None when the
    profiler reports no device time. The kernels count the launches of the
    device-side entries other than copies and fills."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in prof.key_averages() if getattr(e, "device_type", None) == cuda]
    total_us = sum(device_time_us(e) for e in device)
    kernels = sum(e.count for e in device if not e.key.startswith(("Memcpy", "Memset")))
    return (total_us / 1e3 / reps if total_us else None), kernels / reps


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
