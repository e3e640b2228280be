"""What the scripts that drive the main path on a card share: the main-path
engine with random weights, CUDA-event and profiler timing, and the
frames/s loop on RGB or I420 batches. Used by ``chip_smoke.py`` and
``profile_engine``."""

from __future__ import annotations

import statistics
import sys
import time

import torch

PROFILER_SESSIONS = 6
PROFILER_AGREE = 0.2


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
    them do not count and the host's time cannot leak in. The kernels count
    the launches of the device-side entries other than copies and fills.

    The profiler's device tracing on the H100 has lost the events of a
    session, all of them or some (a session saw no device time; the next
    one then reported a third of the time). So a session counts only when
    it saw a whole number of kernels per call, at least one, and agrees
    with the session before it: the same kernels, and device time within
    ``PROFILER_AGREE``. Up to ``PROFILER_SESSIONS`` sessions are run;
    (None, 0.0) comes back when no two agree."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    previous = None
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if getattr(e, "device_type", None) == cuda]
        total_us = sum(device_time_us(e) for e in device)
        kernels = sum(e.count for e in device if not e.key.startswith(("Memcpy", "Memset")))
        session = (kernels, total_us) if kernels > 0 and kernels % reps == 0 and total_us > 0 else None
        if session is None:
            print(f"profiled_device_ms: a session saw {kernels} kernels in {reps} calls, "
                  f"{total_us:.1f} us of device time", file=sys.stderr)
        elif previous is not None:
            if kernels == previous[0] and (
                abs(total_us - previous[1]) <= PROFILER_AGREE * max(total_us, previous[1])
            ):
                return total_us / 1e3 / reps, kernels / reps
            print(f"profiled_device_ms: sessions disagree: {previous} then {session} "
                  "(kernels, device us)", file=sys.stderr)
        previous = session
    return None, 0.0


def engine_fps(engine, batches, warmup: int = 2, keep: bool = True, yuv: bool = False):
    """Frames/s of ``engine.process_batch`` (``process_batch_yuv`` on
    (B, H*3/2, W) I420 batches when ``yuv``) over ``batches`` by the host
    clock, after ``warmup`` untimed batches (cuDNN plans, tables, the
    kernel library). Returns (frames/s, results): every result when
    ``keep``, as a caller collecting a job's output holds them, else none
    (each result is dropped at the next batch)."""
    process = engine.process_batch_yuv if yuv else engine.process_batch
    for frames in batches[:warmup]:
        process(frames)
    torch.cuda.synchronize()
    results = []
    t0 = time.perf_counter()
    for frames in batches:
        res = process(frames)
        if keep:
            results.append(res)
    elapsed = time.perf_counter() - t0
    return sum(len(f) for f in batches) / elapsed, results
