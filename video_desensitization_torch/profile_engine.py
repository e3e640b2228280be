"""Where the engine's time goes on one CUDA card.

    python -m video_desensitization_torch.profile_engine [--batches N] [--yuv]

Builds the main-path engine (RetinaFace-ResNet50 + YOLOv8n at 640, bf16,
random weights from seed 0, mosaic level 8) and, on 8 random 1080p RGB
frames per batch (8 random 1620x1920 I420 frames through
``process_batch_yuv`` with ``--yuv``), prints one JSON object with:
  * ``e2e_fps``: frames/s of ``process_batch`` (host clock, pinned copies
    included), each result dropped before the next batch;
  * ``e2e_fps_results_held``: the same with every result kept, as a caller
    collecting a job's output does;
  * ``stage_ms`` and ``spans_per_batch``: the program's own spans
    (``utils/timers.py::span``) over ``--batches`` calls of
    ``process_batch``, each waiting for its batch: host ms a batch and
    spans a batch of each (``nms.flag_read``: the NMS rounds' host syncs);
  * ``host_syncs_per_batch``: synchronising calls in one ``process_batch``
    (CUDA sync debug mode): NMS's convergence reads alone, once the
    detectors' CUDA graphs replay (``utils/graphs.py``);
  * ``device_busy_share`` and the top kernels by device time from
    ``torch.profiler`` over a few batches, or "not measured" when the
    profiler reports no device time.
With ``--yuv`` the spans are the I420 path's (``process_batch_yuv``), the
RGB path's host syncs stand beside the I420 path's
(``rgb_host_syncs_per_batch``), and ``alternating_fps_results_held`` holds
the frames/s of ``ALTERNATING_ROUNDS`` windows of each path, results held,
taken in turns (RGB first in even rounds, I420 first in odd ones), with
their medians: one window of a few batches moves by a quarter or more
between windows of the same code.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import warnings

import numpy as np
import torch

from video_desensitization_torch.bench_util import device_time_us, engine_fps, main_path_engine
from video_desensitization_torch.utils.timers import StageTimer, activate

BATCH, HEIGHT, WIDTH = 8, 1080, 1920
ALTERNATING_ROUNDS = 5


def span_ms(process, frames_np, batches: int) -> dict:
    """The program's own spans (``utils/timers.py::span``: the engine's
    stage-in, letterbox, detector programs, NMS reads, mosaic, stage-out,
    wait and gather) over ``batches`` calls of ``process`` under an
    activated timer: host ms a batch and spans a batch of each."""
    timer = StageTimer()
    with activate(timer):
        for _ in range(batches):
            process(frames_np)
    return {
        "stage_ms": {k: v / batches * 1e3 for k, v in timer.totals.items()},
        "spans_per_batch": {k: n / batches for k, n in timer.counts.items()},
    }


def alternating_fps(engine, rgb_np, yuv_np, batches: int) -> dict:
    """Frames/s of windows of ``batches`` RGB and I420 batches, results
    held, in turns: per path, the list of windows and its median."""
    fps = {"rgb": [], "i420": []}
    for r in range(ALTERNATING_ROUNDS):
        for path in ("rgb", "i420") if r % 2 == 0 else ("i420", "rgb"):
            frames = rgb_np if path == "rgb" else yuv_np
            fps[path].append(engine_fps(engine, [frames] * batches, warmup=0, yuv=path == "i420")[0])
    return {**fps, **{f"median_{k}": statistics.median(v) for k, v in list(fps.items())}}


def host_syncs(process, frames_np) -> int:
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            process(frames_np)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def profile(process, frames_np, batches: int):
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            process(frames_np)
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if getattr(e, "device_type", None) == cuda]
    busy_us = sum(device_time_us(e) for e in kernels)
    if busy_us == 0.0:
        return "not measured", []
    top = sorted(kernels, key=device_time_us, reverse=True)[:12]
    return busy_us / wall_us, [
        {"kernel": e.key[:90], "ms_per_batch": device_time_us(e) / 1e3 / batches, "calls": e.count}
        for e in top
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, default=6)
    p.add_argument("--yuv", action="store_true",
                   help="profile the I420 path, beside the RGB path's frames/s and syncs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_engine: no CUDA device", file=sys.stderr)
        return 2
    engine = main_path_engine()
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
    report = {"device": torch.cuda.get_device_name(0)}
    if args.yuv:
        rgb_frames = frames
        frames = rng.integers(0, 256, (BATCH, HEIGHT * 3 // 2, WIDTH), dtype=np.uint8)
        engine_fps(engine, [rgb_frames], warmup=1, keep=False)
        engine_fps(engine, [frames], warmup=1, keep=False, yuv=True)
        rgb = {
            "rgb_host_syncs_per_batch": host_syncs(engine.process_batch, rgb_frames),
            "alternating_fps_results_held": alternating_fps(engine, rgb_frames, frames, args.batches),
        }
        process = engine.process_batch_yuv
    else:
        process = engine.process_batch
    fps, _ = engine_fps(engine, [frames] * args.batches, keep=False, yuv=args.yuv)
    # A caller that keeps every result keeps its pinned output buffers, so
    # each batch needs fresh page-locked memory.
    fps_held, held = engine_fps(engine, [frames] * args.batches, warmup=0, yuv=args.yuv)
    boxes = sum(r.num_faces + r.num_plates for r in held)
    del held
    busy, top = profile(process, frames, 3)
    report.update({
        "batch": list(frames.shape),
        "letterbox": engine.last_letterbox,
        "e2e_fps": fps,
        "e2e_fps_results_held": fps_held,
        "boxes_per_frame": boxes / (args.batches * BATCH),
        **span_ms(process, frames, args.batches),
        "host_syncs_per_batch": host_syncs(process, frames),
        "device_busy_share": busy,
        "top_kernels": top,
    })
    if args.yuv:
        report.update(rgb)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
