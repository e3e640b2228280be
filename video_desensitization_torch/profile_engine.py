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
  * ``stage_ms``: each stage of the program alone, CUDA-event median of
    one call each, except ``mosaic_kernel_device``: the mosaic's device
    time alone (``torch.profiler`` over 50 calls), since one event pair
    around a call of tens of microseconds holds the host's gap before the
    launch;
  * ``host_syncs_per_batch``: synchronising calls in one ``process_batch``
    (CUDA sync debug mode), which the NMS fixpoint rounds dominate;
  * ``device_busy_share`` and the top kernels by device time from
    ``torch.profiler`` over a few batches, or "not measured" when the
    profiler reports no device time.
With ``--yuv`` the stages are the I420 path's (``h2d_i420``,
``i420_to_rgb``, the two mosaic calls' device time, ``d2h_i420``), the RGB
path's host syncs stand beside the I420 path's
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

from video_desensitization_torch.bench_util import (
    cuda_time_ms,
    device_time_us,
    engine_fps,
    main_path_engine,
    profiled_device_ms,
)

BATCH, HEIGHT, WIDTH = 8, 1080, 1920
ALTERNATING_ROUNDS = 5


@torch.inference_mode()
def stage_times(engine, frames_np):
    from video_desensitization_torch.ops.boxes import decode_boxes, decode_landmarks
    from video_desensitization_torch.ops.cuda_mosaic import mosaic_boxes_batch_cuda_
    from video_desensitization_torch.ops.image import (
        letterbox_canvas_formula,
        letterbox_canvas_u8,
        letterbox_params,
        preprocess_batch_device,
    )
    from video_desensitization_torch.ops.nms import batched_nms_padded

    face, plate = engine.face, engine.plate
    hw = face.input_hw
    pinned = torch.from_numpy(frames_np).pin_memory()
    frames = pinned.cuda()
    shapes = torch.tensor([[HEIGHT, WIDTH]] * BATCH, dtype=torch.float32, device="cuda")
    formula = letterbox_canvas_formula((HEIGHT, WIDTH), hw)
    canvas = letterbox_canvas_u8(frames, hw, formula=formula)
    geom = torch.tensor(letterbox_params((HEIGHT, WIDTH), hw), dtype=torch.float32,
                        device="cuda").expand(BATCH, 4)
    x = preprocess_batch_device(canvas, hw, dtype=face.dtype).permute(0, 3, 1, 2)
    loc, conf, landm = face.net(x)
    dets = torch.cat([
        decode_boxes(loc.float(), face.anchors),
        conf[..., 1:2].float(),
        decode_landmarks(landm.float(), face.anchors),
    ], -1)
    _, face_px, face_keep = face._detect_program(canvas, shapes)
    plate_px, plate_keep = plate._detect_letterboxed_program(canvas, shapes, geom)
    boxes = torch.cat([face_px[..., :4], plate_px[..., :4]], 1).to(torch.int32)
    valid = torch.cat([face_keep, plate_keep], 1)
    work = frames.clone()
    host = torch.empty_like(pinned).pin_memory()
    return {
        "h2d_frames": cuda_time_ms(lambda: frames.copy_(pinned, non_blocking=True)),
        "letterbox_canvas": cuda_time_ms(lambda: letterbox_canvas_u8(frames, hw, formula=formula)),
        "face_preprocess": cuda_time_ms(lambda: preprocess_batch_device(canvas, hw, dtype=face.dtype)),
        "face_net": cuda_time_ms(lambda: face.net(x)),
        "face_nms": cuda_time_ms(lambda: batched_nms_padded(dets, face.confidence, face.nms_iou,
                                                          face.max_detections)),
        "face_program": cuda_time_ms(lambda: face._detect_program(canvas, shapes)),
        "plate_program": cuda_time_ms(lambda: plate._detect_letterboxed_program(canvas, shapes, geom)),
        "mosaic_kernel_device": profiled_device_ms(
            lambda: mosaic_boxes_batch_cuda_(work, boxes, valid, 8)
        )[0],
        "d2h_frames": cuda_time_ms(lambda: host.copy_(frames, non_blocking=True)),
    }


@torch.inference_mode()
def stage_times_yuv(engine, yuv_np):
    """The I420 path's own stages: the mosaic's two kernel calls on the
    engine's boxes of this batch, each on its view of the I420 buffer."""
    from video_desensitization_torch.ops.cuda_mosaic import (
        i420_kernel_calls,
        mosaic_boxes_batch_cuda_,
    )
    from video_desensitization_torch.ops.yuv import i420_to_rgb_u8

    pinned = torch.from_numpy(yuv_np).pin_memory()
    frames = pinned.cuda()
    shapes = torch.tensor([[HEIGHT, WIDTH]] * BATCH, dtype=torch.float32, device="cuda")
    _, face_px, face_keep, plate_px, plate_keep = engine.program(frames.clone(), shapes)
    boxes = torch.cat([face_px[..., :4], plate_px[..., :4]], 1).to(torch.int32)
    valid = torch.cat([face_keep, plate_keep], 1)
    y_call, uv_call = i420_kernel_calls(frames.clone(), boxes, valid, engine.mosaic_level)
    host = torch.empty_like(pinned).pin_memory()
    return {
        "h2d_i420": cuda_time_ms(lambda: frames.copy_(pinned, non_blocking=True)),
        "i420_to_rgb": cuda_time_ms(lambda: i420_to_rgb_u8(frames, HEIGHT, WIDTH)),
        "mosaic_kernel_device_y": profiled_device_ms(lambda: mosaic_boxes_batch_cuda_(*y_call))[0],
        "mosaic_kernel_device_uv": profiled_device_ms(lambda: mosaic_boxes_batch_cuda_(*uv_call))[0],
        "d2h_i420": cuda_time_ms(lambda: host.copy_(frames, non_blocking=True)),
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
        "stage_ms": (stage_times_yuv if args.yuv else stage_times)(engine, frames),
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
