"""Where the engine's time goes on one CUDA card.

    python -m video_desensitization_torch.profile_engine [--batches N]

Builds the main-path engine (RetinaFace-ResNet50 + YOLOv8n at 640, bf16,
random weights from seed 0, mosaic level 8) and, on 8 random 1080p RGB
frames per batch, prints one JSON object with:
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
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
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


def host_syncs(engine, frames_np) -> int:
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            engine.process_batch(frames_np)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def profile(engine, frames_np, batches: int):
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            engine.process_batch(frames_np)
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
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_engine: no CUDA device", file=sys.stderr)
        return 2
    engine = main_path_engine()
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
    fps, _ = engine_fps(engine, [frames] * args.batches, keep=False)
    # A caller that keeps every result keeps its pinned output buffers, so
    # each batch needs fresh page-locked memory.
    fps_held, held = engine_fps(engine, [frames] * args.batches, warmup=0)
    boxes = sum(r.num_faces + r.num_plates for r in held)
    del held
    busy, top = profile(engine, frames, 3)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "batch": [BATCH, HEIGHT, WIDTH, 3],
        "letterbox": engine.last_letterbox,
        "e2e_fps": fps,
        "e2e_fps_results_held": fps_held,
        "boxes_per_frame": boxes / (args.batches * BATCH),
        "stage_ms": stage_times(engine, frames),
        "host_syncs_per_batch": host_syncs(engine, frames),
        "device_busy_share": busy,
        "top_kernels": top,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
