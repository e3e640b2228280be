#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printing one line and asserting:
  1. device: the card's name and power limit, torch/CUDA versions, cv2;
  2. build: compiles every kernel of the main path from the checkout
     (nvcc, sm_90a) into video_desensitization_torch/_build/;
  3. kernel: each kernel against its plain PyTorch version on the same CUDA
     input, bitwise, at 1080p batch 8 (C=3, levels 8 and 4), a C=1 1080p
     plane and a C=2 540x960 plane, with the memory bound, the kernel's
     device time and CUDA kernels per call (torch.profiler over many calls),
     and its host time per call;
  4. engine: the full-width main path -- RetinaFace-ResNet50 + YOLOv8n at
     640, bf16, random weights from seed 0, mosaic level 8 -- blurring a few
     8x1080x1920 RGB batches through process_batch, with the kernel's launch
     count and the blurred frames held against the plain mosaic of the
     engine's own boxes;
  5. yuv: the same engine on 8x1620x1920 I420 batches through
     process_batch_yuv: frames/s beside the RGB path's, two kernel calls a
     batch, the blurred I420 frames held bitwise against the plain I420
     mosaic of the engine's own boxes, the same detections as process_batch
     on the cv2-exact RGB of the same frames, and the kernel's device time
     on the Y call and the chroma call beside each one's bound;
  6. tiered: the CLI's default engine, the tiered pipeline (host letterbox,
     the detectors on the card, boxes-only readback, host cv2 mosaic), on
     the same detectors and on new 8x1080x1920 RGB batches: process_batch
     and process_stream give the same results, every blurred frame is the
     cv2 mosaic of the pipeline's own boxes, the kept boxes equal the fused
     engine's on the same batches, the mosaic kernel is launched 0 times;
     frames/s of both warm, in alternating windows, beside the fused
     engine's, stage times alone and inside a stream, bytes each way, the
     engine=auto link probe, and the same batches with transfer = yuv420;
  7. record: the record job's stages on the committed 1080p fixture
     (tests/fixtures/torch_record_1080p.record, LZ4 chunks): unpack, each
     camera stream checked byte for byte, then every stream through the
     tiered and the fused engine (process_single_video), every frame back,
     the kernel's calls counted; the CLI's whole record job (main([ini]),
     with the HEVC repack) only where the codec layer can encode HEVC,
     which is asked before anything runs, and the line says which;
  8. stream: the CLI (cli.main.main) at full width on a short synthetic
     1080p video: the fused engine with transfer = yuv420 and then rgb,
     then the CLI's default engine (no engine key: the tiered pipeline
     through process_stream); every frame back, the kernel's calls counted
     (0 on the default), and the codec path (native libav or cv2);
  9. reference: the card against the CPU on the same weights in float32:
     both networks, then the rest of the engine's program (letterbox
     canvas, decode, NMS, inverse letterbox, box order);
then a "kernels" JSON line, the nvidia-smi line, and the result line.
Exits non-zero without CUDA, outside the repository, or on any failure.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SECTOR_BYTES = 32  # the card reads and writes memory in 32-byte sectors
BATCH, HEIGHT, WIDTH = 8, 1080, 1920
ENGINE_BATCHES = 6
STREAM_FRAMES = 24
WARMUP_BATCHES = 2
TIERED_WINDOWS = 3
STREAM_REPEATS = 3
TIMED_CALLS = 50
REPO = Path(__file__).resolve().parent
RECORD_FIXTURE = REPO / "tests" / "fixtures" / "torch_record_1080p.record"


def check(ok, message="check failed") -> None:
    """Fail the run (also under ``python -O``, which drops asserts)."""
    if not ok:
        raise RuntimeError(message)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def mosaic_bound_ms(frames, boxes, valid, level) -> float:
    """Least time for the mosaic: the bytes it must move over the HBM rate.

    The boxes' remaps compose, so each output pixel is one input pixel; the
    plain mosaic of an index frame gives that source for every pixel. The
    mosaic is in place: a pixel whose source is another pixel is written and
    its source read (the old value of a box is never needed, and a box of
    extent b reads only max(1, b // level) of its rows and columns);
    nothing else moves. Both are counted in the 32-byte sectors that hold
    them, since the card moves no less."""
    import torch

    from video_desensitization_torch.ops.mosaic import mosaic_boxes_batch_

    b, h, w, c = frames.shape
    index = torch.arange(b * h * w, dtype=torch.int64, device=frames.device).view(b, h, w, 1)
    source = mosaic_boxes_batch_(index.clone(), boxes, valid, level)
    moved = source != index
    channel = torch.arange(c, device=frames.device)

    def sectors(pixels):
        return torch.unique((pixels[:, None] * c + channel) // SECTOR_BYTES).numel()

    nbytes = SECTOR_BYTES * (sectors(index[moved]) + sectors(source[moved]))
    return nbytes / HBM_BYTES_PER_S * 1e3


def synthetic_boxes(rng, b, k, h, w):
    """K overlapping boxes per frame, some spilling past every edge, some
    invalid, from 8x8 px up to a quarter of the frame."""
    import numpy as np
    import torch

    x1 = rng.integers(-w // 8, w, (b, k))
    y1 = rng.integers(-h // 8, h, (b, k))
    bw = rng.integers(8, w // 2, (b, k))
    bh = rng.integers(8, h // 2, (b, k))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.int32)
    valid = rng.random((b, k)) > 0.15
    return torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()


def check_mosaic(frames, boxes, valid, level):
    """Kernel vs plain on copies of ``frames`` (B, H, W, C) on the card.
    Returns a dict of the measured numbers: ``ms`` and ``kernels_per_call``
    are the kernel's device time and CUDA kernels per call from
    ``torch.profiler`` over TIMED_CALLS calls, ``host_ms`` the wrapper's host
    time per call. Repeat calls on one working copy cost the same as the
    first: the work depends on the boxes only."""
    import torch

    from video_desensitization_torch.bench_util import (
        cuda_time_ms,
        host_ms_per_call,
        profiled_device_ms,
    )
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.ops.mosaic import mosaic_boxes_batch_

    c = frames.shape[-1]
    before = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    got = cuda_mosaic.mosaic_boxes_batch_cuda_(frames.clone(), boxes, valid, level)
    check(cuda_mosaic.mosaic_boxes_batch_cuda_.launches == before + 1)
    want = mosaic_boxes_batch_(frames.clone(), boxes, valid, level)
    torch.cuda.synchronize()
    max_err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
    check(torch.equal(got, want), f"kernel != plain (C={c}, level={level}), max err {max_err}")
    work = frames.clone()

    def call():
        cuda_mosaic.mosaic_boxes_batch_cuda_(work, boxes, valid, level)

    device_ms, kernels_per_call = profiled_device_ms(call, TIMED_CALLS)
    check(device_ms is not None, "the profiler saw no device time")
    check(kernels_per_call > 0, "the profiler saw no CUDA kernel")
    return {
        "max_abs_err": max_err,
        "ms": device_ms,
        "kernels_per_call": kernels_per_call,
        "host_ms": host_ms_per_call(call, TIMED_CALLS),
        "plain_ms": cuda_time_ms(lambda: mosaic_boxes_batch_(work, boxes, valid, level), 3),
        "bound_ms": mosaic_bound_ms(frames, boxes, valid, level),
        "boxes": int(valid.sum()),
    }


def timing_text(r) -> str:
    return (
        f"{r['ms']:.4f} ms device in {r['kernels_per_call']:g} CUDA kernels "
        f"(profiler; host {r['host_ms']:.4f} ms) per call; "
        f"plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.6f}"
    )


def phase_device() -> str:
    import torch

    smi = nvidia_smi()
    try:
        import cv2

        cv2_state = f"cv2 {cv2.__version__}"
    except ImportError:
        cv2_state = "cv2 absent"
    print(
        f"phase device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {cv2_state}",
        flush=True,
    )
    return smi


def phase_build() -> None:
    from video_desensitization_torch.ops import cuda_mosaic

    t0 = time.perf_counter()
    cuda_mosaic.load_library()
    seconds = time.perf_counter() - t0
    log = cuda_mosaic.build_library().with_suffix(".log").read_text()
    usage = " ".join(l.strip() for l in log.splitlines() if "registers" in l)
    print(f"phase build: mosaic.cu in {seconds:.2f} s | {usage}", flush=True)


def phase_kernel() -> None:
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rgb = torch.randint(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=torch.uint8,
                        device="cuda", generator=gen)
    boxes, valid = synthetic_boxes(rng, BATCH, 24, HEIGHT, WIDTH)
    cases = [("rgb-L8", rgb, boxes, valid, 8), ("rgb-L4", rgb, boxes, valid, 4)]
    cases.append(("plane-C1-L8", rgb[..., :1].contiguous(), boxes, valid, 8))
    ch, cw = HEIGHT // 2, WIDTH // 2
    cboxes, cvalid = synthetic_boxes(rng, BATCH, 24, ch, cw)
    cases.append(("uv-C2-L4", rgb[:, :ch, :cw, :2].contiguous(), cboxes, cvalid, 4))
    parts = []
    for name, frames, bx, ok, level in cases:
        r = check_mosaic(frames, bx, ok, level)
        parts.append(f"{name} {tuple(frames.shape)} boxes {r['boxes']}: equal, {timing_text(r)}")
    print("phase kernel: " + " | ".join(parts), flush=True)


def kept_boxes(res, batch):
    """The engine's kept boxes of one result, faces then plates, as padded
    (B, K, 4) int32 and (B, K) bool tensors on the card (the engine casts
    its float boxes to int32 the same way)."""
    import numpy as np
    import torch

    kept = [f + p for f, p in zip(res.face_boxes, res.plate_boxes)]
    k = max(1, max(len(b) for b in kept))
    boxes = np.zeros((batch, k, 4), np.float32)
    valid = np.zeros((batch, k), bool)
    for i, bl in enumerate(kept):
        if bl:
            arr = np.asarray(bl, np.float32)
            check(np.isfinite(arr).all())
            boxes[i, : len(bl)] = arr
            valid[i, : len(bl)] = True
    return torch.from_numpy(boxes.astype(np.int32)).cuda(), torch.from_numpy(valid).cuda()


def phase_engine(engine) -> dict:
    import numpy as np
    import torch

    from video_desensitization_torch.bench_util import engine_fps
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.ops.mosaic import mosaic_boxes_batch_

    rng = np.random.default_rng(1)
    batches = [
        rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
        for _ in range(ENGINE_BATCHES)
    ]
    cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
    fps, results = engine_fps(engine, batches, warmup=WARMUP_BATCHES)
    launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    runs = WARMUP_BATCHES + ENGINE_BATCHES
    check(launches == runs, f"mosaic kernel launched {launches}x in {runs} batches")

    n_boxes = 0
    for frames, res in zip(batches, results):
        check(res.frames.shape == frames.shape and res.frames.dtype == np.uint8)
        dev_boxes, dev_valid = kept_boxes(res, BATCH)
        n_boxes += int(dev_valid.sum())
        want = mosaic_boxes_batch_(
            torch.from_numpy(frames).cuda(), dev_boxes, dev_valid, engine.mosaic_level
        )
        check(torch.equal(torch.from_numpy(res.frames).cuda(), want), "engine != plain mosaic")

    # The kernel at the main path's own shapes and boxes (last batch).
    timing = check_mosaic(
        torch.from_numpy(batches[-1]).cuda(), dev_boxes, dev_valid, engine.mosaic_level
    )
    print(
        f"phase engine: resnet50+yolov8n 640 bf16, {ENGINE_BATCHES}x{BATCH}x{HEIGHT}x{WIDTH}: "
        f"{fps:.2f} frames/s (results held), {n_boxes / (ENGINE_BATCHES * BATCH):.2f} boxes/frame, "
        f"letterbox {engine.last_letterbox}, mosaic launches {launches} in {runs} batches, "
        f"blurred == plain mosaic of the engine's boxes; kernel on the last batch's boxes: "
        f"{timing_text(timing)}",
        flush=True,
    )
    return {**timing, "launches": launches, "fps": fps}


def phase_yuv(engine, rgb_fps: float) -> dict:
    """The engine on I420 batches (B, H*3/2, W) through process_batch_yuv."""
    import numpy as np
    import torch

    from video_desensitization_torch.bench_util import engine_fps
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.ops.mosaic import mosaic_i420_batch
    from video_desensitization_torch.ops.yuv import i420_to_rgb_u8

    rng = np.random.default_rng(4)
    shape = (BATCH, HEIGHT * 3 // 2, WIDTH)
    batches = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(ENGINE_BATCHES)]
    cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
    fps, results = engine_fps(engine, batches, warmup=WARMUP_BATCHES, yuv=True)
    launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    runs = WARMUP_BATCHES + ENGINE_BATCHES
    check(launches == 2 * runs, f"mosaic kernel called {launches}x in {runs} I420 batches, not 2 a batch")

    n_boxes, box_err = 0, 0.0
    for frames, res in zip(batches, results):
        check(res.frames.shape == shape and res.frames.dtype == np.uint8)
        dev_boxes, dev_valid = kept_boxes(res, BATCH)
        n_boxes += int(dev_valid.sum())
        dev_frames = torch.from_numpy(frames).cuda()
        want = mosaic_i420_batch(dev_frames, dev_boxes, dev_valid, engine.mosaic_level)
        check(torch.equal(torch.from_numpy(res.frames).cuda(), want), "I420 engine != plain I420 mosaic")
        on_rgb = engine.process_batch(i420_to_rgb_u8(dev_frames, HEIGHT, WIDTH).cpu().numpy())
        check(on_rgb.num_faces == res.num_faces and on_rgb.num_plates == res.num_plates,
              "I420 and RGB programs kept different boxes")
        for a, b in zip(on_rgb.face_boxes + on_rgb.plate_boxes, res.face_boxes + res.plate_boxes):
            a, b = (np.asarray(x, np.float64).reshape(-1, 4) for x in (a, b))
            check(a.shape == b.shape, "I420 and RGB programs kept different boxes in a frame")
            if a.size:
                box_err = max(box_err, float(np.abs(a - b).max()))
        check(box_err <= 1e-3, f"I420 boxes differ from RGB boxes by {box_err} px")

    # The kernel's two calls on the last batch's boxes, each on its view.
    calls = cuda_mosaic.i420_kernel_calls(dev_frames, dev_boxes, dev_valid, engine.mosaic_level)
    y, uv = (check_mosaic(*call) for call in calls)
    print(
        f"phase yuv: resnet50+yolov8n 640 bf16, {ENGINE_BATCHES}x{BATCH}x{HEIGHT * 3 // 2}x{WIDTH} "
        f"I420: {fps:.2f} frames/s (results held; RGB {rgb_fps:.2f} in the engine phase of this "
        f"run), {n_boxes / (ENGINE_BATCHES * BATCH):.2f} boxes/frame, mosaic calls {launches} in "
        f"{runs} batches (2 a batch: Y, then U and V), blurred I420 == plain I420 mosaic of the "
        f"engine's boxes, detections == process_batch on the cv2-exact RGB (boxes within "
        f"{box_err:.2e} px); kernel on the last batch's boxes: Y {tuple(calls[0][0].shape)} "
        f"{timing_text(y)} | U,V {tuple(calls[1][0].shape)} {timing_text(uv)}",
        flush=True,
    )
    return {"fps": fps, "launches": launches, "y": y, "uv": uv}


def phase_stream() -> dict:
    """``cli.main.main`` on a short synthetic 1080p video at full width:
    the fused engine with transfer = yuv420, then rgb, then a config with no
    ``engine`` or ``transfer`` key, so the CLI takes its default (the tiered
    pipeline on rgb, through ``process_stream``). Its frames/s is the CLI's
    wall time (engine build and codec included) and is bound by the codec,
    not the card."""
    import tempfile

    import numpy as np

    from video_desensitization_torch.cli.main import main as cli_main
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.pipeline.throughput import TieredPipeline
    from video_desensitization_torch.video import av

    rng = np.random.default_rng(5)
    batches = -(-STREAM_FRAMES // BATCH)
    streams = []
    stream_of = TieredPipeline.process_stream

    def counted_stream(self, *args, **kwargs):
        streams.append(self)
        return stream_of(self, *args, **kwargs)

    parts = []
    with tempfile.TemporaryDirectory() as tmp:
        src = f"{tmp}/in.mp4"
        with av.VideoEncoder(src, WIDTH, HEIGHT, fps=24, codec="mpeg4") as enc:
            for _ in range(STREAM_FRAMES):
                coarse = rng.integers(0, 256, (HEIGHT // 8, WIDTH // 8, 3), dtype=np.uint8)
                enc.write(coarse.repeat(8, axis=0).repeat(8, axis=1))
        # (name, [TPU] keys, mosaic kernel calls a batch)
        passes = [
            ("fused yuv420", "engine=fused\ntransfer=yuv420\n", 2),
            ("fused rgb", "engine=fused\ntransfer=rgb\n", 1),
            ("default (tiered rgb)", "", 0),
        ]
        for i, (name, keys, per_batch) in enumerate(passes):
            ini = f"{tmp}/{i}.ini"
            with open(ini, "w") as f:
                f.write(
                    "[PATHS]\nmodel_path=\nmodel_weights=\n[SETTINGS]\nbatch_size=8\n"
                    f"[TPU]\n{keys}dtype=bfloat16\ninput_size=640\nmax_detections=16\n"
                    "mosaic_level=8\n"
                )
            out = f"{tmp}/out_{i}.mp4"
            cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
            streams.clear()
            TieredPipeline.process_stream = counted_stream
            try:
                t0 = time.perf_counter()
                rc = cli_main([ini, "--video", src, "--out", out, "--allow-random-weights"])
                seconds = time.perf_counter() - t0
            finally:
                TieredPipeline.process_stream = stream_of
            launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
            check(rc == 0, f"{name}: CLI returned {rc}")
            check(launches == per_batch * batches,
                  f"{name}: mosaic kernel called {launches}x in {batches} batches")
            tiered = len(streams) == 1 and streams[0].transfer == "rgb"
            check(tiered == (per_batch == 0),
                  f"{name}: {len(streams)} tiered streams ran, not {int(per_batch == 0)}")
            with av.VideoDecoder(out) as dec:
                frames = [f.shape for f in dec]
            check(frames == [(HEIGHT, WIDTH, 3)] * STREAM_FRAMES,
                  f"{name}: {len(frames)} of {STREAM_FRAMES} frames back")
            parts.append(
                f"{name}: {STREAM_FRAMES} frames back, mosaic calls {launches} in {batches} "
                f"batches, tiered process_stream runs {len(streams)}, "
                f"{STREAM_FRAMES / seconds:.2f} frames/s over the CLI's wall time "
                f"({seconds:.2f} s, engine build and codec included: codec-bound)"
            )
    print(f"phase stream: codec {av.codec_path()} | " + " | ".join(parts), flush=True)
    return {"codec": av.codec_path()}


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``reps`` calls of ``fn`` (host work only)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fmt(values) -> str:
    return "[" + ", ".join(f"{v:.2f}" for v in values) + "]"


def stream_stage_ms(pipe, batches) -> dict:
    """Median host ms per batch of each stage of ``pipe.process_stream``
    while it runs over ``batches``: the letterbox on the caller's thread,
    ``dispatch`` (copies and program enqueued, NMS syncs included) on the
    dispatch thread, ``finalize`` (the wait for the boxes, then the host
    mosaic) on the finalize thread. Each method is wrapped on the instance
    for the one stream and unwrapped after it."""
    stages = {"letterbox_batch": "letterbox", "dispatch": "dispatch", "finalize": "finalize"}
    times = {key: [] for key in stages.values()}

    def timed(method, key):
        fn = getattr(pipe, method)

        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    for method, key in stages.items():
        setattr(pipe, method, timed(method, key))
    try:
        list(pipe.process_stream(iter(batches)))
    finally:
        for method in stages:
            delattr(pipe, method)
    return {key: statistics.median(v) for key, v in times.items()}


def phase_tiered(engine) -> dict:
    """The tiered pipeline on the fused engine's own detectors (the CLI's
    configuration at full width), on batches of its own."""
    import numpy as np
    import torch

    from video_desensitization_torch.bench_util import cuda_time_ms, engine_fps
    from video_desensitization_torch.cli.main import pick_engine, probe_link_gib_s
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.ops.image import letterbox_geometry
    from video_desensitization_torch.ops.mosaic import mosaic_host_reference
    from video_desensitization_torch.pipeline.throughput import TieredPipeline

    rng = np.random.default_rng(6)
    batches = [
        rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
        for _ in range(ENGINE_BATCHES)
    ]
    fused_fps, fused = engine_fps(engine, batches, warmup=WARMUP_BATCHES)
    tiered = TieredPipeline(engine.face, engine.plate, mosaic_level=engine.mosaic_level)
    yuv = TieredPipeline(engine.face, engine.plate, mosaic_level=engine.mosaic_level,
                         transfer="yuv420")
    cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
    # process_batch and process_stream, each warmed first, then timed in
    # alternating windows on the same batches: process_batch over the
    # batches once, process_stream over them STREAM_REPEATS times in one
    # stream (so the fill and drain of its STREAM_DEPTH batches in flight
    # weigh less).
    list(tiered.process_stream(iter(batches[:WARMUP_BATCHES])))
    batch_fps, stream_fps = [], []
    for _ in range(TIERED_WINDOWS):
        fps, results = engine_fps(tiered, batches, warmup=WARMUP_BATCHES if not batch_fps else 0)
        batch_fps.append(fps)
        t0 = time.perf_counter()
        streamed = list(tiered.process_stream(iter(batches * STREAM_REPEATS)))
        stream_fps.append(len(streamed) * BATCH / (time.perf_counter() - t0))
    stage_in_stream = stream_stage_ms(tiered, batches * STREAM_REPEATS)
    yuv_fps, yuv_results = engine_fps(yuv, batches, warmup=WARMUP_BATCHES)
    launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    fps = statistics.median(batch_fps)
    check(launches == 0, f"the mosaic kernel was launched {launches}x on the tiered path")

    box_err, n_boxes = 0.0, 0
    check(len(streamed) == STREAM_REPEATS * ENGINE_BATCHES, "process_stream lost batches")
    for j, st in enumerate(streamed):
        res = results[j % ENGINE_BATCHES]
        check(np.array_equal(st.frames, res.frames) and st.face_boxes == res.face_boxes
              and st.plate_boxes == res.plate_boxes, "process_stream != process_batch")
    for frames, res, fu in zip(batches, results, fused):
        for i in range(BATCH):
            boxes = np.asarray(res.face_boxes[i] + res.plate_boxes[i], np.float32).reshape(-1, 4)
            want = mosaic_host_reference(frames[i], boxes.astype(np.int64).tolist(),
                                         engine.mosaic_level)
            check(np.array_equal(res.frames[i], want), "tiered != cv2 mosaic of its own boxes")
        for a, b in zip(res.face_boxes + res.plate_boxes, fu.face_boxes + fu.plate_boxes):
            check(len(a) == len(b), "the tiered and fused engines kept different boxes")
            n_boxes += len(a)
            if a:
                box_err = max(box_err, float(np.abs(np.asarray(a) - np.asarray(b)).max()))
    check(box_err <= 1e-3, f"tiered boxes differ from the fused engine's by {box_err} px")
    yuv_boxes = sum(r.num_faces + r.num_plates for r in yuv_results)

    # Each stage alone on the last batch: the host letterbox, the device
    # program on device-resident content (CUDA events), the host mosaic
    # (finalize on a batch whose boxes are already back).
    frames = batches[-1]
    shapes = np.tile(np.array([[HEIGHT, WIDTH]], np.float32), (BATCH, 1))
    content = tiered.letterbox_batch(frames)
    aux = np.concatenate([shapes, letterbox_geometry(shapes, tiered.input_hw)], axis=1)
    dev_content, dev_aux = torch.from_numpy(content).cuda(), torch.from_numpy(aux).cuda()
    handle = tiered.dispatch(content, shapes)
    tiered.finalize(frames, handle)  # waits for the boxes; warms the pool
    stages = {
        "letterbox": host_ms(lambda: tiered.letterbox_batch(frames)),
        "program": cuda_time_ms(lambda: tiered.program(dev_content, dev_aux)),
        "mosaic": host_ms(lambda: tiered.finalize(frames, handle)),
    }
    h2d, d2h = content.nbytes + aux.nbytes, handle[0].numel() * handle[0].element_size()
    yuv_h2d = yuv.letterbox_batch(frames).nbytes + aux.nbytes
    gib_s = probe_link_gib_s()
    print(
        f"phase tiered: resnet50+yolov8n 640 bf16, {ENGINE_BATCHES}x{BATCH}x{HEIGHT}x{WIDTH} RGB: "
        f"{fps:.2f} frames/s (process_batch, results held, median of {TIERED_WINDOWS} warm "
        f"windows {fmt(batch_fps)}; fused engine {fused_fps:.2f} on the same batches), "
        f"process_stream {statistics.median(stream_fps):.2f} (median of {TIERED_WINDOWS} warm "
        f"windows of {STREAM_REPEATS * ENGINE_BATCHES} batches {fmt(stream_fps)}; per batch "
        f"in a stream: caller letterbox {stage_in_stream['letterbox']:.3f}, dispatch "
        f"{stage_in_stream['dispatch']:.3f}, finalize {stage_in_stream['finalize']:.3f} ms "
        f"host, medians), "
        f"{n_boxes / (ENGINE_BATCHES * BATCH):.2f} boxes/frame, process_stream == process_batch, "
        f"blurred == cv2 mosaic of its own boxes, kept boxes == the fused engine's (letterbox "
        f"{engine.last_letterbox}, boxes within {box_err:.2e} px), mosaic kernel launches "
        f"{launches}; ms per batch: host letterbox {stages['letterbox']:.3f}, device program "
        f"{stages['program']:.3f}, host mosaic {stages['mosaic']:.3f}; bytes per batch: "
        f"{h2d} in, {d2h} out (fused: {frames.nbytes} each way); engine=auto probe "
        f"{gib_s:.2f} GiB/s -> {pick_engine(gib_s)} (rgb), {pick_engine(gib_s, 'yuv420')} "
        f"(yuv420) | transfer yuv420: {yuv_fps:.2f} frames/s, {yuv_boxes} boxes in "
        f"{ENGINE_BATCHES * BATCH} frames, {yuv_h2d} bytes in per batch",
        flush=True,
    )
    return {"fps": fps, "fused_fps": fused_fps, "stream_fps": statistics.median(stream_fps),
            "launches": launches, **stages}


def check_final_record(source: str, final: str) -> dict:
    """A repacked record against its source: the same channels; each
    camera topic keeps its messages from its first keyframe on, with their
    times and sequence numbers; every other channel byte for byte. Returns
    the messages per channel of the final record."""
    from video_desensitization_torch.record.reader import RecordReader
    from video_desensitization_torch.record.topics import COMPRESSED_IMAGE_TYPE
    from video_desensitization_torch.video.nal import is_hevc_keyframe

    src, out = RecordReader(source), RecordReader(final)
    check(set(out.channels) == set(src.channels), "the final record's channels differ")
    counts = {}
    for topic, channel in src.channels.items():
        want, got = list(src.read_messages(topic)), list(out.read_messages(topic))
        if channel.message_type == COMPRESSED_IMAGE_TYPE:
            key = next(i for i, (_, m, _) in enumerate(want) if is_hevc_keyframe(bytes(m.data)))
            want = [(ts, m.header.sequence_num) for _, m, ts in want[key:]]
            check([(ts, m.header.sequence_num) for _, m, ts in got] == want,
                  f"{topic}: {len(got)} messages, not the {len(want)} after gating with "
                  "their times and sequence numbers")
        else:
            check(got == want, f"{topic}: non-camera messages changed")
        counts[topic] = len(got)
    return counts


def phase_record(engine) -> dict:
    """The record job's stages on the committed fixture, with the tiered
    pipeline and the fused engine."""
    import shutil
    import tempfile

    from video_desensitization_torch.cli.main import main as cli_main
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.pipeline.throughput import TieredPipeline
    from video_desensitization_torch.pipeline.video_pipeline import process_single_video
    from video_desensitization_torch.record import lz4block
    from video_desensitization_torch.record.reader import RecordReader
    from video_desensitization_torch.record.unpack import read_record2h265_all
    from video_desensitization_torch.video import av
    from video_desensitization_torch.video.nal import is_hevc_keyframe

    # The repack re-encodes with libx265 and demuxes with libav: asked
    # before anything runs, from the codec layer's own state.
    hevc_encoder = av.native_available()
    codec = av.codec_path()
    parts = []
    with tempfile.TemporaryDirectory() as tmp:
        # A copy: the unpack stages a .tmp_record beside its input.
        os.makedirs(f"{tmp}/in")
        fixture = shutil.copy(RECORD_FIXTURE, f"{tmp}/in")
        t0 = time.perf_counter()
        streams = read_record2h265_all(fixture, f"{tmp}/h265")
        unpack_s = time.perf_counter() - t0
        check(lz4block.native_available(), f"csrc/vdt_lz4.cpp did not load: {lz4block._load_error}")
        reader = RecordReader(fixture)
        frames = {}
        for topic, path in streams.items():
            payloads = [bytes(m.data) for _, m, _ in reader.read_messages(topic)]
            key = next(i for i, p in enumerate(payloads) if is_hevc_keyframe(p))
            check(Path(path).read_bytes() == b"".join(payloads[key:]),
                  f"{topic}: unpacked stream != its payloads from the first keyframe")
            frames[topic] = len(payloads) - key
        check(len(streams) == 2, f"unpacked {len(streams)} camera streams, not 2")
        parts.append(f"unpacked {len(streams)} streams ({sorted(frames.values())} frames after "
                     f"gating) in {unpack_s:.2f} s, byte for byte")
        ext = None if hevc_encoder else ".mp4"
        tiered = TieredPipeline(engine.face, engine.plate, mosaic_level=engine.mosaic_level)
        for name, eng in (("tiered", tiered), ("fused", engine)):
            out_dir = f"{tmp}/{name}"
            cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
            t0 = time.perf_counter()
            for topic, path in streams.items():
                res = process_single_video(path, out_dir, eng, batch_size=BATCH, output_ext=ext)
                check(res.success and res.frames == frames[topic], f"{name}: {topic} failed")
            seconds = time.perf_counter() - t0
            launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
            want = 0 if name == "tiered" else sum(-(-n // BATCH) for n in frames.values())
            check(launches == want, f"{name}: mosaic kernel launched {launches}x, not {want}")
            for topic, path in streams.items():
                stem, src_ext = os.path.splitext(os.path.basename(path))
                with av.VideoDecoder(f"{out_dir}/{stem}_processed{ext or src_ext}") as dec:
                    shapes = [f.shape for f in dec]
                check(shapes == [(HEIGHT, WIDTH, 3)] * frames[topic],
                      f"{name}: {len(shapes)} of {frames[topic]} frames of {topic} back")
            parts.append(f"{name}: every frame back at {HEIGHT}x{WIDTH} ({ext or 'h265'}), "
                         f"mosaic launches {launches}, {seconds:.2f} s")
        if hevc_encoder:
            job = f"{tmp}/job"
            ini = f"{tmp}/job.ini"
            with open(ini, "w") as f:
                f.write(
                    f"[PATHS]\nmodel_path=random\nmodel_weights=random\nrecord_dir={fixture}\n"
                    f"output_h265_dir={job}/h265\noutput_videos_dir={job}/videos\n"
                    f"temp_directory_base={job}/tmp\nrecord_output_dir={job}/out\n"
                    "[SETTINGS]\nbatch_size=8\n[TPU]\nmax_detections=16\nmosaic_level=8\n"
                )
            t0 = time.perf_counter()
            check(cli_main([ini]) == 0, "the CLI's record job failed")
            counts = check_final_record(fixture, f"{job}/out/{os.path.basename(fixture)}")
            parts.append(f"record job end to end (main([ini]), HEVC repack): {counts} messages, "
                         f"{time.perf_counter() - t0:.2f} s")
        else:
            parts.append("record job end to end: not run, codec cv2 has no HEVC encoder; "
                         "held on the CPU by tests/test_torch_record.py")
    print(f"phase record: {RECORD_FIXTURE.relative_to(REPO)}, codec {codec} | " + " | ".join(parts),
          flush=True)
    return {"hevc_encoder": hevc_encoder}


def _recording(net, calls):
    """``net``, keeping a CPU copy of each call's input and outputs."""
    def run(x):
        out = net(x)
        calls.append((x.cpu(), [o.cpu() for o in out]))
        return out
    return run


def _replaying(calls):
    """Stands in for a network on the CPU: checks that its input equals the
    card's to float32 rounding (the card divides by a scalar as a multiply
    by its reciprocal, one ulp from the CPU's quotient; a canvas pixel off
    by one level would differ by 1/255) and returns the card's outputs."""
    import torch

    def run(x):
        card_x, out = calls.pop(0)
        check(torch.allclose(x, card_x, rtol=1e-6, atol=0), "network input on the card != on the CPU")
        return out
    return run


def phase_reference() -> None:
    """The card against the CPU on the same weights in float32, TF32 off.

    First both networks on one input. Then the rest of the engine's program
    on a small RGB batch: the CPU replays the card's network outputs, and
    the networks' inputs (letterbox canvas, mean-sub, 114-gray repad) must
    agree to rounding, the keep masks be equal and the boxes (decode, NMS, inverse
    letterbox, faces before plates) within 1e-3 px or 1e-5 of their size.
    Replaying keeps float noise out of the NMS choices: random weights give
    near-tied scores and boxes far outside the frame."""
    import numpy as np
    import torch

    from video_desensitization_torch.bench_util import main_path_engine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = np.random.default_rng(2).normal(0, 1, (2, 3, 128, 128)).astype(np.float32)
    x = torch.from_numpy(x)
    gpu = main_path_engine("cuda", input_hw=(128, 128), dtype=torch.float32)
    cpu = main_path_engine("cpu", input_hw=(128, 128), dtype=torch.float32)
    worst = 0.0
    with torch.inference_mode():
        for g, c in ((gpu.face.net, cpu.face.net), (gpu.plate.net, cpu.plate.net)):
            for a, b in zip(g(x.cuda()), c(x)):
                torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3)
                worst = max(worst, float((a.cpu() - b).abs().max()))

    frames = np.random.default_rng(3).integers(0, 256, (2, 216, 384, 3), dtype=np.uint8)
    shapes = torch.tensor([[216.0, 384.0]] * 2)
    face_calls, plate_calls = [], []
    gpu.face.net = _recording(gpu.face.net, face_calls)
    gpu.plate.net = _recording(gpu.plate.net, plate_calls)
    card = [t.cpu() for t in gpu.program(torch.from_numpy(frames.copy()).cuda(), shapes.cuda())]
    cpu.face.net, cpu.plate.net = _replaying(face_calls), _replaying(plate_calls)
    host = cpu.program(torch.from_numpy(frames.copy()), shapes)
    check(not face_calls and not plate_calls and gpu.last_letterbox == cpu.last_letterbox)
    _, face_px, face_keep, plate_px, plate_keep = card
    check(torch.equal(face_keep, host[2]) and torch.equal(plate_keep, host[4]),
          "keep masks on the card != on the CPU")
    check(bool(face_keep.any() and plate_keep.any()), "the program kept no box")
    box_err = box_size = 0.0
    for a, b in ((face_px, host[1]), (plate_px, host[3])):
        torch.testing.assert_close(a[..., :4], b[..., :4], rtol=1e-5, atol=1e-3)
        box_err = max(box_err, float((a[..., :4] - b[..., :4]).abs().max()))
        box_size = max(box_size, float(b[..., :4].abs().max()))
    print(
        f"phase reference: f32 nets on the card vs the CPU, max abs diff {worst:.2e} | "
        f"program on 2x216x384 ({gpu.last_letterbox}) with the card's net outputs replayed "
        f"on the CPU: net inputs equal to 1e-6, keep masks equal ({int(face_keep.sum())} faces, "
        f"{int(plate_keep.sum())} plates), boxes max diff {box_err:.2e} px at coordinates "
        f"up to {box_size:.3g} px",
        flush=True,
    )


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "video_desensitization_torch" / "csrc" / "mosaic.cu").is_file():
        print(f"chip_smoke: no video_desensitization_torch package in {REPO}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    from video_desensitization_torch.bench_util import main_path_engine

    smi = phase_device()
    phase_build()
    phase_kernel()
    main_engine = main_path_engine()
    engine = phase_engine(main_engine)
    yuv = phase_yuv(main_engine, engine["fps"])
    phase_tiered(main_engine)
    phase_record(main_engine)
    del main_engine
    phase_stream()
    phase_reference()
    kernel = {
        "name": "mosaic",
        "route": "cuda",
        "source": "video_desensitization_torch/csrc/mosaic.cu",
        "replaces": "video_desensitization_tpu/ops/pallas_mosaic.py:84",
        "launches": engine["launches"],
        "max_abs_err": engine["max_abs_err"],
        "ms": engine["ms"],
        "plain_ms": engine["plain_ms"],
        "bound_ms": engine["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "host_ms": engine["host_ms"],
        "cuda_kernels_per_call": engine["kernels_per_call"],
        "i420_launches": yuv["launches"],
        "i420_calls_per_batch": yuv["launches"] // (WARMUP_BATCHES + ENGINE_BATCHES),
        "i420_y_ms": yuv["y"]["ms"],
        "i420_y_bound_ms": yuv["y"]["bound_ms"],
        "i420_uv_ms": yuv["uv"]["ms"],
        "i420_uv_bound_ms": yuv["uv"]["bound_ms"],
    }
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
