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
  6. weights: weights from files through the CLI's engine -- the main
     engine's two networks in float32 from the same seed saved as
     reference-layout checkpoints (face.pth with a ResNet classifier
     body.fc.* added, plate.pt), converted to the JAX package's msgpack by
     `python -m video_desensitization_torch.models.convert` in a
     subprocess, then cli.main.build_engine from a config.ini naming them:
     fused from .pth/.pt, fused from msgpack, tiered from msgpack; two
     batches each: fused boxes and blurred frames equal to the main
     engine's, tiered boxes equal to the fused ones, 4 mosaic calls; the
     files' sizes, conversion and build times. It runs after yuv: a
     subprocess started once torch.profiler has run makes the profiler
     lose kernels in this process, and yuv is the last phase that holds
     the profiler's kernel count exactly;
  7. tiered: the CLI's default engine, the tiered pipeline (host letterbox,
     the detectors on the card, boxes-only readback, host cv2 mosaic), on
     the same detectors and on new 8x1080x1920 RGB batches: process_batch
     and process_stream give the same results, every blurred frame is the
     cv2 mosaic of the pipeline's own boxes, the kept boxes equal the fused
     engine's on the same batches, the mosaic kernel is launched 0 times;
     frames/s of both warm, in alternating windows, beside the fused
     engine's, stage times alone and inside a stream, bytes each way, the
     engine=auto link probe, and the same batches with transfer = yuv420;
  8. record: the record job's stages on the committed 1080p fixture
     (tests/fixtures/torch_record_1080p.record, LZ4 chunks): unpack, each
     camera stream checked byte for byte, then every stream through the
     tiered and the fused engine (process_single_video), every frame back,
     the kernel's calls counted; the CLI's whole record job (main([ini]),
     with the HEVC repack) only where the codec layer can encode HEVC,
     which is asked before anything runs, and the line says which;
  9. stream: the CLI (cli.main.main) at full width on a short synthetic
     1080p video: the fused engine with transfer = yuv420 and then rgb,
     then the CLI's default engine (no engine key: the tiered pipeline
     through process_stream); every frame back, the kernel's calls counted
     (0 on the default), and the codec path (native libav or cv2);
 10. tracked: keyframe tracking (TrackingEngine, interval 4, keyframe
     batches of 8) over the same engine on 64 1080p frames, RGB then I420:
     every frame back in order, 2 (RGB) and 4 (I420) kernel calls, each
     keyframe's detections equal to process_batch on the same keyframes
     and its pixels the plain mosaic of them followed by the host mosaic
     of its coasted boxes, each gap frame the cv2 mosaic of its raw frame
     under its own boxes, interval 1 equal to the engine; frames/s against
     the fused engine streamed two batches deep over the same frames, in
     alternating warm windows, and the host blur ms per gap frame;
 11. multicam: the record fixture's two camera streams co-batched
     (process_videos_cobatched) four ways -- fused RGB, fused yuv420,
     tiered, fused at detect_interval 4 -- every frame back per camera,
     the kernel's calls counted (4, 8, 0, 1), the per-camera counts and
     per-frame boxes equal to process_single_video's; the CLI's co-batched
     record job only where HEVC can be encoded;
 12. serve: the resident service (DesensitizationService) on the fused
     engine serving one 24-frame 1080p video job from an inbox with its
     .complete marker, /healthz and /status read while it runs, the
     journal line, the output's frames and 3 kernel calls; then
     cli.doctor.collect() on one line;
 13. train: RetinaFace training at full width (ResNet-50, 640, batch 32):
     a synthetic labelled set of 1080p JPEGs with a few faces each, the
     port's training CLI (cli.train) for 2 short epochs in bf16 with
     checkpoints, a resume and the msgpack export; ms per step and
     images/s on a resident batch in bf16 and float32 (median of 10
     synchronised steps after 3 warm-up ones) with the peak device memory
     of each and the model FLOPs of a step; the host ms per batch of
     batch_iterator; one float32 step (batch 2, TF32 off) on the card
     against the CPU from the same weights; 20 steps on one batch (the loss
     falls); the export loaded into the port's Retinaface on the card; the
     mosaic kernel launched 0 times;
 14. reference: the card against the CPU on the same weights in float32:
     both networks, then the rest of the engine's program (letterbox
     canvas, decode, NMS, inverse letterbox, box order);
 15. mesh: (a) after phase serve, the fused engine on make_mesh() over
     every card (1x1 on a machine with one) beside the single-device
     engine on the same RGB and I420 batches: frames bitwise equal, the
     same boxes kept, mosaic calls = cards x batches (RGB) and 2 x cards x
     batches (I420), frames/s of both; then, after phase train, two
     processes on cuda:0 over gloo (NCCL takes no two ranks on one card):
     (b) one float32 step (batch 2, TF32 off) at data 2 held against the
     single-process step of phase train (losses within 1e-5, BN statistics
     within 1e-5 + 1e-4 relative, the update no farther from the float64
     one than twice the single-process update); (c) the full-width bf16
     step at data 2 (batch 32, 16 a rank) timed beside phase train's
     (gloo stages its all-reduces through the host: not NVLink); (d) the
     step of (b) at model 2 (the >= 256-channel kernels split), held the
     same way; after MESH_EQUAL_STEPS steps of each every rank holds the
     same replicated parameters bit for bit. On a machine with several
     cards the trainer runs one process a card over NCCL instead, at data
     2 x model 2 (4 cards) or data 2 x model cards/2, and (c) at data =
     every card;
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
WEIGHTS_BATCHES = 2  # batches through each engine built from files in phase weights
TRACK_FRAMES, TRACK_INTERVAL, TRACK_WINDOWS = 64, 4, 3
TRACK_TIMED_FRAMES = 256  # 8 keyframe batches at interval 4 and batch 8
TRAIN_IMAGES, TRAIN_BATCH, TRAIN_INPUT = 64, 32, 640
TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS, OVERFIT_STEPS = 3, 10, 20
MESH_BATCHES = 3  # batches of each form in phase mesh, the first WARMUP_BATCHES run twice
MESH_WARMUP_STEPS, MESH_TIMED_STEPS = 2, 5  # a mesh step over gloo on one card takes ~1 s
MESH_RANK_TIMEOUT_S = 300
MESH_EQUAL_STEPS = 3  # float32 steps after which every rank's replicated parameters must agree
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


def phase_weights(main_engine, smi: str) -> dict:
    """Weights from files through the CLI's engine. The main engine's two
    networks, rebuilt in float32 on the CPU from the same seed
    (``main_path_engine``), are saved as reference-layout checkpoints --
    ``face.pth`` with a ResNet classifier ``body.fc.*`` added (dropped on
    load, as the JAX converter drops it) and ``plate.pt`` -- and converted
    by ``python -m video_desensitization_torch.models.convert`` in a
    subprocess. ``cli.main.build_engine`` then builds, with no random
    weights allowed, the fused engine from the ``.pth``/``.pt`` paths, the
    fused engine from the msgpack paths and the tiered pipeline from the
    msgpack paths. The config has no key for the plate detector's
    ``max_detections`` (64 in the CLI), so each built engine's is set to the
    main engine's 8. Each runs WEIGHTS_BATCHES batches: the fused engines
    keep the main engine's boxes and give its blurred frames bit for bit,
    the tiered one keeps the fused boxes (as phase tiered checks), and the
    mosaic kernel is launched once a batch by each fused engine and never
    by the tiered one. The main engine's own results come first, before
    the launch count is reset."""
    import tempfile

    import numpy as np
    import torch

    from video_desensitization_torch.api.config import load_config
    from video_desensitization_torch.bench_util import main_path_engine
    from video_desensitization_torch.cli.main import build_engine
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.pipeline.throughput import TieredPipeline

    t_phase = time.perf_counter()
    rng = np.random.default_rng(9)
    batches = [
        rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
        for _ in range(WEIGHTS_BATCHES)
    ]
    want = [main_engine.process_batch(frames) for frames in batches]
    sizes, convert_s, build_s = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ref = main_path_engine(device="cpu", dtype=torch.float32)
        face_sd = dict(ref.face.net.state_dict())
        gen = torch.Generator().manual_seed(1)
        face_sd["body.fc.weight"] = torch.randn(1000, 2048, generator=gen) * 0.01
        face_sd["body.fc.bias"] = torch.zeros(1000)
        checkpoints = {"face": (f"{tmp}/face.pth", face_sd, "retinaface"),
                       "plate": (f"{tmp}/plate.pt", ref.plate.net.state_dict(), "yolo")}
        del ref
        for name, (src, state, arch) in checkpoints.items():
            torch.save(state, src)
            dst = f"{tmp}/{name}.msgpack"
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "video_desensitization_torch.models.convert", src, dst,
                 "--arch", arch],
                cwd=REPO, capture_output=True, text=True, timeout=600,
            )
            convert_s[name] = time.perf_counter() - t0
            check(out.returncode == 0, f"converting {src} failed: {out.stderr[-2000:]}")
            check(out.stdout.startswith(f"wrote {dst}: "), f"converter said {out.stdout!r}")
            sizes[name] = (os.path.getsize(src), os.path.getsize(dst))

        configs = [
            ("fused .pth/.pt", "fused", f"{tmp}/face.pth", f"{tmp}/plate.pt"),
            ("fused msgpack", "fused", f"{tmp}/face.msgpack", f"{tmp}/plate.msgpack"),
            ("tiered msgpack", "tiered", f"{tmp}/face.msgpack", f"{tmp}/plate.msgpack"),
        ]
        engines = []
        for i, (name, mode, face_path, plate_path) in enumerate(configs):
            ini = f"{tmp}/{i}.ini"
            with open(ini, "w") as f:
                f.write(
                    f"[PATHS]\nmodel_path={face_path}\nmodel_weights={plate_path}\n"
                    f"[SETTINGS]\nbatch_size={BATCH}\n[TPU]\nengine={mode}\ndtype=bfloat16\n"
                    f"input_size=640\nmax_detections={main_engine.face.max_detections}\n"
                    f"nms_iou={main_engine.face.nms_iou}\nmosaic_level={main_engine.mosaic_level}\n"
                )
            t0 = time.perf_counter()
            engine = build_engine(load_config(ini, strict=False))  # no record job: no [PATHS] dirs
            torch.cuda.synchronize()
            build_s[name] = time.perf_counter() - t0
            check(isinstance(engine, TieredPipeline) == (mode == "tiered"), f"{name}: wrong engine")
            engine.plate.max_detections = main_engine.plate.max_detections
            engines.append((name, engine))

    cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
    results = {name: [engine.process_batch(frames) for frames in batches]
               for name, engine in engines}
    launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    fused = ["fused .pth/.pt", "fused msgpack"]
    check(launches == len(fused) * WEIGHTS_BATCHES,
          f"mosaic kernel launched {launches}x, not once a batch by each fused engine")
    n_boxes, box_err = 0, 0.0
    for j, main_res in enumerate(want):
        for name in fused:
            res = results[name][j]
            check(res.face_boxes == main_res.face_boxes and res.plate_boxes == main_res.plate_boxes,
                  f"{name}: kept boxes differ from the main engine's")
            check(np.array_equal(res.frames, main_res.frames),
                  f"{name}: blurred frames differ from the main engine's")
        tiered = results["tiered msgpack"][j]
        for a, b in zip(tiered.face_boxes + tiered.plate_boxes,
                        main_res.face_boxes + main_res.plate_boxes):
            check(len(a) == len(b), "the tiered engine kept other boxes than the fused ones")
            n_boxes += len(a)
            if a:
                box_err = max(box_err, float(np.abs(np.asarray(a) - np.asarray(b)).max()))
    check(box_err <= 1e-3, f"tiered boxes differ from the fused ones by {box_err} px")
    print(
        f"phase weights: {smi} | face.pth {sizes['face'][0]} bytes (body.fc.* added) -> "
        f"face.msgpack {sizes['face'][1]} bytes in {convert_s['face']:.2f} s, plate.pt "
        f"{sizes['plate'][0]} bytes -> plate.msgpack {sizes['plate'][1]} bytes in "
        f"{convert_s['plate']:.2f} s (the converter subprocess's wall time); build_engine: "
        + ", ".join(f"{name} {s:.2f} s" for name, s in build_s.items())
        + f"; {WEIGHTS_BATCHES}x{BATCH}x{HEIGHT}x{WIDTH} RGB each: fused engines' boxes and "
        f"blurred frames == the main engine's, tiered boxes == fused (within {box_err:.2e} px), "
        f"{n_boxes / (WEIGHTS_BATCHES * BATCH):.2f} boxes/frame, mosaic launches {launches} | "
        f"{time.perf_counter() - t_phase:.1f} s",
        flush=True,
    )
    return {"launches": launches}


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


def write_stream_video(path: str) -> str:
    """The stream and serve phases' input: STREAM_FRAMES 1080p frames of
    8x8-pixel random blocks from seed 5, mpeg4."""
    import numpy as np

    from video_desensitization_torch.video import av

    rng = np.random.default_rng(5)
    with av.VideoEncoder(path, WIDTH, HEIGHT, fps=24, codec="mpeg4") as enc:
        for _ in range(STREAM_FRAMES):
            coarse = rng.integers(0, 256, (HEIGHT // 8, WIDTH // 8, 3), dtype=np.uint8)
            enc.write(coarse.repeat(8, axis=0).repeat(8, axis=1))
    return path


def phase_stream() -> dict:
    """``cli.main.main`` on a short synthetic 1080p video at full width:
    the fused engine with transfer = yuv420, then rgb, then a config with no
    ``engine`` or ``transfer`` key, so the CLI takes its default (the tiered
    pipeline on rgb, through ``process_stream``), then that config with
    ``detect_interval = 4`` (``build_engine`` wraps the tiered pipeline in
    ``TrackingEngine``, whose ``process_stream`` the stream job takes). Its
    frames/s is the CLI's wall time (engine build and codec included) and
    is bound by the codec, not the card."""
    import tempfile

    from video_desensitization_torch.cli.main import main as cli_main
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.pipeline.throughput import TieredPipeline
    from video_desensitization_torch.pipeline.tracking import TrackingEngine
    from video_desensitization_torch.video import av

    batches = -(-STREAM_FRAMES // BATCH)
    streams = {TieredPipeline: [], TrackingEngine: []}
    stream_of = {cls: cls.process_stream for cls in streams}

    def counting(cls):
        def counted_stream(self, *args, **kwargs):
            streams[cls].append(self)
            return stream_of[cls](self, *args, **kwargs)
        return counted_stream

    parts = []
    with tempfile.TemporaryDirectory() as tmp:
        src = write_stream_video(f"{tmp}/in.mp4")
        # (name, [TPU] keys, mosaic kernel calls a batch, tiered streams,
        # tracked streams over the tiered pipeline)
        passes = [
            ("fused yuv420", "engine=fused\ntransfer=yuv420\n", 2, 0, 0),
            ("fused rgb", "engine=fused\ntransfer=rgb\n", 1, 0, 0),
            ("default (tiered rgb)", "", 0, 1, 0),
            (f"default, detect_interval {TRACK_INTERVAL} (tracked tiered rgb)",
             f"detect_interval={TRACK_INTERVAL}\n", 0, 0, 1),
        ]
        for i, (name, keys, per_batch, n_tiered, n_tracked) in enumerate(passes):
            ini = f"{tmp}/{i}.ini"
            with open(ini, "w") as f:
                f.write(
                    "[PATHS]\nmodel_path=\nmodel_weights=\n[SETTINGS]\nbatch_size=8\n"
                    f"[TPU]\n{keys}dtype=bfloat16\ninput_size=640\nmax_detections=16\n"
                    "mosaic_level=8\n"
                )
            out = f"{tmp}/out_{i}.mp4"
            cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
            for cls, seen in streams.items():
                seen.clear()
                cls.process_stream = counting(cls)
            try:
                t0 = time.perf_counter()
                rc = cli_main([ini, "--video", src, "--out", out, "--allow-random-weights"])
                seconds = time.perf_counter() - t0
            finally:
                for cls in streams:
                    cls.process_stream = stream_of[cls]
            launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
            check(rc == 0, f"{name}: CLI returned {rc}")
            check(launches == per_batch * batches,
                  f"{name}: mosaic kernel called {launches}x in {batches} batches")
            tiered, tracked = streams[TieredPipeline], streams[TrackingEngine]
            check(len(tiered) == n_tiered and all(s.transfer == "rgb" for s in tiered),
                  f"{name}: {len(tiered)} tiered rgb streams ran, not {n_tiered}")
            check(len(tracked) == n_tracked and all(
                isinstance(s.base, TieredPipeline) and s.base.transfer == "rgb"
                and s.interval == TRACK_INTERVAL and s.detect_batch == BATCH for s in tracked),
                f"{name}: {len(tracked)} tracked tiered rgb streams ran, not {n_tracked}")
            with av.VideoDecoder(out) as dec:
                frames = [f.shape for f in dec]
            check(frames == [(HEIGHT, WIDTH, 3)] * STREAM_FRAMES,
                  f"{name}: {len(frames)} of {STREAM_FRAMES} frames back")
            parts.append(
                f"{name}: {STREAM_FRAMES} frames back, mosaic calls {launches} in {batches} "
                f"batches, tiered process_stream runs {len(tiered)}, tracked {len(tracked)}, "
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


def fused_stream(engine, batches, depth: int = 2) -> list:
    """The fused engine over ``batches`` as the stream job drives it:
    ``depth`` batches in flight through dispatch_batch / finalize_batch,
    results held."""
    from collections import deque

    pending, out = deque(), []
    for frames in batches:
        pending.append(engine.dispatch_batch(frames))
        if len(pending) > depth:
            out.append(engine.finalize_batch(pending.popleft()))
    while pending:
        out.append(engine.finalize_batch(pending.popleft()))
    return out


def check_tracked(engine, raw, results) -> dict:
    """A tracked stream's results against its raw frames: the keyframes'
    detections equal to ``engine.process_batch`` on the same keyframes
    (0 px); each keyframe the plain mosaic of those boxes (on the card for
    the fused engine, cv2 for the tiered pipeline, whose mosaic is cv2)
    followed by the cv2 mosaic of its coasted boxes; each gap frame the cv2
    mosaic of its raw frame under its own boxes. Returns box counts."""
    import numpy as np
    import torch

    from video_desensitization_torch.ops.mosaic import mosaic_boxes_batch_, mosaic_i420_batch
    from video_desensitization_torch.pipeline.tracking import blur_host_inplace

    level = engine.mosaic_level
    yuv = raw.ndim == 3
    fused = hasattr(engine, "process_batch_yuv")
    check(len(results) == len(raw), f"{len(results)} results for {len(raw)} frames")
    kf_idx = list(range(0, len(raw), TRACK_INTERVAL))
    coasted = gap_boxes = 0
    for start in range(0, len(kf_idx), BATCH):
        idx = kf_idx[start : start + BATCH]
        frames = raw[idx]
        base = engine.process_batch_yuv(frames) if yuv else engine.process_batch(frames)
        if fused:
            dev_boxes, dev_valid = kept_boxes(base, len(idx))
            dev = torch.from_numpy(frames).cuda()
            plain = (mosaic_i420_batch(dev, dev_boxes, dev_valid, level) if yuv
                     else mosaic_boxes_batch_(dev, dev_boxes, dev_valid, level)).cpu().numpy()
        else:
            plain = frames.copy()
            for j in range(len(idx)):
                blur_host_inplace(plain[j], base.face_boxes[j] + base.plate_boxes[j], level)
        for j, i in enumerate(idx):
            r = results[i]
            nf, np_ = len(base.face_boxes[j]), len(base.plate_boxes[j])
            check(r.face_boxes[0][:nf] == base.face_boxes[j]
                  and r.plate_boxes[0][:np_] == base.plate_boxes[j],
                  f"keyframe {i}: detections differ from process_batch")
            coast = r.face_boxes[0][nf:] + r.plate_boxes[0][np_:]
            coasted += len(coast)
            want = plain[j].copy()
            blur_host_inplace(want, coast, level)
            check(np.array_equal(r.frames[0], want),
                  f"keyframe {i} != plain mosaic of its boxes + host mosaic of its coasted boxes")
    for i in range(len(raw)):
        if i % TRACK_INTERVAL:
            r = results[i]
            boxes = r.face_boxes[0] + r.plate_boxes[0]
            gap_boxes += len(boxes)
            want = raw[i].copy()
            blur_host_inplace(want, boxes, level)
            check(r.frames.shape == (1, *raw.shape[1:]) and np.array_equal(r.frames[0], want),
                  f"gap frame {i} != cv2 mosaic of its raw frame under its boxes")
    n_gap = len(raw) - len(kf_idx)
    return {"coasted_per_kf": coasted / len(kf_idx), "boxes_per_gap": gap_boxes / n_gap}


def phase_tracked(engine) -> dict:
    """Keyframe tracking over the fused engine at full width, on RGB and
    I420 frames, and over the tiered pipeline on the same detectors (the
    CLI's default engine) on RGB. The tracked stream blurs gap frames in
    place in the batches it is given, so each run gets a copy and the raw
    frames stay for the checks."""
    import numpy as np

    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.pipeline import tracking
    from video_desensitization_torch.pipeline.throughput import TieredPipeline

    rng = np.random.default_rng(8)
    raw = {
        "rgb": rng.integers(0, 256, (TRACK_FRAMES, HEIGHT, WIDTH, 3), dtype=np.uint8),
        "i420": rng.integers(0, 256, (TRACK_FRAMES, HEIGHT * 3 // 2, WIDTH), dtype=np.uint8),
    }
    tiered = TieredPipeline(engine.face, engine.plate, mosaic_level=engine.mosaic_level)

    def batches_of(frames):
        return [frames[i : i + BATCH] for i in range(0, len(frames), BATCH)]

    def tracked(frames, interval=TRACK_INTERVAL, base=engine):
        eng = tracking.TrackingEngine(base, interval=interval, detect_batch=BATCH)
        return list(eng.process_stream(iter(batches_of(frames))))

    launches, stats, parts = {}, {}, []
    # (name, base engine, frames, kernel calls per keyframe batch)
    runs = [("rgb", engine, raw["rgb"], 1), ("i420", engine, raw["i420"], 2),
            ("tiered rgb", tiered, raw["rgb"], 0)]
    for mode, base, frames, per_batch in runs:
        cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
        results = tracked(frames.copy(), base=base)
        launches[mode] = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
        want = (TRACK_FRAMES // TRACK_INTERVAL // BATCH) * per_batch
        check(launches[mode] == want, f"{mode}: mosaic kernel called {launches[mode]}x, not {want}")
        stats[mode] = check_tracked(base, frames, results)
        same = tracked(frames.copy(), interval=1, base=base)
        process = base.process_batch_yuv if mode == "i420" else base.process_batch
        for got, b in zip(same, batches_of(frames)):
            res = process(b)
            check(np.array_equal(got.frames, res.frames) and got.face_boxes == res.face_boxes
                  and got.plate_boxes == res.plate_boxes, f"{mode}: interval 1 != the engine")
        parts.append(f"{mode}: {TRACK_FRAMES} frames back in order, mosaic calls {launches[mode]}, "
                     f"{stats[mode]['coasted_per_kf']:.2f} coasted boxes a keyframe, "
                     f"{stats[mode]['boxes_per_gap']:.2f} boxes a gap frame")
        del results, same

    # Host blur of a gap frame alone: each RGB gap frame under its boxes.
    results = tracked(raw["rgb"].copy())
    blur_ms = []
    for i in range(TRACK_FRAMES):
        if i % TRACK_INTERVAL:
            frame = raw["rgb"][i].copy()
            boxes = results[i].face_boxes[0] + results[i].plate_boxes[0]
            t0 = time.perf_counter()
            tracking.blur_host_inplace(frame, boxes, engine.mosaic_level)
            blur_ms.append((time.perf_counter() - t0) * 1e3)
    del results

    # Timed windows over TRACK_TIMED_FRAMES frames: TRACK_TIMED_FRAMES /
    # TRACK_INTERVAL / BATCH keyframe batches, most of them beyond the
    # tracked stream's DEPTH in flight, so the windows see its steady state
    # and not only its fill and drain. Each tracked window gets a fresh copy
    # of the raw frames, made outside its clock. The third stream is a
    # diagnostic: the tracked stream with the host blur skipped (its frames
    # are not desensitized), so the difference is the blur's share.
    timed = np.random.default_rng(9).integers(
        0, 256, (TRACK_TIMED_FRAMES, HEIGHT, WIDTH, 3), dtype=np.uint8)
    blur = tracking.blur_host_inplace
    fps = {"fused": [], "tracked": [], "no blur": []}
    for _ in range(TRACK_WINDOWS):
        t0 = time.perf_counter()
        held = fused_stream(engine, batches_of(timed))
        fps["fused"].append(TRACK_TIMED_FRAMES / (time.perf_counter() - t0))
        del held
        for name in ("tracked", "no blur"):
            work = timed.copy()
            tracking.blur_host_inplace = blur if name == "tracked" else (lambda *a: None)
            try:
                t0 = time.perf_counter()
                held = tracked(work)
                fps[name].append(TRACK_TIMED_FRAMES / (time.perf_counter() - t0))
            finally:
                tracking.blur_host_inplace = blur
            check(len(held) == TRACK_TIMED_FRAMES, f"{name}: {len(held)} results")
            del held, work
    med = {name: statistics.median(v) for name, v in fps.items()}
    print(
        f"phase tracked: TrackingEngine(interval {TRACK_INTERVAL}, detect_batch {BATCH}, "
        f"{tracking.DEPTH} keyframe batches in flight, {tracking.BLUR_WORKERS} blur threads) over "
        f"resnet50+yolov8n 640 bf16 on {TRACK_FRAMES}x{HEIGHT}x{WIDTH} | " + " | ".join(parts)
        + f" | keyframe detections == process_batch (0 px), keyframes == plain mosaic + host "
        f"mosaic of coasted boxes, gap frames == cv2 mosaic of their boxes, interval 1 == the "
        f"engine, on all three | RGB, {TRACK_TIMED_FRAMES} frames "
        f"({TRACK_TIMED_FRAMES // TRACK_INTERVAL // BATCH} keyframe batches), results held, "
        f"median of {TRACK_WINDOWS} alternating warm windows: tracked stream "
        f"{med['tracked']:.2f} frames/s {fmt(fps['tracked'])}, fused engine streamed 2 batches "
        f"deep {med['fused']:.2f} {fmt(fps['fused'])}, tracked with the host blur skipped "
        f"(diagnostic, frames not desensitized) {med['no blur']:.2f} {fmt(fps['no blur'])}; host "
        f"blur of one gap frame {statistics.median(blur_ms):.3f} ms (median, cv2 mosaic on one "
        f"thread)",
        flush=True,
    )
    return {"launches": launches, "fps": med["tracked"], "fused_fps": med["fused"],
            "blur_ms": statistics.median(blur_ms)}


class BoxRecorder:
    """An engine's stand-in that keeps each finalized frame's boxes (faces
    then plates) under a hash of the frame it was given. dispatch_batch and
    finalize_batch may run on two threads; their FIFO order pairs them."""

    def __init__(self, engine):
        from collections import deque

        self.engine, self.boxes, self._keys = engine, {}, deque()

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def dispatch_batch(self, frames):
        import hashlib

        self._keys.append([hashlib.blake2b(f.tobytes(), digest_size=16).digest() for f in frames])
        return self.engine.dispatch_batch(frames)

    def finalize_batch(self, handle):
        res = self.engine.finalize_batch(handle)
        for key, fb, pb in zip(self._keys.popleft(), res.face_boxes, res.plate_boxes):
            self.boxes[key] = fb + pb
        return res


def phase_multicam(engine) -> dict:
    """process_videos_cobatched on the two camera streams of the record
    fixture, four ways, against process_single_video on the same streams."""
    import shutil
    import tempfile

    import numpy as np

    from video_desensitization_torch.cli.main import main as cli_main
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.pipeline.multicam import process_videos_cobatched
    from video_desensitization_torch.pipeline.throughput import TieredPipeline
    from video_desensitization_torch.pipeline.video_pipeline import process_single_video
    from video_desensitization_torch.record.unpack import read_record2h265_all
    from video_desensitization_torch.video import av

    hevc_encoder = av.native_available()
    tiered = TieredPipeline(engine.face, engine.plate, mosaic_level=engine.mosaic_level)
    parts, launches = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/in")
        fixture = shutil.copy(RECORD_FIXTURE, f"{tmp}/in")
        streams = read_record2h265_all(fixture, f"{tmp}/h265")
        cams = {os.path.splitext(os.path.basename(p))[0]: p for p in streams.values()}
        # Each stream alone through process_single_video, per transport:
        # the yuv420 runs' detectors see the I420 frames' RGB, not the
        # decoded RGB, so each co-batched run is held against its own.
        single = BoxRecorder(engine)
        counts = {"rgb": {}, "yuv420": {}}
        for transport, eng in (("rgb", single), ("yuv420", engine)):
            for cam, path in cams.items():
                res = process_single_video(path, f"{tmp}/single_{transport}", eng,
                                           batch_size=BATCH, output_ext=".mp4",
                                           transport=transport)
                check(res.success, f"process_single_video failed on {cam} ({transport})")
                counts[transport][cam] = res
        # (name, engine, transport, detect_interval, kernel calls)
        runs = [("fused rgb", BoxRecorder(engine), "rgb", 1, 4),
                ("fused yuv420", engine, "yuv420", 1, 8),
                ("tiered", tiered, "rgb", 1, 0),
                (f"fused interval {TRACK_INTERVAL}", engine, "rgb", TRACK_INTERVAL, 1)]
        box_err = box_excess = 0.0
        for k, (name, eng, transport, interval, want) in enumerate(runs):
            jobs = {cam: (path, f"{tmp}/run{k}/{cam}_processed.mp4") for cam, path in cams.items()}
            os.makedirs(f"{tmp}/run{k}")
            cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
            t0 = time.perf_counter()
            stats = process_videos_cobatched(jobs, eng, batch_size=BATCH, transport=transport,
                                             detect_interval=interval)
            seconds = time.perf_counter() - t0
            launches[name] = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
            check(launches[name] == want,
                  f"multicam {name}: mosaic kernel called {launches[name]}x, not {want}")
            for cam, (_, out) in jobs.items():
                st = stats[cam]
                check(st.error is None, f"multicam {name}: camera {cam} failed: {st.error}")
                alone = counts[transport][cam]
                with av.VideoDecoder(out) as dec:
                    shapes = [f.shape for f in dec]
                check(st.frames == alone.frames and shapes == [(HEIGHT, WIDTH, 3)] * alone.frames,
                      f"multicam {name}: {st.frames} frames, {len(shapes)} decoded of "
                      f"{alone.frames} for {cam}")
                if interval == 1:
                    check((st.faces, st.plates) == (alone.faces, alone.plates),
                          f"multicam {name}: {cam} counts {(st.faces, st.plates)} != "
                          f"process_single_video's {(alone.faces, alone.plates)}")
            if isinstance(eng, BoxRecorder):
                check(set(eng.boxes) == set(single.boxes), "multicam saw other frames")
                for key, want_boxes in single.boxes.items():
                    got = eng.boxes[key]
                    check(len(got) == len(want_boxes), "batch mates changed a frame's box count")
                    if got:
                        a, b = np.asarray(got), np.asarray(want_boxes)
                        box_err = max(box_err, float(np.abs(a - b).max()))
                        # Random weights put box edges far outside the frame,
                        # where a float32 ulp exceeds 1e-3 px: the tolerance
                        # is phase reference's, 1e-3 px + 1e-5 of the value.
                        box_excess = max(box_excess, float((np.abs(a - b) - 1e-5 * np.abs(b)).max()))
                check(box_excess <= 1e-3, f"batch mates moved a box by {box_err} px")
            parts.append(f"{name}: {sum(s.frames for s in stats.values())} frames back "
                         f"({', '.join(f'{c} {s.frames}' for c, s in stats.items())}), "
                         f"{sum(s.faces + s.plates for s in stats.values())} boxes, "
                         f"mosaic calls {launches[name]}, {seconds:.2f} s")
        parts.append(f"counts at interval 1 == process_single_video's on the same transport; "
                     f"per-frame boxes of "
                     f"fused rgb within {box_err:.2e} px of it (limit 1e-3 px + 1e-5 of the "
                     f"coordinate)")
        if hevc_encoder:
            job = f"{tmp}/job"
            ini = f"{tmp}/job.ini"
            with open(ini, "w") as f:
                f.write(
                    f"[PATHS]\nmodel_path=random\nmodel_weights=random\nrecord_dir={fixture}\n"
                    f"output_h265_dir={job}/h265\noutput_videos_dir={job}/videos\n"
                    f"temp_directory_base={job}/tmp\nrecord_output_dir={job}/out\n"
                    "[SETTINGS]\nbatch_size=8\n[TPU]\nmax_detections=16\nmosaic_level=8\n"
                    "co_batch=true\n"
                )
            check(cli_main([ini]) == 0, "the CLI's co-batched record job failed")
            record = check_final_record(fixture, f"{job}/out/{os.path.basename(fixture)}")
            parts.append(f"co-batched record job end to end (main([ini])): {record} messages")
        else:
            parts.append("co-batched record job end to end: not run, codec cv2 has no HEVC "
                         "encoder; held on the CPU by tests/test_torch_multicam.py")
    print(f"phase multicam: {len(cams)} streams of {RECORD_FIXTURE.relative_to(REPO)}, batch "
          f"{BATCH}, .mp4 outputs | " + " | ".join(parts), flush=True)
    return {"launches": launches}


def phase_serve(engine) -> dict:
    """The resident service on the fused engine: one video job."""
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    from video_desensitization_torch.api.config import PipelineConfig
    from video_desensitization_torch.cli import doctor
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.pipeline.service import (
        JOURNAL_NAME,
        DesensitizationService,
        ServiceConfig,
    )
    from video_desensitization_torch.video import av

    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/inbox")
        write_stream_video(f"{tmp}/inbox/in.mp4")
        open(f"{tmp}/inbox/in.mp4.complete", "w").close()
        svc = DesensitizationService(
            ServiceConfig(inbox_dir=f"{tmp}/inbox", output_dir=f"{tmp}/out",
                          poll_interval_s=0.1, http_port=0),
            PipelineConfig(batch_size=BATCH), engine,
        )
        base = f"http://127.0.0.1:{svc.http_port}"
        cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
        handled = []
        t0 = time.perf_counter()
        worker = threading.Thread(target=lambda: handled.append(svc.run(max_jobs=1)), daemon=True)
        worker.start()
        healthz, busy = None, False
        while worker.is_alive():
            try:
                healthz = urllib.request.urlopen(f"{base}/healthz", timeout=5).read()
                status = json.loads(urllib.request.urlopen(f"{base}/status", timeout=5).read())
            except (urllib.error.URLError, ConnectionError):
                break  # the job finished and the endpoint shut down
            busy |= status["current"] == "in.mp4"
            if busy:
                break
            time.sleep(0.02)
        worker.join(timeout=600)
        seconds = time.perf_counter() - t0
        launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
        check(handled == [1], f"the service handled {handled} jobs, not 1")
        check(healthz == b"ok\n" and busy, f"/healthz {healthz!r}, /status busy with the job {busy}")
        with open(f"{tmp}/out/{JOURNAL_NAME}") as f:
            journal = [json.loads(line) for line in f]
        check(len(journal) == 1 and journal[0]["ok"] and journal[0]["frames"] == STREAM_FRAMES,
              f"journal {journal}")
        with av.VideoDecoder(f"{tmp}/out/in_processed.mp4") as dec:
            frames = [f.shape for f in dec]
        check(frames == [(HEIGHT, WIDTH, 3)] * STREAM_FRAMES, f"{len(frames)} frames back")
        want = -(-STREAM_FRAMES // BATCH)
        check(launches == want, f"service: mosaic kernel called {launches}x, not {want}")
        check(os.path.exists(f"{tmp}/inbox/.done/in.mp4"), "input not archived")
    print(f"phase serve: DesensitizationService on the resident fused engine, one "
          f"{STREAM_FRAMES}-frame 1080p video job with its .complete marker: /healthz ok and "
          f"/status busy with the job while it ran, journal ok with {journal[0]['frames']} "
          f"frames and {journal[0]['faces'] + journal[0]['plates']} boxes, {len(frames)} frames "
          f"back, mosaic calls {launches}, {seconds:.2f} s from run() to its end (poll, claim, "
          f"decode, engine, encode; codec-bound)", flush=True)
    print("phase serve: doctor " + json.dumps(doctor.collect()), flush=True)
    return {"launches": launches}


def write_train_set(root: str, n: int) -> None:
    """n 1080p JPEGs of smooth noise, each with 2-4 bright square "faces"
    (60-300 px, every other one with 5 landmarks), and their label.txt."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(7)
    lines = []
    for i in range(n):
        img = cv2.resize(rng.integers(0, 256, (HEIGHT // 16, WIDTH // 16, 3), dtype=np.uint8),
                         (WIDTH, HEIGHT))
        lines.append(f"# im{i:03d}.jpg")
        for j in range(int(rng.integers(2, 5))):
            s = int(rng.integers(HEIGHT // 18, HEIGHT * 5 // 18))
            x, y = int(rng.integers(0, WIDTH - s)), int(rng.integers(0, HEIGHT - s))
            img[y:y + s, x:x + s] = rng.integers(180, 256, 3)
            row = f"{x} {y} {s} {s}"
            if j % 2 == 0:
                pts = ((0.3, 0.35), (0.7, 0.35), (0.5, 0.55), (0.35, 0.75), (0.65, 0.75))
                row += "".join(f" {x + a * s:.1f} {y + b * s:.1f} 0.0" for a, b in pts) + " 0.9"
            lines.append(row)
        cv2.imwrite(os.path.join(root, f"im{i:03d}.jpg"), img)
    with open(os.path.join(root, "label.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def train_step_ms(state, step_fn, batch, warmup: int = TRAIN_WARMUP_STEPS,
                  timed: int = TRAIN_TIMED_STEPS) -> float:
    """Median ms of ``timed`` synchronised steps on ``batch`` after
    ``warmup`` warm-up ones."""
    import torch

    for _ in range(warmup):
        step_fn(state, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


TRAIN_KERNEL_CLASSES = (
    ("collective", ("nccl",)),
    ("conv", ("conv", "xmma", "implicit", "gemm", "cutlass", "cudnn", "sm90", "wgrad", "dgrad")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("reduction", ("reduce",)),
    ("sort", ("sort", "radix", "scan")),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def train_step_profile(state, step_fn, batch, steps: int = 3) -> dict:
    """torch.profiler over ``steps`` train steps: the device time a step
    (the kernels' own times summed: one stream, so no overlap, but for
    NCCL's collectives on a mesh, which run on a stream of their own), CUDA
    kernels a step, and the device time of each class of kernel by name
    (TRAIN_KERNEL_CLASSES, first match; the rest "other")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from video_desensitization_torch.bench_util import device_time_us

    step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step_fn(state, batch)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    classes = {name: 0.0 for name, _ in TRAIN_KERNEL_CLASSES}
    classes["other"] = 0.0
    kernels = 0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != cuda:
            continue
        key = evt.key.lower()
        kernels += evt.count
        name = next((n for n, words in TRAIN_KERNEL_CLASSES if any(w in key for w in words)),
                    "other")
        classes[name] += device_time_us(evt) / 1e3 / steps
    return {"device_ms": sum(classes.values()), "kernels": kernels / steps, "classes": classes}


def data_stage_ms(labels, root, anchors, n: int = 8) -> dict:
    """Median host ms per image of the data path's stages over n images:
    JPEG decode (cv2.imread + BGR -> RGB), letterbox and mean subtraction,
    and anchor matching on the card (TargetEncoder, one sync an image)."""
    import cv2
    import numpy as np

    from video_desensitization_torch.ops.image import BGR_MEAN
    from video_desensitization_torch.pipeline.throughput import letterbox_u8
    from video_desensitization_torch.train.data import TargetEncoder, _letterbox_annotations

    hw = (TRAIN_INPUT, TRAIN_INPUT)
    encoder = TargetEncoder(anchors, device="cuda")
    times = {"decode": [], "letterbox": [], "match": []}
    for key in sorted(labels)[:n]:
        t0 = time.perf_counter()
        img = cv2.cvtColor(cv2.imread(os.path.join(root, key)), cv2.COLOR_BGR2RGB)
        t1 = time.perf_counter()
        letterbox_u8(img, hw).astype(np.float32) - np.asarray(BGR_MEAN, np.float32)
        t2 = time.perf_counter()
        encoder(_letterbox_annotations(labels[key], img.shape[:2], hw))
        t3 = time.perf_counter()
        for name, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
            times[name].append(dt * 1e3)
    return {name: statistics.median(v) for name, v in times.items()}


def fresh_train_state(device, warmup_steps: int = 0, seed: int = 0, mesh=None):
    """ResNet-50 RetinaFace, random weights from ``seed``, under the CLI's
    SGD (momentum 0.9, weight decay 5e-4) at its lr 1e-3 after
    ``warmup_steps`` of linear warmup; on ``mesh``, this rank's layout."""
    lr = 1e-3
    import torch

    from video_desensitization_torch.models.common import load_weights
    from video_desensitization_torch.models.configs import cfg_re50
    from video_desensitization_torch.models.retinaface import RetinaFace
    from video_desensitization_torch.parallel.tensor import shard_model
    from video_desensitization_torch.train.data import multistep_lr
    from video_desensitization_torch.train.step import create_train_state

    model = RetinaFace(cfg_re50, mode="train")
    load_weights(model, None, None, seed)
    if mesh is not None:
        shard_model(model, mesh)
    optimizer = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9, weight_decay=5e-4)
    return create_train_state(model, optimizer, multistep_lr(lr, [], warmup_steps=warmup_steps),
                              device=device, mesh=mesh)


def phase_train(smi: str) -> dict:
    """RetinaFace training on the card at full width; see the module
    docstring. Prints a line for each part as it ends. Returns the mosaic
    kernel's launch count in the phase (0)."""
    import tempfile

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from video_desensitization_torch.cli.train import parse_args, train
    from video_desensitization_torch.detect.face import Retinaface
    from video_desensitization_torch.models.configs import cfg_re50
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.ops.anchors import generate_anchors
    from video_desensitization_torch.train.data import batch_iterator, load_retinaface_labels
    from video_desensitization_torch.train.step import make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
    hw = (TRAIN_INPUT, TRAIN_INPUT)
    anchors = generate_anchors(hw, cfg_re50["min_sizes"], cfg_re50["steps"])
    steps_per_epoch = TRAIN_IMAGES // TRAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the labelled set, (b) the CLI: one epoch with a checkpoint,
        # then a resume to epoch 2 with the export
        t0 = time.perf_counter()
        write_train_set(tmp, TRAIN_IMAGES)
        labels = load_retinaface_labels(os.path.join(tmp, "label.txt"))
        set_s = time.perf_counter() - t0
        export = os.path.join(tmp, "face.msgpack")
        argv = ["--labels", os.path.join(tmp, "label.txt"), "--images", tmp,
                "--backbone", "resnet50", "--input-size", str(TRAIN_INPUT),
                "--batch-size", str(TRAIN_BATCH), "--compute-dtype", "bfloat16",
                "--log-every", "1", "--ckpt-dir", os.path.join(tmp, "ck")]
        t0 = time.perf_counter()
        first = train(parse_args(argv + ["--epochs", "1"]))
        state = train(parse_args(argv + ["--epochs", "2", "--export", export,
                                         "--resume", os.path.join(tmp, "ck", "ep0001")]))
        cli_s = time.perf_counter() - t0
        check(first.step == steps_per_epoch and state.step == 2 * steps_per_epoch,
              f"CLI steps {first.step}, {state.step}")
        check(sorted(os.listdir(os.path.join(tmp, "ck"))) == ["ep0001", "ep0002"], "checkpoints")
        check(os.path.getsize(export) > 0, "no export")
        del first, state
        print(f"phase train: {smi} | RetinaFace-ResNet50 {TRAIN_INPUT}x{TRAIN_INPUT}, batch "
              f"{TRAIN_BATCH} | {TRAIN_IMAGES} 1080p JPEGs with "
              f"{sum(len(v) for v in labels.values())} faces written in {set_s:.2f} s | the CLI, "
              f"bf16, one epoch with a checkpoint then a resume to epoch 2 with the msgpack "
              f"export: {2 * steps_per_epoch} steps in {cli_s:.2f} s (two model builds and "
              f"inits included)", flush=True)

        # (c) host ms per batch, then the step on a resident batch in bf16 and float32
        t0 = time.perf_counter()
        batches = list(batch_iterator(labels, tmp, hw, anchors, batch_size=TRAIN_BATCH,
                                      shuffle=True, seed=0, device="cuda"))
        host_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        check(len(batches) == steps_per_epoch, f"{len(batches)} batches")
        batch = {k: torch.as_tensor(v).cuda() for k, v in batches[0].items()}
        timing = {}
        for name, dtype in (("bf16", torch.bfloat16), ("float32", torch.float32)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            st = fresh_train_state("cuda")
            ms = train_step_ms(st, make_train_step(dtype), batch)
            timing[name] = (ms, TRAIN_BATCH / ms * 1e3, torch.cuda.max_memory_allocated() / 2**30)
            if dtype == torch.bfloat16:
                with FlopCounterMode(display=False) as counter:
                    make_train_step(dtype)(st, batch)
                flops = counter.get_total_flops()
                profiled = train_step_profile(st, make_train_step(dtype), batch)
            del st
        bound_ms = flops / 989e12 * 1e3  # dense bf16 peak, NVIDIA H100 SXM data sheet
        print("phase train: resident batch (" + str(int((batch["labels"] != 0).sum()))
              + " positive anchors), median of " + str(TRAIN_TIMED_STEPS) + " synchronised steps | "
              + " | ".join(f"{n} {ms:.3f} ms/step, {ips:.2f} images/s, peak {gib:.2f} GiB"
                           for n, (ms, ips, gib) in timing.items())
              + f" (float32 convs in TF32, cuDNN's default) | model FLOPs a step "
              f"{flops / 1e12:.3f} T: bf16 bound {bound_ms:.3f} ms, {bound_ms / timing['bf16'][0]:.1%} "
              f"of the bf16 step | host batch_iterator {host_ms:.1f} ms a batch "
              f"({len(batches)} batches); ms an image: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in data_stage_ms(labels, tmp, anchors).items()),
              flush=True)
        print("phase train: bf16 step under torch.profiler: " + (
            f"{profiled['device_ms']:.3f} ms of device time in {profiled['kernels']:.0f} CUDA "
            f"kernels a step ({profiled['device_ms'] / timing['bf16'][0]:.1%} of the step's wall "
            "time) | " + ", ".join(f"{k} {v:.3f}" for k, v in profiled["classes"].items()) + " ms"
            if profiled["kernels"] else "the profiler saw no device time"), flush=True)

        # (d) one float32 step, card against CPU, TF32 off, same weights and batch
        t0 = time.perf_counter()
        err = card_vs_cpu_step({k: v[:2] for k, v in batches[0].items()})
        print("phase train: one step at batch 2, TF32 off, from the same weights: loss card "
              f"{err['card']:.7f}, CPU {err['cpu']:.7f}, CPU float64 network {err['f64']:.7f} | "
              f"BN statistics card vs CPU max abs diff {err['stats_abs']:.3e} "
              f"({err['stats_leaf']}) | parameter "
              f"updates against the float64 one (norm over all parameters; median over "
              f"tensors): card {err['card_update_err']:.3e} ({err['card_update_median']:.3e}), "
              f"CPU float32 {err['cpu_update_err']:.3e} ({err['cpu_update_median']:.3e}) | "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # (e) overfit one batch
        st = fresh_train_state("cuda", warmup_steps=5, seed=1)
        step_fn = make_train_step(torch.bfloat16)
        losses = [float(step_fn(st, batch)[1]["loss"]) for _ in range(OVERFIT_STEPS)]
        check(all(np.isfinite(losses)), f"losses {losses}")
        check(losses[-1] < losses[0], f"the loss did not fall over {OVERFIT_STEPS} steps: {losses}")
        del st

        # (f) the export in the port's Retinaface on the card
        face = Retinaface(model_path=export, backbone="resnet50", input_shape=[*hw, 3],
                          device="cuda")
        frame = np.random.default_rng(8).integers(0, 256, (1, HEIGHT, WIDTH, 3), dtype=np.uint8)
        _, dets_px, keep = face.detect_padded(frame)
        check(dets_px.shape == (1, face.max_detections, 15) and bool(torch.isfinite(dets_px).all()),
              "the export's detections")
        del face
    launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    check(launches == 0, f"the mosaic kernel was launched {launches}x while training")
    print(f"phase train: overfit one batch in bf16: loss {losses[0]:.4f} -> {losses[-1]:.4f} in "
          f"{OVERFIT_STEPS} steps | the export in Retinaface on the card: detect_padded on a "
          f"1080p frame, {int(keep.sum())} boxes kept | mosaic launches {launches}", flush=True)
    return {"launches": launches, "batch": batches[0], "bf16_ms": timing["bf16"][0], "step": err}


def card_vs_cpu_step(batch) -> dict:
    """One train step (batch 2, TF32 off) from the same weights (seed 3) in
    float32 on the card and on the CPU, and with a float64 network on the
    CPU (the loss in float32, as the trainer takes it) as the reference.

    Checks: the card's and the CPU's losses within 1e-5 of each other; the
    BN statistics after the step within 1e-5 + 1e-4 relative (they depend on
    the forward only); and the parameters' updates (the change the step made),
    over all parameters, no farther from the float64 update than twice the
    CPU float32 update is. At random init a float32 gradient of this
    network is itself about 1e-2 off the float64 one (median over the
    tensors, on the CPU at 320 x 320), though the loss agrees to 1e-6, so a
    fixed tolerance between two float32 steps would say nothing."""
    import numpy as np
    import torch

    from video_desensitization_torch.models.convert import to_jax_variables
    from video_desensitization_torch.train.step import make_train_step

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        for name, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                    ("f64", "cpu", torch.float64)):
            st = fresh_train_state(device, seed=3)
            st.model.to(dtype)
            before = to_jax_variables(st.model.state_dict())
            b = {k: v.astype(np.float64) if dtype == torch.float64 and v.dtype == np.float32 else v
                 for k, v in batch.items()}
            st, metrics = make_train_step()(st, b)
            runs[name] = (float(metrics["loss"]), before, to_jax_variables(st.model.state_dict()))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    out = {name: loss for name, (loss, _, _) in runs.items()}
    check(np.isfinite(out["card"]) and abs(out["card"] - out["cpu"]) <= 1e-5 * abs(out["cpu"]),
          f"step loss on the card {out['card']} != on the CPU {out['cpu']}")
    stats = [(name, a, b) for (name, a), (_, b) in zip(_leaves(runs["card"][2]["batch_stats"]),
                                                       _leaves(runs["cpu"][2]["batch_stats"]))]
    out["stats_abs"], out["stats_leaf"] = max((float(np.abs(a - b).max()), n) for n, a, b in stats)
    excess = max(float((np.abs(a - b) - 1e-4 * np.abs(b)).max()) for _, a, b in stats)
    check(excess <= 1e-5, f"BN statistics: card != CPU beyond 1e-5 + 1e-4 relative "
                          f"(max abs diff {out['stats_abs']:.3e} at {out['stats_leaf']})")
    before = dict(_leaves(runs["f64"][1]["params"]))
    update = {name: {k: v.astype(np.float64) - before[k] for k, v in _leaves(r[2]["params"])}
              for name, r in runs.items()}
    ref = update["f64"]
    for name in ("card", "cpu"):
        diff = sum(float(np.sum((update[name][k] - ref[k]) ** 2)) for k in ref)
        out[f"{name}_update_err"] = np.sqrt(diff / sum(float(np.sum(v ** 2)) for v in ref.values()))
        per_tensor = [float(np.linalg.norm(update[name][k] - v) / np.linalg.norm(v))
                      for k, v in ref.items() if np.any(v)]
        out[f"{name}_update_median"] = float(np.median(per_tensor))
    check(out["card_update_err"] <= 2 * out["cpu_update_err"],
          f"the card's update is {out['card_update_err']:.3e} from the float64 one, the CPU's "
          f"{out['cpu_update_err']:.3e}")
    out["runs"] = runs
    return out


def update_error(run, ref) -> float:
    """How far the update of ``run`` (loss, before, after) is from the
    update of ``ref``: the norm over all parameters, relative to ref's."""
    import numpy as np

    before = dict(_leaves(ref[1]["params"]))
    ref_update = {k: v.astype(np.float64) - before[k] for k, v in _leaves(ref[2]["params"])}
    diff = sum(float(np.sum((v.astype(np.float64) - before[k] - ref_update[k]) ** 2))
               for k, v in _leaves(run[2]["params"]))
    return float(np.sqrt(diff / sum(float(np.sum(u ** 2)) for u in ref_update.values())))


def stats_excess(run, ref):
    """(max abs difference, its leaf, the most any BN statistic exceeds
    1e-4 relative of ``ref``'s) between two runs' statistics after the step."""
    import numpy as np

    pairs = [(n, a, b) for (n, a), (_, b) in zip(_leaves(run[2]["batch_stats"]),
                                                 _leaves(ref[2]["batch_stats"]))]
    worst, leaf = max((float(np.abs(a - b).max()), n) for n, a, b in pairs)
    return worst, leaf, max(float((np.abs(a - b) - 1e-4 * np.abs(b)).max()) for _, a, b in pairs)


def _leaves(tree, prefix: str = ""):
    """(path, array) of each leaf of a nested dict, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


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


def _joined(results, b):
    """The shards' EngineResults joined in order and cut to ``b`` frames."""
    import numpy as np

    return (np.concatenate([r.frames for r in results])[:b],
            [x for r in results for x in r.face_boxes][:b],
            [x for r in results for x in r.plate_boxes][:b])


def _box_diff(a_lists, b_lists):
    """(frames whose kept boxes differ in number, max abs difference of the
    boxes of the other frames) between two per-frame box lists."""
    import numpy as np

    count, worst = 0, 0.0
    for a, b in zip(a_lists, b_lists):
        a, b = (np.asarray(x, np.float64).reshape(-1, 4) for x in (a, b))
        if a.shape != b.shape:
            count += 1
        elif a.size:
            worst = max(worst, float(np.abs(a - b).max()))
    return count, worst


def mesh_stage_ms(engine, batches, yuv: bool) -> str:
    """Where a mesh batch's host time goes: each shard's ``dispatch_batch``
    (copies, the program with its NMS syncs, the pinned outputs; the
    shards in turn from the calling thread) and ``finalize_batch`` (the
    wait for its card), by the host clock, ms a shard, medians over
    ``batches``."""
    from video_desensitization_torch.pipeline.engine import DesensitizationEngine

    times = {"dispatch": [], "finalize": []}
    originals = {name: getattr(DesensitizationEngine, f"{name}_batch") for name in times}

    def timed(name):
        def call(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return originals[name](self, *args, **kwargs)
            finally:
                if self.mesh is None:  # a shard's engine, not the mesh's
                    times[name].append((time.perf_counter() - t0) * 1e3)
        return call

    process = engine.process_batch_yuv if yuv else engine.process_batch
    try:
        for name in times:
            setattr(DesensitizationEngine, f"{name}_batch", timed(name))
        for frames in batches:
            process(frames)
    finally:
        for name, fn in originals.items():
            setattr(DesensitizationEngine, f"{name}_batch", fn)
    return ", ".join(f"{name} {statistics.median(v):.3f} ms a shard" for name, v in times.items())


def phase_mesh_engine(engine) -> dict:
    """Phase mesh (a): the fused engine on make_mesh() over every card
    beside ``engine`` (the single-device engine) on the same batches.

    Each card runs its shard of the batch; the single-device engine on the
    same shards (the whole batch on one card) gives the same frames and
    boxes bit for bit. On several cards the single engine on the whole
    batch is compared too, for the record: a bf16 network at another batch
    size may take other cuDNN algorithms and round differently."""
    import numpy as np
    import torch

    from video_desensitization_torch.bench_util import engine_fps
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.parallel.mesh import make_mesh, pad_batch_to_devices
    from video_desensitization_torch.pipeline.engine import DesensitizationEngine

    mesh = make_mesh()
    devices = mesh.size
    sharded = DesensitizationEngine(engine.face, engine.plate, mosaic_level=engine.mosaic_level,
                                    mesh=mesh)
    rng = np.random.default_rng(9)
    parts, out = [], {"devices": devices, "launches": 0}
    for form, shape, calls in (("RGB", (BATCH, HEIGHT, WIDTH, 3), 1),
                               ("I420", (BATCH, HEIGHT * 3 // 2, WIDTH), 2)):
        yuv = form == "I420"
        process = engine.process_batch_yuv if yuv else engine.process_batch
        batches = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(MESH_BATCHES)]
        solo_fps, whole = engine_fps(engine, batches, warmup=WARMUP_BATCHES, yuv=yuv)
        cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
        fps, got = engine_fps(sharded, batches, warmup=WARMUP_BATCHES, yuv=yuv)
        torch.cuda.synchronize()
        launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
        expected = calls * devices * (WARMUP_BATCHES + len(batches))
        check(launches == expected,
              f"mesh {form}: mosaic calls {launches}, expected {expected} ({calls} x {devices} "
              f"cards x {WARMUP_BATCHES + len(batches)} batches)")
        whole_diff = [0, 0.0, 0]
        for frames, g, w in zip(batches, got, whole):
            if devices == 1:
                want = (w.frames, w.face_boxes, w.plate_boxes)
            else:
                padded, _ = pad_batch_to_devices(frames, devices)
                per = len(padded) // devices
                want = _joined([process(padded[i * per:(i + 1) * per]) for i in range(devices)],
                               len(frames))
            check(np.array_equal(g.frames, want[0]), f"mesh {form}: frames != the single "
                                                     f"device's on the same shards")
            check(g.face_boxes == want[1] and g.plate_boxes == want[2],
                  f"mesh {form}: kept boxes != the single device's on the same shards")
            count, worst = _box_diff(g.face_boxes + g.plate_boxes, w.face_boxes + w.plate_boxes)
            whole_diff = [whole_diff[0] + count, max(whole_diff[1], worst),
                          whole_diff[2] + int((g.frames != w.frames).any(axis=tuple(
                              range(1, g.frames.ndim))).sum())]
        out["launches"] += launches
        out[f"{form}_fps"], out[f"{form}_solo_fps"] = fps, solo_fps
        if devices > 1:  # where a mesh batch's time goes
            shard = batches[0][:len(batches[0]) // devices]
            dropped, _ = engine_fps(sharded, batches, warmup=0, keep=False, yuv=yuv)
            parts.append(f"{form} one shard ({len(shard)} frames) alone on one card "
                         f"{host_ms(lambda: process(shard)):.3f} ms, a batch on the mesh "
                         f"{len(batches[0]) / fps * 1e3:.3f} ms (results dropped "
                         f"{len(batches[0]) / dropped * 1e3:.3f} ms); in it "
                         f"{mesh_stage_ms(sharded, batches, yuv)}")
        parts.append(f"{form} {fps:.2f} frames/s (single device {solo_fps:.2f}), mosaic calls "
                     f"{launches} = {calls} x {devices} x {len(batches) + WARMUP_BATCHES} batches, "
                     f"frames and boxes equal to the single device's on the same shards; against "
                     f"it on whole batches: {whole_diff[2]} frames differ, {whole_diff[0]} keep "
                     f"another number of boxes, the rest's boxes within {whole_diff[1]:.2e} px")
    print(f"phase mesh: make_mesh() over {devices} card(s) {dict(mesh.shape)}, resnet50+yolov8n "
          f"640 bf16, {BATCH}x{HEIGHT}x{WIDTH} batches, results held | " + " | ".join(parts),
          flush=True)
    return out


def _mesh_step(mesh, batch, device):
    """(loss, variables before, variables after) of one float32 step on
    ``mesh`` from seed 3's weights, this rank's on ``device``, the split
    kernels gathered whole; then MESH_EQUAL_STEPS - 1 more steps and the
    number of parameter elements in which some rank differs from the
    others (``replica_mismatch``)."""
    import copy

    from video_desensitization_torch.models.convert import to_jax_variables
    from video_desensitization_torch.parallel.tensor import full_state_dict
    from video_desensitization_torch.train.step import make_train_step

    st = fresh_train_state(device, seed=3, mesh=mesh)
    before = to_jax_variables(full_state_dict(st.model))
    step = make_train_step(mesh=mesh)
    st, metrics = step(st, batch)
    after = copy.deepcopy(to_jax_variables(full_state_dict(st.model)))  # the steps go on in place
    for _ in range(MESH_EQUAL_STEPS - 1):
        st, _ = step(st, batch)
    return float(metrics["loss"]), before, after, replica_mismatch(st.model, mesh)


def replica_mismatch(model, mesh) -> int:
    """Elements of ``model``'s parameters in which some rank differs from
    rank 0 of its group: the replicated ones over the whole mesh, each
    split kernel's slice over its data group (all-gathers)."""
    import torch
    import torch.distributed as dist

    from video_desensitization_torch.parallel.tensor import split_param_owner

    split = split_param_owner(model)
    params = list(model.parameters())
    count = 0
    for group, size, chosen in ((None, mesh.size, [p for p in params if id(p) not in split]),
                                (mesh.group("data"), mesh.shape["data"],
                                 [p for p in params if id(p) in split])):
        if not chosen or size == 1:
            continue
        flat = torch.cat([p.detach().reshape(-1) for p in chosen])
        parts = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(parts, flat, group=group)
        count += sum(int((part != parts[0]).sum()) for part in parts[1:])
    return count


def mesh_rank(rank: int, address: str, devices, checks, batch_path: str, out_path: str) -> None:
    """One rank of phase mesh's processes, on ``devices[rank]`` (gloo where
    a card is repeated, NCCL otherwise): one float32 step (batch 2, TF32
    off) on each (name, data, model) mesh of ``checks``, then the bf16 step
    at data = every rank on the whole batch, timed, and the gradients'
    all-reduce alone. Rank 0 writes the results."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from video_desensitization_torch.parallel.mesh import distributed_init, make_mesh
    from video_desensitization_torch.train.step import make_train_step

    card = devices[rank]
    torch.cuda.set_device(card)
    backend = "gloo" if len(set(devices)) < len(devices) else "nccl"
    distributed_init(address, len(devices), rank, backend=backend)
    batch = dict(np.load(batch_path))
    out = {"backend": backend}
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, data, model in checks:
            out[name] = _mesh_step(make_mesh(devices, data=data, model=model),
                                   {k: v[:2] for k, v in batch.items()}, card)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    timed = make_mesh(devices)
    st = fresh_train_state(card, mesh=timed)
    resident = {k: torch.as_tensor(v).to(card) for k, v in batch.items()}
    step_fn = make_train_step(torch.bfloat16, mesh=timed)
    out["bf16_ms"] = train_step_ms(st, step_fn, resident, MESH_WARMUP_STEPS, MESH_TIMED_STEPS)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["profile"] = train_step_profile(st, step_fn, resident, steps=2)  # every rank steps
    # the step's gradient all-reduce alone: one float32 buffer of every parameter
    grads = torch.ones(sum(p.numel() for p in st.model.parameters()), device=card)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(grads, group=timed.group("data"))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["grad_allreduce_ms"], out["grad_mb"] = statistics.median(times[1:]), grads.numel() * 4e-6
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


def phase_mesh_train(smi: str, trained: dict) -> None:
    """Phase mesh (b)-(d), held against phase train's single-process step
    (``trained``): on one card two processes on cuda:0 over gloo, at data
    2 and at model 2; on several, one process a card over NCCL, at data 2
    x model 2 (4 cards) or data 2 x model cards/2. Then the bf16 step at
    data = every process, timed."""
    import multiprocessing
    import pickle
    import tempfile

    import numpy as np
    import torch

    from video_desensitization_torch.parallel.mesh import localhost_address

    cards = torch.cuda.device_count()
    if cards == 1:
        devices = [torch.device("cuda", 0)] * 2
        checks = [("data2", 2, 1), ("model2", 1, 2)]
    else:
        devices = [torch.device("cuda", i) for i in range(cards)]
        checks = [("data2-model2", 2, 2)] if cards == 4 else [("data2", 2, cards // 2)]
    runs = trained["step"]["runs"]
    single, f64 = runs["card"], runs["f64"]
    single_err = update_error(single, f64)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        batch_path, out_path = os.path.join(tmp, "batch.npz"), os.path.join(tmp, "out.pkl")
        np.savez(batch_path, **trained["batch"])
        address = localhost_address()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, address, devices, checks, batch_path, out_path))
                 for r in range(len(devices))]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(MESH_RANK_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        check(all(p.exitcode == 0 for p in procs),
              f"phase mesh ranks exited {[p.exitcode for p in procs]}")
        with open(out_path, "rb") as f:
            out = pickle.load(f)
    seconds = time.perf_counter() - t0
    parts = []
    for name, _, _ in checks:
        run = out[name]
        check(run[3] == 0, f"{name}: after {MESH_EQUAL_STEPS} steps {run[3]} parameter elements "
                           f"differ between the ranks that hold them")
        check(np.isfinite(run[0]) and abs(run[0] - single[0]) <= 1e-5 * abs(single[0]),
              f"{name}: loss {run[0]} != the single-process step's {single[0]}")
        worst, leaf, excess = stats_excess(run, single)
        check(excess <= 1e-5, f"{name}: BN statistics beyond 1e-5 + 1e-4 relative of the "
                              f"single-process step's (max abs diff {worst:.3e} at {leaf})")
        err = update_error(run, f64)
        check(err <= 2 * single_err, f"{name}: update {err:.3e} from the float64 one, the "
                                     f"single-process step's {single_err:.3e}")
        parts.append(f"{name}: loss {run[0]:.7f} (single {single[0]:.7f}), BN statistics max abs "
                     f"diff {worst:.3e}, update {err:.3e} from float64 (single {single_err:.3e}), "
                     f"parameters equal on every rank that holds them after {MESH_EQUAL_STEPS} "
                     f"steps")
    where = ("two processes on cuda:0 over gloo" if cards == 1
             else f"{cards} processes, one a card, over {out['backend']}")
    staging = ("gloo stages every all-reduce through the host, not NVLink, and the two ranks "
               "share the card" if cards == 1 else f"{out['backend']} between the cards")
    ms, world, prof = out["bf16_ms"], len(devices), out["profile"]
    print(f"phase mesh: {smi} | {where}, one float32 step at batch 2 (1 image a data row), "
          f"TF32 off, from seed 3's weights | " + " | ".join(parts), flush=True)
    print(f"phase mesh: {smi} | bf16 step at data {world}, ResNet-50 640, batch {TRAIN_BATCH} "
          f"({TRAIN_BATCH // world} a rank), {where}: {ms:.3f} ms/step, "
          f"{TRAIN_BATCH / ms * 1e3:.2f} images/s, peak {out['peak_gib']:.2f} GiB a rank "
          f"(median of {MESH_TIMED_STEPS}; {staging}), of which the gradients' all-reduce "
          f"alone ({out['grad_mb']:.1f} MB float32) {out['grad_allreduce_ms']:.3f} ms; rank 0 "
          f"under torch.profiler: {prof['device_ms']:.3f} ms of device time in "
          f"{prof['kernels']:.0f} kernels a step (" + ", ".join(
              f"{k} {v:.3f}" for k, v in prof["classes"].items()) + " ms) | single "
          f"process: {trained['bf16_ms']:.3f} ms/step, "
          f"{TRAIN_BATCH / trained['bf16_ms'] * 1e3:.2f} images/s | {seconds:.1f} s", flush=True)


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
    weights = phase_weights(main_engine, smi)  # after yuv: its subprocesses cost the profiler kernels
    phase_tiered(main_engine)
    phase_record(main_engine)
    tracked = phase_tracked(main_engine)
    multicam = phase_multicam(main_engine)
    serve = phase_serve(main_engine)
    mesh = phase_mesh_engine(main_engine)
    del main_engine
    phase_stream()
    trained = phase_train(smi)
    phase_mesh_train(smi, trained)
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
        "weights_launches": weights["launches"],
        "i420_launches": yuv["launches"],
        "i420_calls_per_batch": yuv["launches"] // (WARMUP_BATCHES + ENGINE_BATCHES),
        "i420_y_ms": yuv["y"]["ms"],
        "i420_y_bound_ms": yuv["y"]["bound_ms"],
        "i420_uv_ms": yuv["uv"]["ms"],
        "i420_uv_bound_ms": yuv["uv"]["bound_ms"],
        "tracked_launches": tracked["launches"],
        "multicam_launches": multicam["launches"],
        "serve_launches": serve["launches"],
        "train_launches": trained["launches"],
        "mesh_launches": mesh["launches"],
        "mesh_devices": mesh["devices"],
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
