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
  6. stream: the CLI (cli.main.main) at full width on a short synthetic
     1080p video, with transfer = yuv420 and then rgb, every frame back,
     the kernel's calls counted, and the codec path (native libav or cv2);
  7. reference: the card against the CPU on the same weights in float32:
     both networks, then the rest of the engine's program (letterbox
     canvas, decode, NMS, inverse letterbox, box order);
then a "kernels" JSON line, the nvidia-smi line, and the result line.
Exits non-zero without CUDA, outside the repository, or on any failure.
"""

from __future__ import annotations

import json
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
TIMED_CALLS = 50


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
    """``cli.main.main`` on a short synthetic 1080p video at full width,
    transfer yuv420 then rgb. Its frames/s is the CLI's wall time (engine
    build and codec included) and is bound by the codec, not the card."""
    import tempfile

    import numpy as np

    from video_desensitization_torch.cli.main import main as cli_main
    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.video import av

    rng = np.random.default_rng(5)
    parts = []
    with tempfile.TemporaryDirectory() as tmp:
        src = f"{tmp}/in.mp4"
        with av.VideoEncoder(src, WIDTH, HEIGHT, fps=24, codec="mpeg4") as enc:
            for _ in range(STREAM_FRAMES):
                coarse = rng.integers(0, 256, (HEIGHT // 8, WIDTH // 8, 3), dtype=np.uint8)
                enc.write(coarse.repeat(8, axis=0).repeat(8, axis=1))
        for transfer in ("yuv420", "rgb"):
            ini = f"{tmp}/{transfer}.ini"
            with open(ini, "w") as f:
                f.write(
                    "[PATHS]\nmodel_path=\nmodel_weights=\n[SETTINGS]\nbatch_size=8\n"
                    f"[TPU]\nengine=fused\ntransfer={transfer}\ndtype=bfloat16\n"
                    "input_size=640\nmax_detections=16\nmosaic_level=8\n"
                )
            out = f"{tmp}/out_{transfer}.mp4"
            cuda_mosaic.mosaic_boxes_batch_cuda_.launches = 0
            t0 = time.perf_counter()
            rc = cli_main([ini, "--video", src, "--out", out, "--allow-random-weights"])
            seconds = time.perf_counter() - t0
            launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
            check(rc == 0, f"CLI returned {rc}")
            batches = -(-STREAM_FRAMES // BATCH)
            per_batch = 2 if transfer == "yuv420" else 1
            check(launches == per_batch * batches,
                  f"{transfer}: mosaic kernel called {launches}x in {batches} batches")
            with av.VideoDecoder(out) as dec:
                frames = [f.shape for f in dec]
            check(frames == [(HEIGHT, WIDTH, 3)] * STREAM_FRAMES,
                  f"{transfer}: {len(frames)} of {STREAM_FRAMES} frames back")
            parts.append(
                f"transfer {transfer}: {STREAM_FRAMES} frames back, mosaic calls {launches} in "
                f"{batches} batches, {STREAM_FRAMES / seconds:.2f} frames/s over the CLI's wall "
                f"time ({seconds:.2f} s, engine build and codec included: codec-bound)"
            )
    print(f"phase stream: codec {av.codec_path()} | " + " | ".join(parts), flush=True)
    return {"codec": av.codec_path()}


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
    repo = Path(__file__).resolve().parent
    if not (repo / "video_desensitization_torch" / "csrc" / "mosaic.cu").is_file():
        print(f"chip_smoke: no video_desensitization_torch package in {repo}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))

    from video_desensitization_torch.bench_util import main_path_engine

    smi = phase_device()
    phase_build()
    phase_kernel()
    main_engine = main_path_engine()
    engine = phase_engine(main_engine)
    yuv = phase_yuv(main_engine, engine["fps"])
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
