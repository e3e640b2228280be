"""CLI entry point — the ``combine_detect.py`` equivalent, on PyTorch/CUDA.

Usage:

    python -m video_desensitization_torch.cli.main [config.ini]
    python -m video_desensitization_torch.cli.main [config.ini] --video in.mp4 --out out.mp4
    python -m video_desensitization_torch.cli.main [config.ini] --images dir/ --out outdir/

With only a config.ini it runs the record job (unpack the ``.record`` logs
under ``[PATHS] record_dir``, desensitize every camera stream, repack a new
record into ``record_output_dir``); ``--video`` and ``--images`` run one
video file or an image directory. It runs on ``cuda`` unless ``--device
cpu`` is given. The config.ini is the JAX package's format. ``[TPU]
engine`` picks the tiered pipeline (the default: host letterbox and
mosaic, boxes-only readback), the fused engine, or ``auto`` (a
host-to-device copy probe picks one); ``[TPU] plate_arch`` the plate
detector (``yolov8n``, or ``rtdetr-r50vd`` on the fused engine); ``[TPU]
detect_interval > 1`` wraps it in keyframe tracking (``pipeline/tracking.py``)
and ``[TPU] co_batch`` co-batches the record job's cameras
(``pipeline/multicam.py``). ``[TPU]
mesh_data = n > 1`` shards the fused engine's batches over a mesh of n
devices (which must be every device), as the JAX CLI does; the tiered
pipeline runs on one and says so. Unlike the JAX CLI, ``mesh_data = 0``
(the default) runs on one device however many there are: on several
cards the mesh engine is slower than one card (``ROADMAP.md`` §3).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from video_desensitization_torch import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _resolve_checkpoint(path, allow_random: bool, what: str):
    """Return a checkpoint path, or None for explicitly-sanctioned random init.

    A desensitization run with randomly-initialized detectors blurs nothing
    while reporting success — a silent privacy failure. Empty model paths in
    the config are therefore an error in the CLI path; random init requires
    an explicit opt-in (path set to the literal ``random``, or
    ``--allow-random-weights``). Library/bench construction with
    ``model_path=None`` is unaffected.
    """
    from video_desensitization_torch.utils.logging import get_logger

    stripped = (path or "").strip()
    if stripped and stripped.lower() != "random":
        return stripped
    if not allow_random and stripped.lower() != "random":
        raise ValueError(
            f"no {what} checkpoint configured (empty model path). Refusing to "
            "run the desensitization job with RANDOM weights — the output "
            "would not be blurred. Set the checkpoint path in config.ini, or "
            "opt in explicitly with the literal path 'random' or "
            "--allow-random-weights."
        )
    get_logger("cli").warning(
        "%s detector initialized with RANDOM weights (explicit opt-in) — "
        "output will NOT be meaningfully desensitized",
        what,
    )
    return None


def probe_link_gib_s(device=None, size_mb: int = 32, reps: int = 2) -> float:
    """Host-to-device copy rate in GiB/s (gigaBYTES): the best of ``reps``
    pageable copies of ``size_mb`` MiB, each waited for. On the CPU it is a
    host memory copy."""
    device = resolve_device(device)
    buf = torch.zeros(size_mb << 20, dtype=torch.uint8)

    def copy():
        x = buf.to(device, copy=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return x

    copy()  # warm-up: context, allocator
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        copy()
        best = max(best, size_mb / 1024.0 / (time.perf_counter() - t0))
    return best


# engine=auto thresholds in GiB/s of the probe: the JAX package's values,
# kept so one config picks the same engine in both packages at the same
# measured rate. The fused engine moves full frames both ways (about 12.4
# MB a 1080p RGB frame, half that as I420), the tiered one only the
# letterbox content in and boxes out, so fused wins only on a fast link.
AUTO_ENGINE_FUSED_GIB_S = 6.0
AUTO_ENGINE_FUSED_YUV_GIB_S = 3.0


def pick_engine(gib_s: float, transfer: str = "rgb") -> str:
    """Resolve engine=auto from a measured link rate; yuv420 halves the
    fused engine's traffic, so its threshold is half as high."""
    floor = AUTO_ENGINE_FUSED_YUV_GIB_S if transfer == "yuv420" else AUTO_ENGINE_FUSED_GIB_S
    return "fused" if gib_s >= floor else "tiered"


def build_engine(cfg, with_plates: bool = True, allow_random: bool = False, device=None):
    """The engine of ``cfg`` on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``; with neither CUDA nor a device given it raises): the
    tiered pipeline, the fused engine, or for ``engine = auto`` the one
    ``pick_engine`` takes at the probed link rate (``cfg`` is not changed,
    so each build probes anew). ``mesh_data`` above 1 puts the fused
    engine on a mesh of the devices of its kind
    (``parallel.mesh.make_mesh``, which raises where they are not
    ``mesh_data``); 0 runs on one device, and says so where there are
    several. With ``detect_interval > 1`` the engine is wrapped in a
    ``TrackingEngine`` that detects in batches of ``track_detect_batch``,
    or ``batch_size`` when that is 0. ``plate_arch`` picks the plate
    detector: YOLOv8n, or RT-DETR-R50 (``detect/detr.py``), which needs
    the fused engine and raises where the engine resolves to tiered."""
    from video_desensitization_torch.detect.face import Retinaface
    from video_desensitization_torch.detect.plate import PlateDetector
    from video_desensitization_torch.parallel import mesh as mesh_lib
    from video_desensitization_torch.pipeline.engine import DesensitizationEngine
    from video_desensitization_torch.pipeline.throughput import TieredPipeline
    from video_desensitization_torch.utils.logging import get_logger

    device = resolve_device(device)
    engine_mode = cfg.engine
    if engine_mode == "auto":
        gib_s = probe_link_gib_s(device)
        engine_mode = pick_engine(gib_s, cfg.transfer)
        get_logger("cli").info(
            "engine=auto: link probe %.2f GiB/s -> %s (transfer=%s)",
            gib_s, engine_mode, cfg.transfer,
        )
    if cfg.plate_arch == "rtdetr-r50vd" and with_plates and engine_mode == "tiered":
        raise ValueError(
            "[TPU] plate_arch = rtdetr-r50vd needs engine = fused: RT-DETR stretches "
            "whole frames, and the tiered pipeline sends the card only the letterboxed "
            "content (a stretch of it would be a second resize, not RT-DETR's input)"
        )
    dtype = DTYPES[cfg.dtype]
    mesh = None
    devices = mesh_lib.local_devices(device.type)
    if cfg.mesh_data > 1:
        mesh = mesh_lib.make_mesh(devices, data=cfg.mesh_data)
    elif cfg.mesh_data == 0 and len(devices) > 1:
        get_logger("cli").info(
            "mesh_data=0 runs on one of %d devices; set mesh_data=%d to shard the "
            "fused engine over all of them", len(devices), len(devices),
        )
    face = Retinaface(
        model_path=_resolve_checkpoint(cfg.model_path, allow_random, "face"),
        backbone="resnet50",
        confidence=cfg.confidence,
        nms_iou=cfg.nms_iou,
        input_shape=[cfg.input_size, cfg.input_size, 3],
        max_detections=cfg.max_detections,
        dtype=dtype,
        device=device,
    )
    plate = None
    if with_plates and cfg.plate_arch == "rtdetr-r50vd":
        from video_desensitization_torch.detect.detr import RtDetrPlateDetector

        plate = RtDetrPlateDetector(
            model_path=_resolve_checkpoint(cfg.model_weights, allow_random, "plate"),
            confidence=cfg.plate_confidence,
            input_shape=(cfg.input_size, cfg.input_size),
            dtype=dtype,
            device=device,
        )
    elif with_plates:
        plate = PlateDetector(
            model_path=_resolve_checkpoint(cfg.model_weights, allow_random, "plate"),
            confidence=cfg.plate_confidence,
            input_shape=(cfg.input_size, cfg.input_size),
            dtype=dtype,
            device=device,
        )
    if engine_mode == "tiered":
        if mesh is not None:
            get_logger("cli").warning(
                "engine=tiered runs single-chip; mesh_data=%s is ignored "
                "(use engine=fused for multi-chip batch sharding)",
                cfg.mesh_data,
            )
        engine = TieredPipeline(
            face, plate, mosaic_level=cfg.mosaic_level, transfer=cfg.transfer,
            anonymizer=cfg.anonymizer,
        )
    else:
        engine = DesensitizationEngine(
            face, plate, mosaic_level=cfg.mosaic_level, anonymizer=cfg.anonymizer, mesh=mesh
        )
    if cfg.detect_interval > 1:
        from video_desensitization_torch.pipeline.tracking import TrackingEngine

        detect_batch = cfg.track_detect_batch or cfg.batch_size
        get_logger("cli").info(
            "detect_interval=%d: keyframe detection in batches of %d, gap "
            "frames covered on the host (pipeline/tracking.py)",
            cfg.detect_interval, detect_batch,
        )
        engine = TrackingEngine(
            engine, interval=cfg.detect_interval, detect_batch=detect_batch,
            coast=cfg.track_coast,
        )
    return engine


def main(argv=None) -> int:
    from video_desensitization_torch.api.config import PipelineConfig, load_config
    from video_desensitization_torch.utils.logging import setup_logger

    p = argparse.ArgumentParser(description="Video desensitization on PyTorch/CUDA")
    p.add_argument("config", nargs="?", default="config.ini")
    p.add_argument("--video", help="process a single video file")
    p.add_argument("--images", help="process a directory of images")
    p.add_argument("--out", help="output path (video) or directory (images)")
    p.add_argument("--no-plates", action="store_true")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument(
        "--device",
        help="torch device to run on (default: cuda; 'cpu' must be asked for)",
    )
    p.add_argument(
        "--allow-random-weights",
        action="store_true",
        help="explicitly allow running with randomly-initialized detectors "
        "(testing only; output will NOT be desensitized)",
    )
    p.add_argument(
        "--profile",
        metavar="DIR",
        help="capture a torch.profiler trace of the whole job into DIR/trace.json",
    )
    args = p.parse_args(argv)

    log = setup_logger()
    log.info("torch %s | cuda %s", torch.__version__, torch.cuda.is_available())

    record_job = args.video is None and args.images is None
    try:
        cfg = load_config(args.config, strict=record_job)
    except (FileNotFoundError, ValueError):
        # The record job is driven by the config: a missing or incomplete
        # one is an error there. The one-file modes run with the defaults.
        if record_job:
            raise
        cfg = PipelineConfig()
    if args.batch_size:
        cfg.batch_size = args.batch_size

    t0 = time.time()
    engine = build_engine(
        cfg,
        with_plates=not args.no_plates,
        allow_random=args.allow_random_weights,
        device=args.device,
    )
    log.info("engine on %s", engine.device)

    trace = contextlib.nullcontext()
    if args.profile:
        from video_desensitization_torch.utils.timers import profile_trace

        trace = profile_trace(args.profile)

    with trace:
        _run_job(args, cfg, engine, log)
    log.info("total wall time: %.1fs", time.time() - t0)
    return 0


def _run_job(args, cfg, engine, log) -> None:
    if args.video:
        from video_desensitization_torch.pipeline.streaming import process_video_stream

        out = args.out or args.video.rsplit(".", 1)[0] + "_processed.mp4"
        stats = process_video_stream(
            args.video, out, engine, batch_size=cfg.batch_size,
            encode_kwargs=getattr(cfg, "encode_kwargs", None),
            transport=cfg.transfer,
        )
        log.info(
            "done: %d frames, %d faces, %d plates, %.1f fps end-to-end",
            stats.frames, stats.faces, stats.plates, stats.fps,
        )
    elif args.images:
        from video_desensitization_torch.pipeline.batch import batch_process_images

        out = args.out or args.images.rstrip("/") + "_processed"
        n, faces, plates = batch_process_images(
            args.images, out, engine, batch_size=cfg.batch_size
        )
        log.info("done: %d images, %d faces, %d plates", n, faces, plates)
    else:
        from video_desensitization_torch.pipeline.video_pipeline import process_record_job

        stats = process_record_job(cfg, engine)
        log.info("final record: %s", stats.record_path)


if __name__ == "__main__":
    sys.exit(main())
