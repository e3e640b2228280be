"""config.ini-compatible configuration (reference combine_detect.py:717-766).

Same sections and keys ([PATHS] model_path, model_weights, record_dir,
output_h265_dir, output_videos_dir, temp_directory_base, record_output_dir;
[SETTINGS] video_formats, cleanup_temp, copy_unprocessed_videos, batch_size)
plus the engine's settings under [TPU] (all optional): dtype, mesh_data,
mosaic_level, max_detections, input_size. The section keeps that name, and
every key, default and check, so that one config.ini parses the same here
and in the JAX package; keys the port cannot honour yet are refused by
``cli.main.build_engine`` and ``pipeline.video_pipeline.process_record_job``.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from typing import List, Optional

REQUIRED_PATH_KEYS = (
    "model_path",
    "model_weights",
    "record_dir",
    "output_h265_dir",
    "output_videos_dir",
    "temp_directory_base",
    "record_output_dir",
)

DEFAULT_VIDEO_FORMATS = ["h265", "hevc", "265", "mp4", "mov", "avi"]


@dataclasses.dataclass
class PipelineConfig:
    model_path: Optional[str] = None
    model_weights: Optional[str] = None
    record_dir: str = ""
    output_h265_dir: str = ""
    output_videos_dir: str = ""
    temp_directory_base: str = ""
    record_output_dir: str = ""
    video_formats: List[str] = dataclasses.field(
        default_factory=lambda: list(DEFAULT_VIDEO_FORMATS)
    )
    cleanup_temp: bool = True
    copy_unprocessed_videos: bool = True
    batch_size: int = 16
    # TPU additions
    dtype: str = "bfloat16"
    mesh_data: int = 0  # 0 = all local devices
    mosaic_level: int = 8
    max_detections: int = 128
    input_size: int = 640
    confidence: float = 0.5
    nms_iou: float = 0.4
    plate_confidence: float = 0.5
    output_fps: float = 60.0
    # "fused": detection + mosaic in one device program on full frames
    # (bandwidth-rich hosts); "tiered": host letterbox + boxes-only readback +
    # host mosaic (link-constrained hosts); "auto": probe the host->device
    # link at startup and pick. See pipeline/throughput.py.
    engine: str = "tiered"
    resume: bool = True  # skip already-completed videos via output manifest
    # Host<->device frame format: "rgb" or "yuv420" (half the bytes;
    # sources are H.265 4:2:0 so chroma re-subsampling is lossless w.r.t.
    # the codec). For the tiered engine this selects the h2d content
    # transfer; for the fused engine it selects the whole stream transport
    # (decoder I420 -> process_batch_yuv -> encoder I420, no RGB pass
    # anywhere — pipeline/streaming.py).
    transfer: str = "rgb"
    # Co-batch frames from all camera streams into shared device batches
    # (pipeline/multicam.py) instead of processing streams sequentially.
    co_batch: bool = False
    # "mosaic" (reference pixelation, bit-exact) or "gaussian" (softer blur).
    anonymizer: str = "mosaic"
    # Processed-video H.265 encode settings. Defaults are the reference's
    # repack parameters (10 Mbps / preset medium, recordDeal.so strings —
    # SURVEY C2); the repack stage remuxes .h265 outputs without
    # re-encoding, so these settings ARE the final record payload quality.
    # libx265 at medium is the record job's tail on few-core hosts
    # (~0.7 fps/core at 1080p) — drop to "fast"/"ultrafast" when encode
    # throughput matters more than bitrate efficiency.
    encode_preset: str = "medium"
    encode_bitrate: int = 10_000_000
    # libx265 worker threads for the processed-video writers: 0 = x265
    # auto (pools = all cores). On many-core hosts the record job's tail
    # is the HEVC re-encode; pinning pools/frame-threads explicitly
    # (rather than only the speed/quality preset) bounds or widens that
    # stage. Builds "pools=N:frame-threads=N" via x265-params.
    encode_threads: int = 0
    # Detect every Nth frame of an ordered stream and cover the frames in
    # between with matched, interpolated, margin-inflated keyframe boxes
    # pixelated on the host (pipeline/tracking.py). 1 = reference behavior
    # (detect every frame). Ordered streams track: the single-video path
    # (TrackingEngine) and the multicam record job (per-camera
    # CameraTracker state; keyframes co-batch across cameras). The
    # images-directory path keeps per-frame detection (unordered).
    detect_interval: int = 1
    # Keyframes a track missed by the detector keeps covering (velocity-
    # extrapolated, growing inflation) before expiring. Closes the
    # double-miss hole; residual risk = a box missed at more than
    # track_coast consecutive keyframes (benchmarks/tracking_coverage.py).
    track_coast: int = 3
    # Keyframes batched per tracked detection dispatch. 0 = auto: reuse
    # [SETTINGS] batch_size, so the tracker drives the SAME compiled
    # program as the non-tracked path (a different batch would trigger a
    # second XLA compile). The tradeoff this knob tunes: the tracker
    # buffers up to (depth+1) * track_detect_batch * detect_interval raw
    # frames while detections are in flight — at 1080p RGB, interval 4 and
    # batch 32 that is ~2.4 GB and ~4.3 s of first-result latency at 30
    # fps ingest; batch 8 cuts both 4x at some pipelining efficiency
    # (pipeline/tracking.py TrackingEngine docstring has the numbers).
    track_detect_batch: int = 0

    @property
    def encode_kwargs(self) -> dict:
        """Encoder overrides for the libx265 processed-video writers."""
        kw = {"preset": self.encode_preset, "bitrate": self.encode_bitrate}
        if self.encode_threads > 0:
            kw["x265_params"] = (
                f"pools={self.encode_threads}:"
                f"frame-threads={self.encode_threads}"
            )
        return kw


def load_config(path: str = "config.ini", strict: bool = True) -> PipelineConfig:
    """Parse a reference-format config.ini into a typed config."""
    parser = configparser.ConfigParser()
    if not parser.read(path, encoding="utf-8"):
        raise FileNotFoundError(f"config file not found: {path}")
    if "PATHS" not in parser:
        raise ValueError("config missing [PATHS] section")
    paths = parser["PATHS"]
    missing = [k for k in REQUIRED_PATH_KEYS if k not in paths]
    if strict and missing:
        raise ValueError(f"config missing required PATHS keys: {missing}")

    cfg = PipelineConfig()
    for k in REQUIRED_PATH_KEYS:
        if k in paths:
            setattr(cfg, k, paths.get(k).strip().strip('"'))

    if "SETTINGS" in parser:
        s = parser["SETTINGS"]
        fmts = s.get("video_formats", ",".join(DEFAULT_VIDEO_FORMATS))
        cfg.video_formats = [f.strip().lower() for f in fmts.split(",") if f.strip()]
        cfg.cleanup_temp = s.getboolean("cleanup_temp", True)
        cfg.copy_unprocessed_videos = s.getboolean("copy_unprocessed_videos", True)
        cfg.batch_size = s.getint("batch_size", 16)
        cfg.encode_preset = s.get("encode_preset", cfg.encode_preset)
        cfg.encode_bitrate = s.getint("encode_bitrate", cfg.encode_bitrate)
        cfg.encode_threads = s.getint("encode_threads", cfg.encode_threads)

    if "TPU" in parser:
        t = parser["TPU"]
        cfg.dtype = t.get("dtype", cfg.dtype)
        cfg.mesh_data = t.getint("mesh_data", cfg.mesh_data)
        cfg.mosaic_level = t.getint("mosaic_level", cfg.mosaic_level)
        cfg.max_detections = t.getint("max_detections", cfg.max_detections)
        cfg.input_size = t.getint("input_size", cfg.input_size)
        cfg.confidence = t.getfloat("confidence", cfg.confidence)
        cfg.nms_iou = t.getfloat("nms_iou", cfg.nms_iou)
        cfg.plate_confidence = t.getfloat("plate_confidence", cfg.plate_confidence)
        cfg.output_fps = t.getfloat("output_fps", cfg.output_fps)
        cfg.engine = t.get("engine", cfg.engine)
        cfg.resume = t.getboolean("resume", cfg.resume)
        cfg.transfer = t.get("transfer", cfg.transfer)
        cfg.co_batch = t.getboolean("co_batch", cfg.co_batch)
        cfg.anonymizer = t.get("anonymizer", cfg.anonymizer)
        cfg.detect_interval = t.getint("detect_interval", cfg.detect_interval)
        cfg.track_coast = t.getint("track_coast", cfg.track_coast)
        cfg.track_detect_batch = t.getint(
            "track_detect_batch", cfg.track_detect_batch
        )
    if cfg.engine not in ("tiered", "fused", "auto"):
        raise ValueError(
            f"[TPU] engine must be 'tiered', 'fused', or 'auto', got {cfg.engine!r}"
        )
    if cfg.transfer not in ("rgb", "yuv420"):
        raise ValueError(f"[TPU] transfer must be 'rgb' or 'yuv420', got {cfg.transfer!r}")
    if cfg.anonymizer not in ("mosaic", "gaussian"):
        raise ValueError(
            f"[TPU] anonymizer must be 'mosaic' or 'gaussian', got {cfg.anonymizer!r}"
        )
    if cfg.detect_interval < 1:
        raise ValueError(
            f"[TPU] detect_interval must be >= 1, got {cfg.detect_interval}"
        )
    if cfg.track_coast < 0:
        raise ValueError(
            f"[TPU] track_coast must be >= 0, got {cfg.track_coast}"
        )
    if cfg.track_detect_batch < 0:
        raise ValueError(
            f"[TPU] track_detect_batch must be >= 0 (0 = auto: batch_size), "
            f"got {cfg.track_detect_batch}"
        )
    if cfg.detect_interval > 4:
        # Measured residual: benchmarks/tracking_coverage.py shows 100%
        # min-coverage for every modeled motion only at interval <= 4; at
        # interval 8 curved motion dips to ~0.20 min-coverage mid-gap (the
        # inflation envelope cannot absorb that much curvature) and
        # blur-area overhead reaches 4.6-8.5x. The knob stays available —
        # some deployments trade coverage for rate — but never silently.
        from video_desensitization_torch.utils.logging import get_logger

        get_logger("config").warning(
            "[TPU] detect_interval=%d > 4: propagated-box coverage is no "
            "longer complete for curved motion (measured min ~0.20 at "
            "interval 8, benchmarks/tracking_coverage.py); intervals <= 4 "
            "are the verified-complete range",
            cfg.detect_interval,
        )
    return cfg
