"""Streaming video desensitization: overlapped decode | device | encode.

A decoder thread fills a bounded queue of frame batches, the main thread
hands them to the engine, and an encoder thread drains the results. No
intermediate JPEGs, no disk round trip. The decoder and encoder threads
only run the codec. Where the CUDA calls are made depends on the engine:

- the fused engine: from the main thread, two batches in flight through
  ``dispatch_batch``/``finalize_batch`` (the copies and the program run on
  the engine's stream, so the card works on batch N while the host decodes
  N+1 and encodes N-1);
- the tiered pipeline (``pipeline/throughput.py``): the main thread hands
  it the whole batch iterator, and its ``process_stream`` makes the CUDA
  calls from its own dispatch thread (program) and finalize thread (the
  wait on each batch's event), each entering the pipeline's stream itself.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from video_desensitization_torch.pipeline.engine import DesensitizationEngine
from video_desensitization_torch.utils.logging import get_logger
from video_desensitization_torch.utils.timers import StageTimer
from video_desensitization_torch.video.av import (
    HEVC_DEFAULTS,
    I420UnsupportedError,
    VideoDecoder,
    VideoEncoder,
    default_codec_for,
)

_SENTINEL = object()


@dataclass
class StreamStats:
    frames: int = 0
    faces: int = 0
    plates: int = 0
    wall_s: float = 0.0
    stage_s: Dict[str, float] = field(default_factory=dict)

    @property
    def fps(self) -> float:
        return self.frames / self.wall_s if self.wall_s else 0.0


def process_video_stream(
    input_path: str,
    output_path: str,
    engine: DesensitizationEngine,
    batch_size: int = 16,
    fps: Optional[float] = None,
    codec: Optional[str] = None,
    # Decode-side raw-batch queue. Kept shallower than the device stream
    # depth: each slot holds a full RAW batch (~6.2 MB/frame at 1080p).
    # Peak RAM ≈ (prefetch_depth + throughput.STREAM_DEPTH + 2) × batch bytes.
    prefetch_depth: int = 3,
    encode_kwargs: Optional[dict] = None,
    transport: str = "rgb",
) -> StreamStats:
    """Desensitize one video file end to end.

    encode_kwargs: libx265 encoder overrides (preset/bitrate) for the
    output writer; defaults to the reference repack settings
    (video.av.HEVC_DEFAULTS). Ignored for non-HEVC output codecs.

    transport: frame format between codec and device — "rgb" (reference-
    exact pixels end to end), "yuv420" (planar I420 straight from the
    decoder through the engine's I420 program into the encoder: half the
    host-device bytes, no sws RGB pass on either side; needs even frame
    dims — other streams fall back to rgb without losing a frame), or
    "auto" (yuv420 whenever the engine supports it: an engine with
    ``process_batch_yuv``, the fused one; others take rgb)."""
    log = get_logger("stream")
    stats = StreamStats()
    t0 = time.time()

    dec = VideoDecoder(input_path)
    out_fps = fps if fps else (dec.fps or 30.0)
    if codec is None:
        codec = default_codec_for(output_path)

    use_yuv = transport in ("yuv420", "auto") and hasattr(
        engine, "process_batch_yuv"
    )
    if transport == "yuv420" and not use_yuv:
        log.info(
            "transport=yuv420 needs an engine with process_batch_yuv "
            "(fused); falling back to rgb"
        )

    in_q: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
    out_q: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
    errors = []

    def frames_of():
        # Batches are dispatched by shape downstream: I420 frames are 2-D
        # (H*3/2, W) -> process_batch_yuv/write_i420; RGB frames are 3-D.
        # An I420Unsupported probe (odd dims / non-yuv420p source) retains
        # the frame, so switching to the RGB iterator loses nothing.
        if use_yuv:
            try:
                while True:
                    frame = dec.read_i420()
                    if frame is None:
                        return
                    yield frame
            except I420UnsupportedError as e:
                log.info("yuv420 transport unavailable (%s); using rgb", e)
        yield from dec

    def decode_worker():
        try:
            batch = []
            for frame in frames_of():
                batch.append(frame)
                if len(batch) == batch_size:
                    in_q.put(np.stack(batch))
                    batch = []
            if batch:
                in_q.put(np.stack(batch))
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            in_q.put(_SENTINEL)
            dec.close()

    encoder_holder = {}

    def encode_worker():
        try:
            enc = None
            while True:
                item = out_q.get()
                if item is _SENTINEL:
                    break
                if enc is None:
                    if item.ndim == 3:  # planar I420 (B, H*3/2, W)
                        h, w = item.shape[1] * 2 // 3, item.shape[2]
                    else:
                        h, w = item.shape[1:3]
                    kwargs = dict(HEVC_DEFAULTS) if codec == "libx265" else {}
                    if codec == "libx265" and encode_kwargs:
                        kwargs.update(encode_kwargs)
                    elif encode_kwargs:
                        # encode_preset/encode_bitrate are libx265 knobs;
                        # say so rather than silently dropping them when the
                        # output resolves to another codec (e.g. .mp4).
                        log.info(
                            "encode settings %s ignored for codec %s "
                            "(libx265 outputs only)", encode_kwargs, codec,
                        )
                    kwargs["codec"] = codec
                    enc = VideoEncoder(output_path, w, h, fps=out_fps, **kwargs)
                    encoder_holder["enc"] = enc
                if item.ndim == 3:
                    for frame in item:
                        enc.write_i420(frame)
                else:
                    for frame in item:
                        enc.write(frame)
        except Exception as e:  # noqa: BLE001
            errors.append(e)
            # Keep draining so the main loop's out_q.put never blocks on a
            # dead encoder; the error is raised after the join.
            while out_q.get() is not _SENTINEL:
                pass
        finally:
            if encoder_holder.get("enc"):
                encoder_holder["enc"].close()

    t_dec = threading.Thread(target=decode_worker, daemon=True)
    t_enc = threading.Thread(target=encode_worker, daemon=True)
    t_dec.start()
    t_enc.start()

    timer = StageTimer()
    ok = False
    try:
        _run_device_stage(engine, in_q, out_q, stats, timer)
        ok = True
    finally:
        out_q.put(_SENTINEL)  # even on error: never strand the encoder
        if not ok:
            # Device-stage error: the decoder may be blocked on a full in_q
            # with no consumer left — drain until its sentinel so t_dec.join
            # can't hang (timeout-guarded against a wedged decoder).
            try:
                while in_q.get(timeout=10.0) is not _SENTINEL:
                    pass
            except queue.Empty:
                pass
    t_enc.join()
    t_dec.join()
    if errors:
        raise errors[0]

    stats.wall_s = time.time() - t0
    stats.stage_s = timer.report()
    log.debug("stream stages: %s", timer.summary())
    log.info(
        "stream %s -> %s: %d frames, %d faces, %d plates, %.1f fps",
        input_path,
        output_path,
        stats.frames,
        stats.faces,
        stats.plates,
        stats.fps,
    )
    return stats


def _run_device_stage(engine, in_q, out_q, stats, timer):
    if hasattr(engine, "process_stream"):
        # The tiered pipeline: hand the whole batch stream over so its own
        # stages (letterbox | copy and program | boxes and host mosaic)
        # overlap across batches; process_batch would run them in turn.
        def batches():
            while True:
                b = in_q.get()
                if b is _SENTINEL:
                    return
                yield b

        with timer.stage("stream"):
            for res in engine.process_stream(batches()):
                stats.frames += res.frames.shape[0]
                stats.faces += res.num_faces
                stats.plates += res.num_plates
                with timer.stage("wait_encode"):
                    out_q.put(res.frames)
        return
    # The fused engine: keep two batches in flight through dispatch_batch /
    # finalize_batch (each handle holds its pinned input until it is
    # finalized), so the copies and the program overlap the decode and
    # encode threads instead of running batch by batch.
    depth = 2
    pending: "deque" = deque()

    def _finish_one():
        n, handle = pending.popleft()
        with timer.stage("device"):
            res = engine.finalize_batch(handle)
        stats.frames += n
        stats.faces += res.num_faces
        stats.plates += res.num_plates
        with timer.stage("wait_encode"):
            out_q.put(res.frames)

    try:
        while True:
            with timer.stage("wait_decode"):
                batch = in_q.get()
            if batch is _SENTINEL:
                break
            with timer.stage("dispatch"):
                pending.append((batch.shape[0], engine.dispatch_batch(batch)))
            if len(pending) > depth:
                _finish_one()
    finally:
        while pending:
            _finish_one()
