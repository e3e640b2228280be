"""Multi-camera co-batching: frames from many streams share device batches.

The reference fans record topics across a thread pool but runs each
video's detection separately (recordDeal.so's per-topic
ThreadPoolExecutor; SURVEY.md §2). Here every camera stream is decoded
concurrently on the host, their frames are co-batched into one stream of
device batches (frames are independent, so a batch may mix cameras), and
the blurred frames are routed back to per-camera encoders: one engine, one
device pipeline, N codecs.

Frames are grouped by their full shape (a camera's resolution is fixed, so
each camera's order survives FIFO batching within its group). Partial
batches at the end are padded to ``batch_size`` by repeating the last
frame, as in the JAX package, so every dispatch has the batch shape of the
rest.

Threads, and where the CUDA calls are made:

  decode threads   : one per camera, codec only
  routing (caller) : groups frames; the tiered engine's ``letterbox_batch``
  dispatch thread  : ``dispatch`` / ``dispatch_batch`` (copies and program,
                     on the engine's own stream, entered from this thread)
  finalizer        : ONE worker, ``finalize`` / ``finalize_batch`` in FIFO
                     order (each waits on its own batch's event only)
  encode threads   : one per camera, codec only

A per-camera decode or encode failure marks that camera failed and drops
its stream while the others go on; an engine failure sets the abort flag,
unblocks every queue and re-raises in the caller. The fused engine's
results are numpy views of pinned host buffers: each view holds its
buffer, so a buffer lives until the last of its frames left the encoder
queue.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from video_desensitization_torch.pipeline.throughput import STREAM_DEPTH
from video_desensitization_torch.utils.logging import get_logger
from video_desensitization_torch.video.av import (
    HEVC_DEFAULTS,
    I420UnsupportedError,
    VideoDecoder,
    VideoEncoder,
    default_codec_for,
)

_DONE = object()
# Frames waiting in the decoded queue and in each camera's encoder queue
# (the JAX package's value); STREAM_DEPTH batches are in flight.
QUEUE_DEPTH = 64


@dataclass
class CameraStats:
    frames: int = 0
    faces: int = 0
    plates: int = 0
    # Set when this camera's decode/encode failed; the stream's output is
    # incomplete and must not be marked done. Other cameras keep going.
    error: Optional[str] = None


def _abortable_put(q: "queue.Queue", item, abort: threading.Event) -> bool:
    while not abort.is_set():
        try:
            q.put(item, timeout=0.25)
            return True
        except queue.Full:
            continue
    return False


def process_videos_cobatched(
    jobs: Dict[str, Tuple[str, str]],
    engine,
    batch_size: int = 16,
    fps: Optional[float] = None,
    encode_kwargs: Optional[dict] = None,
    transport: str = "rgb",
    detect_interval: int = 1,
    track_coast: int = 3,
) -> Dict[str, CameraStats]:
    """Desensitize many videos through one shared stream of device batches.

    jobs: {camera_name: (input_path, output_path)}. Returns per-camera
    stats. The encoder codec follows each output's extension
    (``video.av.default_codec_for``); ``encode_kwargs`` overrides the
    libx265 writers' preset and bitrate (default: the reference's repack
    settings).

    transport: "rgb", "yuv420" or "auto". With an engine that has
    ``process_batch_yuv`` (the fused one), yuv420 and auto decode each
    camera as planar I420 straight through the engine's I420 program into
    I420 encoders. Frames carry their form in their shape (I420 frames are
    2-D), so a camera with no I420 form (odd sizes) falls back to RGB alone.

    detect_interval > 1 tracks each camera (``pipeline/tracking.py``): only
    every Nth frame of each camera is co-batched for detection, and the gap
    frames are covered by that camera's propagated and
    ``track_coast``-coasted keyframe boxes, blurred on the host by
    ``tracking.BLUR_WORKERS`` threads.
    """
    log = get_logger("multicam")
    use_yuv = transport in ("yuv420", "auto") and hasattr(
        engine, "process_batch_yuv"
    )
    frame_q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
    enc_qs: Dict[str, "queue.Queue"] = {
        cam: queue.Queue(maxsize=QUEUE_DEPTH) for cam in jobs
    }
    stats = {cam: CameraStats() for cam in jobs}
    abort = threading.Event()  # engine and other fatal errors only
    meta: Dict[str, dict] = {}

    trackers = None
    blur_pool: Optional[ThreadPoolExecutor] = None
    if detect_interval > 1:
        from video_desensitization_torch.pipeline.tracking import BLUR_WORKERS, CameraTracker

        blur_pool = ThreadPoolExecutor(
            max_workers=BLUR_WORKERS, thread_name_prefix="vdt-mctrack"
        )
        trackers = {
            cam: CameraTracker(
                detect_interval,
                blur_pool,
                level=getattr(engine, "mosaic_level", 8),
                anonymizer=getattr(engine, "anonymizer", "mosaic"),
                coast=track_coast,
            )
            for cam in jobs
        }

    def frames_of(cam: str, dec: VideoDecoder):
        if use_yuv:
            try:
                while True:
                    f = dec.read_i420()
                    if f is None:
                        return
                    yield f
            except I420UnsupportedError as e:
                # The probed frame is retained (video.av's contract): the
                # RGB iterator goes on from it, and downstream routes every
                # frame by its own shape.
                log.info("camera %s: yuv420 unavailable (%s); rgb", cam, e)
        for frame in dec:
            yield frame

    def decode_worker(cam: str, path: str):
        try:
            with VideoDecoder(path) as dec:
                meta[cam] = {"fps": dec.fps or 30.0}
                for frame in frames_of(cam, dec):
                    if not _abortable_put(frame_q, (cam, frame), abort):
                        return
        except Exception as e:  # noqa: BLE001 - this camera fails alone
            log.error("decode failed for camera %s: %s", cam, e)
            stats[cam].error = f"decode: {e}"
        finally:
            _abortable_put(frame_q, (cam, _DONE), abort)

    def encode_worker(cam: str, out_path: str):
        enc = None
        try:
            while True:
                item = enc_qs[cam].get()
                if item is _DONE:
                    break
                if enc is None:
                    if item.ndim == 2:  # planar I420 (H*3/2, W)
                        h, w = item.shape[0] * 2 // 3, item.shape[1]
                    else:
                        h, w = item.shape[:2]
                    c = default_codec_for(out_path)
                    kwargs = dict(HEVC_DEFAULTS) if c == "libx265" else {}
                    if c == "libx265" and encode_kwargs:
                        kwargs.update(encode_kwargs)
                    elif encode_kwargs:
                        log.info(
                            "encode settings %s ignored for camera %s "
                            "codec %s (libx265 outputs only)",
                            encode_kwargs, cam, c,
                        )
                    kwargs["codec"] = c
                    enc = VideoEncoder(
                        out_path, w, h, fps=fps or meta[cam]["fps"], **kwargs
                    )
                if item.ndim == 2:
                    enc.write_i420(item)
                else:
                    enc.write(item)
        except Exception as e:  # noqa: BLE001 - this camera fails alone
            log.error("encode failed for camera %s: %s", cam, e)
            stats[cam].error = stats[cam].error or f"encode: {e}"
            # Keep draining so producers never block on a dead encoder.
            while enc_qs[cam].get() is not _DONE:
                pass
        finally:
            if enc is not None:
                try:
                    enc.close()
                except Exception as e:  # noqa: BLE001
                    log.error("encoder close failed for camera %s: %s", cam, e)
                    stats[cam].error = stats[cam].error or f"encode close: {e}"

    dec_threads = [
        threading.Thread(target=decode_worker, args=(cam, src), daemon=True)
        for cam, (src, _) in jobs.items()
    ]
    enc_threads = [
        threading.Thread(target=encode_worker, args=(cam, dst), daemon=True)
        for cam, (_, dst) in jobs.items()
    ]
    for t in dec_threads + enc_threads:
        t.start()

    tiered = hasattr(engine, "dispatch") and hasattr(engine, "finalize")
    finalizer = ThreadPoolExecutor(max_workers=1)
    # The copies and the program are enqueued from a thread of their own,
    # so the routing loop's letterbox overlaps them.
    dispatch_q: "queue.Queue" = queue.Queue(maxsize=STREAM_DEPTH)
    result_q: "queue.Queue" = queue.Queue()

    def dispatch_worker():
        try:
            while True:
                item = dispatch_q.get()
                if item is _DONE:
                    result_q.put(_DONE)
                    return
                done_items, batch, lb, shapes = item
                if tiered:
                    fut = engine.dispatch(lb, shapes)
                    result_q.put(
                        (done_items, finalizer.submit(engine.finalize, batch, fut))
                    )
                elif hasattr(engine, "dispatch_batch"):
                    # The fused engine (RGB or I420 batches, by rank): the
                    # single-worker finalizer waits for them in FIFO order.
                    handle = engine.dispatch_batch(batch)
                    result_q.put(
                        (done_items, finalizer.submit(engine.finalize_batch, handle))
                    )
                else:
                    result_q.put(
                        (done_items, finalizer.submit(engine.process_batch, batch))
                    )
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            result_q.put(e)
            while dispatch_q.get() is not _DONE:  # drain; never block main
                pass
            result_q.put(_DONE)

    dispatch_thread = threading.Thread(target=dispatch_worker, daemon=True)
    dispatch_thread.start()
    in_flight = 0

    def submit(items: List[Tuple[str, np.ndarray]]):
        nonlocal in_flight
        batch = np.stack([f for _, f in items])
        n = batch.shape[0]
        if n < batch_size:  # pad: every dispatch has the batch shape
            batch = np.concatenate(
                [batch, np.repeat(batch[-1:], batch_size - n, axis=0)]
            )
        if tiered:
            b, h, w, _ = batch.shape
            shapes = np.tile(np.array([[h, w]], np.float32), (b, 1))
            lb = engine.letterbox_batch(batch)
            dispatch_q.put((items, batch, lb, shapes))
        else:
            dispatch_q.put((items, batch, None, None))
        in_flight += 1

    def drain_one():
        nonlocal in_flight
        got = result_q.get()
        if isinstance(got, BaseException):
            raise got
        assert got is not _DONE
        in_flight -= 1
        done_items, fut = got
        route(done_items, fut.result())

    def emit(cam, frame, n_faces, n_plates) -> bool:
        if not _abortable_put(enc_qs[cam], frame, abort):
            return False
        stats[cam].frames += 1
        stats[cam].faces += n_faces
        stats[cam].plates += n_plates
        return True

    def route(done_items, res):
        for (cam, _), blurred, fb, pb in zip(
            done_items, res.frames, res.face_boxes, res.plate_boxes
        ):
            if stats[cam].error:  # dead camera: its encoder is draining
                continue
            if trackers is not None:
                # The camera's oldest outstanding keyframe: emit whatever
                # segments became ready (keyframe and covered gap frames).
                for r in trackers[cam].push_detection(blurred, fb, pb):
                    if not emit(cam, r.frames[0], r.num_faces, r.num_plates):
                        return
                continue
            if not emit(cam, blurred, len(fb), len(pb)):
                return

    groups: Dict[Tuple[int, ...], List[Tuple[str, np.ndarray]]] = {}
    live = set(jobs)
    try:
        while live and not abort.is_set():
            try:
                cam, item = frame_q.get(timeout=0.25)
            except queue.Empty:
                continue  # re-check abort/live (a dead decoder can't put _DONE)
            if item is _DONE:
                live.discard(cam)
                if not live:
                    for shape in list(groups):
                        if groups[shape]:
                            submit(groups.pop(shape))
                continue
            if stats[cam].error:
                continue  # dead camera: drop its queued frames
            if trackers is not None and not trackers[cam].push_frame(item):
                continue  # gap frame: buffered, covered at emission
            # The FULL shape is the key: I420 (H*3/2, W) and RGB (H, W, 3)
            # frames never share a batch, even where leading dims collide.
            key = item.shape
            groups.setdefault(key, []).append((cam, item))
            if len(groups[key]) >= batch_size:
                submit(groups.pop(key))
            while in_flight > STREAM_DEPTH:
                drain_one()
        while in_flight and not abort.is_set():
            drain_one()
        # Stream tails: every detection has been routed; emit each camera's
        # last segment (last-sighting cover across its remaining gap).
        if trackers is not None and not abort.is_set():
            for cam, tr in trackers.items():
                if stats[cam].error:
                    continue
                for r in tr.flush():
                    if not emit(cam, r.frames[0], r.num_faces, r.num_plates):
                        break
    except Exception:
        # An engine failure poisons every batch in flight.
        abort.set()
        raise
    finally:
        dispatch_q.put(_DONE)
        dispatch_thread.join()
        finalizer.shutdown(wait=True)
        if blur_pool is not None:
            blur_pool.shutdown(wait=True)
        for q_ in enc_qs.values():
            _abortable_put(q_, _DONE, abort) or q_.put(_DONE)
        for t in enc_threads:
            t.join()
        for t in dec_threads:
            t.join()
    log.info(
        "multicam done: %s",
        {c: (s.frames, s.faces, s.plates, s.error) for c, s in stats.items()},
    )
    return stats
