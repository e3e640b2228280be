"""The tiered pipeline: host letterbox -> device detect -> host mosaic.

The fused engine (``pipeline/engine.py``) moves full-resolution frames to
the device and back and runs detection and the mosaic there. This pipeline
splits the work by bytes moved instead, for hosts whose link to the device
is the scarce resource (it is the CLI's default engine, ``engine =
tiered``):

  host   : letterbox to the detector's content size (cv2, thread pool); for
           a 1080p frame and a 640 detector, 360x640 content instead of
           1080x1920 frames, and half that again as I420 (``transfer``)
  device : ONE program: the content padded to the gray-128 canvas, the face
           program on it (``Retinaface._detect_program``), the plate program
           on the same canvas (``PlateDetector._detect_letterboxed_program``
           re-fills the pad with YOLO's 114 gray), outputs packed into one
           float32 array
  d->h   : that packed array only (kilobytes a batch)
  host   : the reference's cv2 mosaic per box (``ops.mosaic.
           mosaic_host_inplace``), frames in parallel on the thread pool

No mosaic kernel runs on this path: the full-resolution frames never reach
the device. On CUDA each batch's copies and program run on the pipeline's
own stream through pinned buffers; ``finalize`` waits on that batch's event
only. ``process_stream`` keeps several batches in flight across a dispatch
thread and a finalize thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.ops.image import (
    PAD_VALUE,
    _pad_canvas,
    letterbox_geometry,
    letterbox_params,
)
from video_desensitization_torch.ops.mosaic import (
    gaussian_blur_host_inplace,
    mosaic_host_inplace,
)

# Batches in flight per stage boundary in ``process_stream``, and the
# threads of the host pool that letterboxes and mosaics. These are the JAX
# package's defaults, kept for parity; they have not been tuned for a CUDA
# card.
STREAM_DEPTH = 5
LETTERBOX_WORKERS = 6


@dataclasses.dataclass
class TieredResult:
    frames: np.ndarray  # blurred uint8 (B, H, W, 3), host-mosaicked
    face_boxes: List[List[List[float]]]
    plate_boxes: List[List[List[float]]]
    num_faces: int
    num_plates: int


def letterbox_u8(frame: np.ndarray, dst_hw: Tuple[int, int]) -> np.ndarray:
    """Reference-geometry letterbox onto a uint8 gray-128 canvas (cv2)."""
    import cv2

    ih, iw = frame.shape[:2]
    h, w = dst_hw
    nh, nw, top, left = letterbox_params((ih, iw), (h, w))
    canvas = np.full((h, w, 3), 128, np.uint8)
    canvas[top : top + nh, left : left + nw] = cv2.resize(frame, (nw, nh))
    return canvas


def resize_content_u8(frame: np.ndarray, dst_hw: Tuple[int, int]) -> np.ndarray:
    """Resize to the letterbox content size, without the gray canvas (cv2).
    The device pads it to ``letterbox_u8``'s canvas exactly."""
    import cv2

    ih, iw = frame.shape[:2]
    nh, nw, _, _ = letterbox_params((ih, iw), dst_hw)
    return cv2.resize(frame, (nw, nh))


def rgb_to_i420(content: np.ndarray) -> np.ndarray:
    """RGB content -> planar I420 bytes, (nh*3/2, nw) uint8 (cv2 BT.601)."""
    import cv2

    return cv2.cvtColor(content, cv2.COLOR_RGB2YUV_I420)


def i420_to_rgb_device(yuv: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """I420 -> RGB float32 in [0, 255], unrounded: video-range BT.601,
    R = 1.1644(Y-16) + 1.596(V-128), G = 1.1644(Y-16) - 0.391(U-128) -
    0.813(V-128), B = 1.1644(Y-16) + 2.018(U-128), chroma upsampled by 2x
    replication. This is the tiered pipeline's conversion, not the
    cv2-exact ``ops.yuv.i420_to_rgb_u8`` of the fused engine. The U/V
    planes are cut at flat offsets, so any even nh works.
    yuv: (B, nh*3/2, nw) uint8 -> (B, nh, nw, 3) float32."""
    b = yuv.shape[0]
    y = yuv[:, :nh, :].to(torch.float32)
    h2, w2 = nh // 2, nw // 2
    tail = yuv[:, nh:, :].reshape(b, h2 * nw)
    u = tail[:, : h2 * w2].reshape(b, h2, w2).to(torch.float32) - 128.0
    v = tail[:, h2 * w2 :].reshape(b, h2, w2).to(torch.float32) - 128.0
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    yy = 1.1644 * (y - 16.0)
    r = yy + 1.596 * v
    g = yy - 0.391 * u - 0.813 * v
    bl = yy + 2.018 * u
    return torch.clamp(torch.stack([r, g, bl], dim=-1), 0.0, 255.0)


class TieredPipeline:
    def __init__(
        self,
        face_detector: Retinaface,
        plate_detector=None,
        mosaic_level: int = 8,
        transfer: str = "rgb",
        anonymizer: str = "mosaic",
    ):
        """transfer: "rgb" sends (nh, nw, 3) letterbox content; "yuv420"
        sends planar I420 (nh*3/2, nw), half the bytes, which the device
        converts back with ``i420_to_rgb_device``; it needs even content
        dims. anonymizer: "mosaic" (the reference pixelation, bit-exact) or
        "gaussian" (``ops.mosaic.gaussian_blur_host_inplace``)."""
        if anonymizer == "gaussian":
            self._blur = gaussian_blur_host_inplace
        elif anonymizer == "mosaic":
            self._blur = lambda im, bx: mosaic_host_inplace(im, bx, mosaic_level)
        else:
            raise ValueError(
                f"anonymizer must be 'mosaic' or 'gaussian', got {anonymizer!r}"
            )
        if transfer not in ("rgb", "yuv420"):
            raise ValueError(f"transfer must be 'rgb' or 'yuv420', got {transfer!r}")
        self.face = face_detector
        self.plate = plate_detector
        self.device = face_detector.device
        if plate_detector is not None and plate_detector.device != self.device:
            raise ValueError("face and plate detectors must share one device")
        self.mosaic_level = mosaic_level
        self.anonymizer = anonymizer
        self.input_hw = face_detector.input_hw
        self.transfer = transfer
        self._pool = ThreadPoolExecutor(max_workers=LETTERBOX_WORKERS)
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

    @torch.inference_mode()
    def program(self, content: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
        """The device program. content: (B, nh, nw, 3) uint8 RGB, or
        (B, nh*3/2, nw) uint8 I420 with ``transfer = "yuv420"``; aux: (B, 6)
        float32 [image_shapes (2) | letterbox geometry (4)]. Returns ONE
        (B, Kf*16 + Kp*7) float32 array: face rows, face keep, plate rows,
        plate keep (``_unpack``), so one copy brings back a batch's boxes."""
        face, plate = self.face, self.plate
        h, w = self.input_hw
        image_shapes, lb_geom = aux[:, :2], aux[:, 2:]
        if self.transfer == "yuv420":
            _, rows15, cw = content.shape
            ch = rows15 * 2 // 3
            content = i420_to_rgb_device(content, ch, cw)
        else:
            _, ch, cw, _ = content.shape
        # uint8 for rgb, float32 for yuv420: the detectors take either.
        canvas = _pad_canvas(content, (h, w), (h - ch) // 2, (w - cw) // 2, PAD_VALUE)
        b = canvas.shape[0]
        _, face_px, face_keep = face._detect_program(canvas, image_shapes)
        if plate is not None:
            plate_px, plate_keep = plate._detect_letterboxed_program(
                canvas, image_shapes, lb_geom
            )
        else:
            plate_px = torch.zeros((b, 1, 6), dtype=torch.float32, device=canvas.device)
            plate_keep = torch.zeros((b, 1), dtype=torch.bool, device=canvas.device)
        return torch.cat(
            [
                face_px.reshape(b, -1),
                face_keep.to(torch.float32),
                plate_px.reshape(b, -1),
                plate_keep.to(torch.float32),
            ],
            dim=1,
        )

    def _unpack(self, flat: np.ndarray):
        """Inverse of the program's output packing -> (face_px, face_keep,
        plate_px, plate_keep) numpy views."""
        b = flat.shape[0]
        kf = self.face.max_detections
        kp = self.plate.max_detections if self.plate is not None else 1
        o1 = kf * 15
        o2 = o1 + kf
        o3 = o2 + kp * 6
        return (
            flat[:, :o1].reshape(b, kf, 15),
            flat[:, o1:o2] > 0.5,
            flat[:, o2:o3].reshape(b, kp, 6),
            flat[:, o3:] > 0.5,
        )

    # -- stages ---------------------------------------------------------------
    def letterbox_batch(self, frames: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 -> letterbox content batch on the host pool:
        (B, nh, nw, 3) uint8 RGB, or (B, nh*3/2, nw) planar I420."""
        if self.transfer == "yuv420":
            def one(f):
                c = resize_content_u8(f, self.input_hw)
                nh, nw = c.shape[:2]
                if nh % 2 or nw % 2:
                    raise ValueError(
                        f"yuv420 transfer needs even letterbox content dims, "
                        f"got {nh}x{nw}; use transfer='rgb' for this source"
                    )
                return rgb_to_i420(c)
            return np.stack(list(self._pool.map(one, frames)))
        return np.stack(
            list(self._pool.map(lambda f: resize_content_u8(f, self.input_hw), frames))
        )

    def dispatch(self, content, image_shapes: np.ndarray):
        """Enqueue the copies and the program of one batch; returns a handle
        for :meth:`finalize`. ``content`` is a host array. On CUDA everything
        runs on the pipeline's stream from whichever thread calls this (the
        current stream is per thread); the pinned buffers stay referenced by
        the handle until its event has completed."""
        geom = letterbox_geometry(image_shapes, self.input_hw)
        aux = torch.from_numpy(
            np.concatenate([np.asarray(image_shapes, np.float32), geom], axis=1)
        )
        content = torch.from_numpy(np.ascontiguousarray(content))
        if self._stream is None:
            return self.program(content, aux), None
        pinned = (content.pin_memory(), aux.pin_memory())
        with torch.cuda.stream(self._stream):
            packed = self.program(
                pinned[0].to(self.device, non_blocking=True),
                pinned[1].to(self.device, non_blocking=True),
            )
            host_out = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host_out.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return host_out, (done, pinned)

    def finalize(self, frames: np.ndarray, handle) -> TieredResult:
        """Wait for one dispatched batch's boxes and mosaic its frames on
        the host pool: each frame copied once into a fresh output, then its
        boxes (faces, then plates, cast to int64: truncation toward zero, as
        the fused engine's int32 cast) blurred in place."""
        packed, pending = handle
        if pending is not None:
            pending[0].synchronize()
        face_px, face_keep, plate_px, plate_keep = self._unpack(packed.numpy())
        b = frames.shape[0]
        face_boxes, plate_boxes, merged_all = [], [], []
        for i in range(b):
            fb = face_px[i][face_keep[i]][:, :4]
            pb = plate_px[i][plate_keep[i]][:, :4]
            face_boxes.append(fb.tolist())
            plate_boxes.append(pb.tolist())
            merged_all.append(np.concatenate([fb, pb], axis=0).astype(np.int64).tolist())
        out = np.empty_like(frames)

        def _one(i):
            np.copyto(out[i], frames[i])
            self._blur(out[i], merged_all[i])

        list(self._pool.map(_one, range(b)))
        return TieredResult(
            frames=out,
            face_boxes=face_boxes,
            plate_boxes=plate_boxes,
            num_faces=int(face_keep.sum()),
            num_plates=int(plate_keep.sum()),
        )

    # -- the fused engine's batch interface -----------------------------------
    def dispatch_batch(self, frames: np.ndarray):
        """Letterbox on the host pool, then enqueue the copies and the
        program without waiting; returns a handle for :meth:`finalize_batch`."""
        b, h, w, _ = frames.shape
        shapes = np.tile(np.array([[h, w]], np.float32), (b, 1))
        return frames, self.dispatch(self.letterbox_batch(frames), shapes)

    def finalize_batch(self, handle) -> TieredResult:
        frames, pending = handle
        return self.finalize(frames, pending)

    def process_batch(self, frames: np.ndarray) -> TieredResult:
        """frames: uint8 (B, H, W, 3) RGB at native resolution."""
        return self.finalize_batch(self.dispatch_batch(frames))

    # -- pipelined stream -----------------------------------------------------
    def process_stream(self, batches: Iterable[np.ndarray]) -> Iterator[TieredResult]:
        """Pipeline uint8 NHWC batches through overlapped stages:

          caller's thread : letterbox batch N+1 (cv2 pool, GIL released)
          dispatch thread : the copies and the program of batch N, in order
          finalize thread : wait for batch N-1's boxes and mosaic it

        Keeps up to ``STREAM_DEPTH`` batches in flight at each stage
        boundary; results come back in order.
        """
        work_q: "queue.Queue" = queue.Queue(maxsize=STREAM_DEPTH)
        out_q: "queue.Queue" = queue.Queue()
        finalizer = ThreadPoolExecutor(max_workers=1)
        done_marker = object()

        def dispatcher():
            try:
                while True:
                    item = work_q.get()
                    if item is done_marker:
                        out_q.put(done_marker)
                        return
                    frames, lb, shapes = item
                    handle = self.dispatch(lb, shapes)
                    out_q.put(finalizer.submit(self.finalize, frames, handle))
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                out_q.put(e)

        t = threading.Thread(target=dispatcher, daemon=True)
        t.start()
        in_flight = 0

        def _drain_one():
            nonlocal in_flight
            got = out_q.get()
            if isinstance(got, BaseException):
                raise got
            if got is done_marker:
                raise RuntimeError("process_stream: dispatcher ended early")
            in_flight -= 1
            return got.result()

        try:
            for frames in batches:
                b, h, w, _ = frames.shape
                shapes = np.tile(np.array([[h, w]], np.float32), (b, 1))
                work_q.put((frames, self.letterbox_batch(frames), shapes))
                in_flight += 1
                if in_flight > STREAM_DEPTH:
                    yield _drain_one()
            work_q.put(done_marker)
            while in_flight:
                yield _drain_one()
            got = out_q.get()
            if isinstance(got, BaseException):
                raise got
        finally:
            # Unblock the dispatcher on early generator close.
            try:
                work_q.put_nowait(done_marker)
            except queue.Full:
                pass
            finalizer.shutdown(wait=False)
