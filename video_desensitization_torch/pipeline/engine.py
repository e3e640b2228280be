"""The fused desensitization engine: uint8 RGB or planar I420 frames in,
blurred frames of the same form and boxes out, everything between on one
device.

Per batch: I420 frames are converted to RGB for the detectors (cv2-exact,
``ops.yuv.i420_to_rgb_u8``); one cv2-exact letterbox into a shared uint8
canvas (when the installed cv2's rounding is recognised for the geometry;
each detector letterboxes in float otherwise), RetinaFace and YOLOv8 on
that canvas, face boxes then plate boxes, and the mosaic kernel pixelating
them in place over the full-resolution frames: the RGB frames, or the I420
planes (Y at ``mosaic_level``, U and V at half resolution).

On CUDA, ``dispatch_batch`` enqueues the host-to-device copy, the program
and the device-to-host copies on the engine's own stream, through pinned
host buffers; ``finalize_batch`` waits for that batch only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.ops.cuda_mosaic import (
    mosaic_boxes_batch_cuda_,
    mosaic_i420_batch_cuda_,
)
from video_desensitization_torch.ops.image import (
    letterbox_canvas_formula,
    letterbox_canvas_u8,
    letterbox_params,
)
from video_desensitization_torch.ops.mosaic import (
    gaussian_blur_boxes,
    i420_frame_hw,
    mosaic_i420_batch,
)
from video_desensitization_torch.ops.yuv import i420_to_rgb_u8


@dataclasses.dataclass
class EngineResult:
    frames: np.ndarray  # blurred uint8: (B, H, W, 3) RGB, or (B, H*3/2, W) I420
    face_boxes: list  # per-image list of [x1, y1, x2, y2] float pixel boxes
    plate_boxes: list
    num_faces: int
    num_plates: int


class DesensitizationEngine:
    def __init__(
        self,
        face_detector: Retinaface,
        plate_detector: Optional[Any] = None,
        mosaic_level: int = 8,
        anonymizer: str = "mosaic",
        share_letterbox: bool = True,
    ):
        """anonymizer: "mosaic" (the reference pixelation, through the
        mosaic kernel on CUDA) or "gaussian" (``ops.mosaic.gaussian_blur_boxes``).

        share_letterbox: letterbox the batch once into a shared uint8 canvas
        read by both detectors (face sees it unchanged; the plate program
        re-fills the pad with YOLO's 114 gray) instead of each detector
        resizing the full-resolution batch. Needs the cv2-exact formula for
        the geometry; falls back to per-detector letterboxing otherwise."""
        if anonymizer not in ("mosaic", "gaussian"):
            raise ValueError(f"unknown anonymizer {anonymizer!r}")
        self.face = face_detector
        self.plate = plate_detector
        self.device = face_detector.device
        if plate_detector is not None and plate_detector.device != self.device:
            raise ValueError("face and plate detectors must share one device")
        self.mosaic_level = mosaic_level
        self.anonymizer = anonymizer
        self.share_letterbox = share_letterbox
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        self.last_letterbox = None  # "shared-<formula>" or "per-detector-float"

    @torch.inference_mode()
    def program(self, frames: torch.Tensor, image_shapes: torch.Tensor):
        """(B, H, W, 3) RGB or (B, H*3/2, W) I420 uint8 device frames ->
        (blurred, face_px, face_keep, plate_px, plate_keep). The frames are
        blurred IN PLACE and returned as ``blurred``; the detectors see I420
        frames through a temporary RGB copy."""
        face, plate = self.face, self.plate
        yuv = frames.ndim == 3
        if yuv:
            h, w = i420_frame_hw(frames.shape)
            frames_u8 = i420_to_rgb_u8(frames, h, w)
        else:
            frames_u8 = frames
        b, h, w, _ = frames_u8.shape
        canvas = None
        if self.share_letterbox and (plate is None or plate.input_hw == face.input_hw):
            formula = letterbox_canvas_formula((h, w), face.input_hw)
            if formula is not None:
                canvas = letterbox_canvas_u8(frames_u8, face.input_hw, formula=formula)
                lb_geom = torch.tensor(
                    letterbox_params((h, w), face.input_hw),
                    dtype=torch.float32, device=frames_u8.device,
                ).expand(b, 4)
                self.last_letterbox = f"shared-{formula}"
        if canvas is None:
            self.last_letterbox = "per-detector-float"
        # On the shared canvas the face letterbox is the identity geometry,
        # so its program applies only the mean-sub; letterbox_correction
        # still maps boxes back through image_shapes.
        face_in = canvas if canvas is not None else frames_u8
        _, face_px, face_keep = face._detect_program(face_in, image_shapes)
        fboxes = face_px[..., :4].to(torch.int32)
        if plate is not None:
            if canvas is not None:
                plate_px, plate_keep = plate._detect_letterboxed_program(
                    canvas, image_shapes, lb_geom
                )
            else:
                plate_px, plate_keep = plate._detect_program(frames_u8, image_shapes)
            boxes = torch.cat([fboxes, plate_px[..., :4].to(torch.int32)], dim=1)
            valid = torch.cat([face_keep, plate_keep], dim=1)
        else:
            plate_px = torch.zeros((b, 1, 6), dtype=torch.float32, device=frames_u8.device)
            plate_keep = torch.zeros((b, 1), dtype=torch.bool, device=frames_u8.device)
            boxes, valid = fboxes, face_keep
        level = self.mosaic_level
        if yuv and self.anonymizer == "gaussian":
            frames.copy_(mosaic_i420_batch(frames, boxes, valid, level, plane_fn=_gaussian_plane(level)))
        elif yuv:
            mosaic_i420_batch_cuda_(frames, boxes, valid, level)
        elif self.anonymizer == "gaussian":
            frames.copy_(gaussian_blur_boxes(frames, boxes, valid))
        else:
            mosaic_boxes_batch_cuda_(frames, boxes, valid, level)
        return frames, face_px, face_keep, plate_px, plate_keep

    def dispatch_batch(
        self, frames: np.ndarray, image_shapes: Optional[np.ndarray] = None
    ):
        """Enqueue one batch and return a handle for :meth:`finalize_batch`.

        frames: uint8 (B, H, W, 3) RGB, or (B, H*3/2, W) planar I420 with H
        and W even, at native resolution, routed by rank. On CUDA the copies
        and the program run on the engine's stream; only the NMS convergence
        test waits on the device.
        """
        if frames.ndim == 3:
            b = frames.shape[0]
            h, w = i420_frame_hw(frames.shape)
        elif frames.ndim == 4 and frames.shape[-1] == 3:
            b, h, w, _ = frames.shape
        else:
            raise ValueError(
                f"expected (B, H, W, 3) RGB or (B, H*3/2, W) I420 frames, got {frames.shape}"
            )
        if image_shapes is None:
            image_shapes = np.tile(np.array([[h, w]], np.float32), (b, 1))
        elif self.share_letterbox and not np.all(np.asarray(image_shapes) == [h, w]):
            # The shared canvas is built from the frame-buffer shape; per-frame
            # image_shapes only drive the inverse box mapping. Content smaller
            # than the buffer would be letterboxed with its padding on the
            # shared path and not on the per-detector path: refuse.
            raise ValueError(
                "share_letterbox=True requires image_shapes == the frame "
                f"buffer shape {[h, w]}; got {np.asarray(image_shapes)[0]}. "
                "Crop/letterbox on the host first, or construct the engine "
                "with share_letterbox=False."
            )
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        shapes = torch.as_tensor(np.asarray(image_shapes, np.float32))
        if self._stream is None:
            return self.program(torch.from_numpy(frames.copy()), shapes), None
        host_in = torch.from_numpy(frames).pin_memory()
        with torch.cuda.stream(self._stream):
            dev_frames = host_in.to(self.device, non_blocking=True)
            dev_shapes = shapes.pin_memory().to(self.device, non_blocking=True)
            outputs = self.program(dev_frames, dev_shapes)
            host_out = []
            for t in outputs:
                pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                pinned.copy_(t, non_blocking=True)
                host_out.append(pinned)
            done = torch.cuda.Event()
            done.record(self._stream)
        # host_in stays referenced until finalize, after its copy completed.
        return host_out, (done, host_in)

    def finalize_batch(self, handle) -> EngineResult:
        """Wait for one dispatched batch and gather its result."""
        outputs, pending = handle
        if pending is not None:
            pending[0].synchronize()
        blurred, face_px, face_keep, plate_px, plate_keep = (t.numpy() for t in outputs)
        return _gather_result(blurred, face_px, face_keep, plate_px, plate_keep)

    def process_batch(
        self, frames: np.ndarray, image_shapes: Optional[np.ndarray] = None
    ) -> EngineResult:
        """frames: uint8 (B, H, W, 3) RGB at native resolution."""
        if frames.ndim != 4:
            raise ValueError(f"expected (B, H, W, 3) RGB frames, got {frames.shape}")
        return self.finalize_batch(self.dispatch_batch(frames, image_shapes))

    def process_batch_yuv(
        self, yuv_frames: np.ndarray, image_shapes: Optional[np.ndarray] = None
    ) -> EngineResult:
        """yuv_frames: uint8 (B, H*3/2, W) planar I420 at native resolution,
        as a video decoder gives them, H and W even. The detectors run on
        the cv2-exact RGB conversion; the mosaic goes on the planes (Y at
        full resolution, U and V at half, ``ops.mosaic.mosaic_i420_batch``).
        ``EngineResult.frames`` is the blurred I420 batch, ready for an
        encoder."""
        if yuv_frames.ndim != 3:
            raise ValueError(f"expected (B, H*3/2, W) I420 frames, got {yuv_frames.shape}")
        return self.finalize_batch(self.dispatch_batch(yuv_frames, image_shapes))


def _gaussian_plane(level: int):
    """The gaussian anonymizer for one I420 plane: the chroma planes, at
    half the mosaic level, get half the sigma and radius, so the blur covers
    the same full-resolution footprint as on Y."""
    def plane_fn(planes, boxes, valid, plane_level):
        s = plane_level / max(1, level)
        return gaussian_blur_boxes(
            planes, boxes, valid, sigma=6.0 * s, kernel_radius=max(1, round(12 * s))
        )
    return plane_fn


def _gather_result(frames, face_px, face_keep, plate_px, plate_keep) -> EngineResult:
    n = frames.shape[0]
    return EngineResult(
        frames=frames,
        face_boxes=[face_px[i][face_keep[i]][:, :4].tolist() for i in range(n)],
        plate_boxes=[plate_px[i][plate_keep[i]][:, :4].tolist() for i in range(n)],
        num_faces=int(face_keep.sum()),
        num_plates=int(plate_keep.sum()),
    )
