"""The fused desensitization engine: uint8 RGB or planar I420 frames in,
blurred frames of the same form and boxes out, everything between on one
device.

Per batch: I420 frames are converted to RGB for the detectors (cv2-exact,
``ops.yuv.i420_to_rgb_u8``); one cv2-exact letterbox into a shared uint8
canvas (when the installed cv2's rounding is recognised for the geometry;
each detector letterboxes in float otherwise), RetinaFace and YOLOv8 on
that canvas (a plate detector that takes whole frames, RT-DETR, gets the
frames instead), face boxes then plate boxes, and the mosaic kernel pixelating
them in place over the full-resolution frames: the RGB frames, or the I420
planes (Y at ``mosaic_level``, U and V at half resolution).

On CUDA, ``dispatch_batch`` enqueues the host-to-device copy, the program
and the device-to-host copies on the engine's own stream, through pinned
host buffers; ``finalize_batch`` waits for that batch only.

With a ``mesh`` (``parallel/mesh.py``) the engine holds one engine of its
kind per data shard: a replica of both detectors and a stream on each
device. The batch is padded to the mesh's device count by repeating its
last frame and cut into contiguous shards; the calling thread dispatches
every shard, then finalizes every shard, and the results are joined in
order and cut back to the caller's batch. No collective runs: the frames
are independent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

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
from video_desensitization_torch.parallel.mesh import device_guard, pad_batch_to_devices
from video_desensitization_torch.utils.graphs import device_constant
from video_desensitization_torch.utils.timers import span


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
        mesh=None,
    ):
        """anonymizer: "mosaic" (the reference pixelation, through the
        mosaic kernel on CUDA) or "gaussian" (``ops.mosaic.gaussian_blur_boxes``).

        share_letterbox: letterbox the batch once into a shared uint8 canvas
        read by both detectors (face sees it unchanged; the plate program
        re-fills the pad with YOLO's 114 gray) instead of each detector
        resizing the full-resolution batch. Needs the cv2-exact formula for
        the geometry; falls back to per-detector letterboxing otherwise. A
        plate detector whose ``takes_letterbox`` is False (RT-DETR) gets the
        frames, and the canvas is the face's alone.

        mesh: shard every batch over the mesh's ``data`` axis, one engine
        per data shard on its device (see the module docstring); None runs
        on the detectors' device."""
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
            torch.cuda.Stream(self.device)
            if self.device.type == "cuda" and mesh is None else None
        )
        self.last_letterbox = None  # "shared-<formula>" or "per-detector-float"
        self.mesh = mesh
        self._shards: Optional[List[DesensitizationEngine]] = None
        if mesh is not None:
            faces = face_detector.replicate(mesh)
            plates = plate_detector.replicate(mesh) if plate_detector else [None] * len(faces)
            self._shards = [
                DesensitizationEngine(f, p, mosaic_level, anonymizer, share_letterbox)
                for f, p in zip(faces, plates)
            ]

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
        # The plate detector reads the canvas only if it takes letterboxed
        # input at the face's size; one that takes whole frames (RT-DETR's
        # stretch) leaves the canvas to the face alone.
        plate_canvas = plate is not None and getattr(plate, "takes_letterbox", True)
        with span("engine.letterbox"):
            if self.share_letterbox and (
                    not plate_canvas or plate.input_hw == face.input_hw):
                formula = letterbox_canvas_formula((h, w), face.input_hw)
                if formula is not None:
                    canvas = letterbox_canvas_u8(frames_u8, face.input_hw, formula=formula)
                    lb_geom = device_constant(
                        letterbox_params((h, w), face.input_hw), torch.float32, frames_u8.device,
                    ).expand(b, 4)
                    self.last_letterbox = f"shared-{formula}"
        if canvas is None:
            self.last_letterbox = "per-detector-float"
        # On the shared canvas the face letterbox is the identity geometry,
        # so its program applies only the mean-sub; letterbox_correction
        # still maps boxes back through image_shapes.
        face_in = canvas if canvas is not None else frames_u8
        _, face_px, face_keep = face._detect_program(face_in, image_shapes)
        if plate is not None:
            if canvas is not None and plate_canvas:
                plate_px, plate_keep = plate._detect_letterboxed_program(
                    canvas, image_shapes, lb_geom
                )
            else:
                plate_px, plate_keep = plate._detect_program(frames_u8, image_shapes)
        with span("engine.mosaic"):
            fboxes = face_px[..., :4].to(torch.int32)
            if plate is not None:
                boxes = torch.cat([fboxes, plate_px[..., :4].to(torch.int32)], dim=1)
                valid = torch.cat([face_keep, plate_keep], dim=1)
            else:
                plate_px = torch.zeros((b, 1, 6), dtype=torch.float32, device=frames_u8.device)
                plate_keep = torch.zeros((b, 1), dtype=torch.bool, device=frames_u8.device)
                boxes, valid = fboxes, face_keep
            level = self.mosaic_level
            if yuv and self.anonymizer == "gaussian":
                frames.copy_(mosaic_i420_batch(frames, boxes, valid, level,
                                               plane_fn=_gaussian_plane(level)))
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
        test waits on the device. On a mesh every shard is dispatched in
        turn, each with its device current.
        """
        image_shapes = self._image_shapes(frames, image_shapes)
        if self._shards is not None:
            return self._dispatch_shards(np.ascontiguousarray(frames, dtype=np.uint8), image_shapes)
        shapes = torch.as_tensor(np.asarray(image_shapes, np.float32))
        with span("engine.stage_in"):
            frames = np.ascontiguousarray(frames, dtype=np.uint8)
            if self._stream is None:
                host_in = torch.from_numpy(frames.copy())
            else:
                host_in = torch.from_numpy(frames).pin_memory()
                shapes = shapes.pin_memory()
        if self._stream is None:
            return self.program(host_in, shapes), None
        with torch.cuda.stream(self._stream):
            dev_frames = host_in.to(self.device, non_blocking=True)
            dev_shapes = shapes.to(self.device, non_blocking=True)
            outputs = self.program(dev_frames, dev_shapes)
            with span("engine.stage_out"):
                host_out = []
                for t in outputs:
                    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    pinned.copy_(t, non_blocking=True)
                    host_out.append(pinned)
                done = torch.cuda.Event()
                done.record(self._stream)
        # host_in stays referenced until finalize, after its copy completed.
        return host_out, (done, host_in)

    def _image_shapes(self, frames: np.ndarray, image_shapes) -> np.ndarray:
        """The batch's (B, 2) image shapes, the frame shape by default,
        after checking the frames' layout."""
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
            return np.tile(np.array([[h, w]], np.float32), (b, 1))
        if self.share_letterbox and not np.all(np.asarray(image_shapes) == [h, w]):
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
        return image_shapes

    def _dispatch_shards(self, frames: np.ndarray, image_shapes) -> "_ShardedHandle":
        """Pad to the mesh's device count, cut into one contiguous shard a
        data row, and dispatch each shard on its device's engine."""
        n, rows = self.mesh.size, len(self._shards)
        frames_p, b = pad_batch_to_devices(frames, n)
        shapes_p, _ = pad_batch_to_devices(np.asarray(image_shapes, np.float32), n)
        per = frames_p.shape[0] // rows
        handles = []
        for i, shard in enumerate(self._shards):
            with device_guard(shard.device):
                handles.append(shard.dispatch_batch(frames_p[i * per:(i + 1) * per],
                                                    shapes_p[i * per:(i + 1) * per]))
        return _ShardedHandle(handles, b)

    def finalize_batch(self, handle) -> EngineResult:
        """Wait for one dispatched batch and gather its result."""
        if isinstance(handle, _ShardedHandle):
            return self._finalize_shards(handle)
        outputs, pending = handle
        if pending is not None:
            with span("engine.wait"):
                pending[0].synchronize()
        with span("engine.gather"):
            blurred, face_px, face_keep, plate_px, plate_keep = (t.numpy() for t in outputs)
            return _gather_result(blurred, face_px, face_keep, plate_px, plate_keep)

    def _finalize_shards(self, handle: "_ShardedHandle") -> EngineResult:
        """Each shard's result in order, joined and cut to the caller's
        batch (the padding's boxes are not counted)."""
        parts = [shard.finalize_batch(h) for shard, h in zip(self._shards, handle.handles)]
        self.last_letterbox = self._shards[0].last_letterbox
        b = handle.batch
        frames = parts[0].frames if len(parts) == 1 else np.concatenate([p.frames for p in parts])
        face_boxes = [fb for p in parts for fb in p.face_boxes][:b]
        plate_boxes = [pb for p in parts for pb in p.plate_boxes][:b]
        return EngineResult(
            frames=frames[:b],
            face_boxes=face_boxes,
            plate_boxes=plate_boxes,
            num_faces=sum(len(f) for f in face_boxes),
            num_plates=sum(len(p) for p in plate_boxes),
        )

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


@dataclasses.dataclass
class _ShardedHandle:
    handles: list  # each shard's dispatch_batch handle, in shard order
    batch: int  # the caller's batch size, before padding


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
