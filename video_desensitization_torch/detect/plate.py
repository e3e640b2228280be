"""Licence-plate detector: YOLOv8 forward, decode and NMS on one device.

Preprocessing follows ultralytics: aspect-preserving resize onto a 114-gray
canvas, /255; boxes map back to original pixels by the exact inverse
letterbox, clipped to the image. With a ``mesh`` the batch is padded,
sharded and run on one replica per data shard, as in ``detect/face.py``,
and on CUDA the stretch up to NMS's first convergence read replays a CUDA
graph as there.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from video_desensitization_torch import resolve_device
from video_desensitization_torch.models.common import load_weights
from video_desensitization_torch.models.yolo import YoloV8
from video_desensitization_torch.ops.image import letterbox_device_auto, letterbox_params
from video_desensitization_torch.ops.nms import nms_rounds, nms_settings, nms_setup
from video_desensitization_torch.parallel.mesh import (
    data_parallel_program,
    pad_batch_to_devices,
    shard_batch,
    shard_params,
)
from video_desensitization_torch.utils.graphs import SegmentGraphs, device_constant
from video_desensitization_torch.utils.timers import span

YOLO_PAD_VALUE = 114.0


def _inverse_letterbox(xyxy, offset, gain, limit):
    """Letterboxed-input pixel boxes -> original pixels, clipped to
    [0, limit]: ``min(max((xyxy - offset) * gain, 0), limit)``."""
    return torch.minimum(torch.clamp((xyxy - offset) * gain, min=0), limit)


class PlateDetector:
    # The engine may hand it its shared letterbox canvas
    # (``_detect_letterboxed_program``) where the input sizes agree.
    takes_letterbox = True

    def __init__(
        self,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        model_path: Optional[str] = None,
        num_classes: int = 1,
        variant: str = "n",
        confidence: float = 0.5,
        nms_iou: float = 0.7,
        input_shape=(640, 640),
        max_detections: int = 64,
        dtype=torch.bfloat16,
        device=None,
        seed: int = 0,
        mesh=None,
    ):
        self.confidence = confidence
        self.nms_iou = nms_iou
        self.input_hw = (int(input_shape[0]), int(input_shape[1]))
        self.max_detections = max_detections
        self.dtype = dtype
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.net = YoloV8(num_classes=num_classes, variant=variant)
        load_weights(self.net, state_dict, model_path, seed)
        self.net.eval().to(device=self.device, dtype=dtype)
        if self.device.type == "cuda":
            self.net.to(memory_format=torch.channels_last)
        self._graphs = SegmentGraphs("plate.graph")
        if mesh is not None:
            self._replicas = self.replicate(mesh)
            self._mesh_program = data_parallel_program(
                mesh, PlateDetector._detect_program, n_params=1, n_batch_args=2, n_out=2)

    def replicate(self, mesh) -> List["PlateDetector"]:
        """This detector once per data shard of ``mesh``, on the shard's
        device (``shard_params``), with no mesh of its own."""
        replicas = []
        for dev, net in zip(mesh.data_devices(), shard_params(mesh, self.net)):
            r = copy.copy(self)
            r.__dict__.pop("_replicas", None)
            r.__dict__.pop("_mesh_program", None)
            r.mesh, r.device, r.net = None, dev, net
            r._graphs = SegmentGraphs("plate.graph")
            replicas.append(r)
        return replicas

    def _forward_setup(self, x: torch.Tensor):
        """Normalized NHWC input -> NMS set-up (``ops/nms.py::nms_setup``)
        of the (B, A, 6) [x1,y1,x2,y2,score,cls] rows in input pixels."""
        boxes, probs = self.net(x.to(self.dtype).permute(0, 3, 1, 2))
        score, cls = torch.max(probs, dim=-1, keepdim=True)
        dets = torch.cat([boxes, score, cls.to(torch.float32)], dim=-1)
        return nms_setup(dets, *nms_settings(self))

    def _segment(self, frames_u8: torch.Tensor):
        """uint8 NHWC frames -> NMS set-up: the float letterbox onto 114
        gray, /255, forward. No host read or copy: a graph holds it on
        CUDA (``utils/graphs.py``)."""
        x = letterbox_device_auto(frames_u8, self.input_hw, pad_value=YOLO_PAD_VALUE)
        return self._forward_setup(x / 255.0)

    def _letterboxed_segment(self, lb_frames_u8: torch.Tensor, lb_geom: torch.Tensor):
        """Frames letterboxed to ``input_hw`` and their (B, 4) geometry ->
        NMS set-up: the pad re-filled with YOLO's 114 gray, /255, forward.
        A graph holds it on CUDA, as ``_segment``."""
        h, w = self.input_hw
        dev = lb_frames_u8.device
        nh, nw, top, left = (lb_geom[:, i : i + 1, None] for i in range(4))
        ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
        inside = (ys >= top) & (ys < top + nh) & (xs >= left) & (xs < left + nw)
        pad = device_constant(int(YOLO_PAD_VALUE), torch.uint8, dev)
        x = torch.where(inside[..., None], lb_frames_u8, pad)
        return self._forward_setup(x.to(torch.float32) / 255.0)

    @torch.inference_mode()
    def _detect_program(self, frames_u8: torch.Tensor, image_shapes: torch.Tensor):
        """uint8 NHWC frames -> padded (B, K, 6) detections in original
        pixels + keep mask."""
        with span("plate.program"):
            _, ih, iw, _ = frames_u8.shape
            # The graph's outputs are read here, on this stream, before the
            # next call replays it; the epilogue writes fresh tensors.
            dets, keep = nms_rounds(
                *self._graphs(self._segment, frames_u8, settings=nms_settings(self)))
            nh, nw, top, left = letterbox_params((ih, iw), self.input_hw)
            row = lambda *v: device_constant(v, torch.float32, dets.device)
            boxes = _inverse_letterbox(
                dets[..., :4], row(left, top, left, top), row(iw / nw, ih / nh).repeat(2),
                row(iw, ih, iw, ih),
            )
            out = torch.cat([boxes, dets[..., 4:6]], dim=-1)
            return torch.where(keep[..., None], out, torch.zeros_like(out)), keep

    @torch.inference_mode()
    def _detect_letterboxed_program(
        self,
        lb_frames_u8: torch.Tensor,
        image_shapes: torch.Tensor,
        lb_geom: torch.Tensor,
    ):
        """Detect on frames already letterboxed to ``input_hw`` (the
        engine's shared gray-128 canvas): the pad region is re-filled with
        YOLO's 114 gray, and boxes map back by the inverse transform.

        image_shapes: (B, 2) float32 [orig_h, orig_w]; lb_geom: (B, 4)
        float32 [nh, nw, top, left] computed on the host (float32 on the
        device can place the content one pixel off for some heights).
        """
        with span("plate.program"):
            # Read on this stream before the next replay, as in _detect_program.
            dets, keep = nms_rounds(
                *self._graphs(self._letterboxed_segment, lb_frames_u8, lb_geom,
                             settings=nms_settings(self)))
            oh, ow = image_shapes[:, 0:1], image_shapes[:, 1:2]
            nh, nw, top, left = (lb_geom[:, i : i + 1, None] for i in range(4))
            gain_x = ow / torch.clamp(nw[..., 0], min=1.0)
            gain_y = oh / torch.clamp(nh[..., 0], min=1.0)
            boxes = _inverse_letterbox(
                dets[..., :4],
                torch.cat([left, top, left, top], dim=-1),
                torch.cat([gain_x, gain_y, gain_x, gain_y], dim=-1)[:, None, :],
                torch.cat([ow, oh, ow, oh], dim=-1)[:, None, :],
            )
            out = torch.cat([boxes, dets[..., 4:6]], dim=-1)
            return torch.where(keep[..., None], out, torch.zeros_like(out)), keep

    def detect_padded(self, frames_u8: np.ndarray):
        """(B, H, W, 3) uint8 -> (dets (B, K, 6), keep (B, K)) on the device."""
        b, h, w, _ = frames_u8.shape
        frames_u8 = np.ascontiguousarray(frames_u8)
        shapes = np.tile(np.array([[h, w]], np.float32), (b, 1))
        if self.mesh is not None:
            n = self.mesh.size
            dets, keep = self._mesh_program(
                self._replicas,
                shard_batch(self.mesh, pad_batch_to_devices(frames_u8, n)[0]),
                shard_batch(self.mesh, pad_batch_to_devices(shapes, n)[0]),
            )
            return dets[:b], keep[:b]
        return self._detect_program(
            torch.as_tensor(frames_u8).to(self.device), torch.as_tensor(shapes).to(self.device))

    def get_map_txt(self, image: np.ndarray) -> np.ndarray:
        """Single-image detections for mAP evaluation: (M, 6) rows
        [x1, y1, x2, y2, score, cls] in pixels."""
        dets, keep = self.detect_padded(np.asarray(image, np.uint8)[None])
        return dets[0][keep[0]].cpu().numpy()

    def __call__(self, images, verbose: bool = False, conf: Optional[float] = None):
        """Reference-parity callable: list of RGB uint8 images -> list of
        (image, boxes) tuples; ``conf`` raises the score threshold."""
        if not isinstance(images, (list, tuple)):
            images = [images]
        outputs = [None] * len(images)
        by_shape: Dict[Tuple[int, int], list] = {}
        for i, im in enumerate(images):
            by_shape.setdefault(im.shape[:2], []).append(i)
        for idxs in by_shape.values():
            batch = np.stack([np.asarray(images[i], np.uint8) for i in idxs])
            dets, keep = self.detect_padded(batch)
            dets, keep = dets.cpu().numpy(), keep.cpu().numpy()
            if conf is not None:
                keep = keep & (dets[..., 4] >= conf)
            for row, i in enumerate(idxs):
                outputs[i] = (images[i], dets[row][keep[row]][:, :4].tolist())
        return outputs
