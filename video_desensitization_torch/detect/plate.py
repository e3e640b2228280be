"""Licence-plate detector: YOLOv8 forward, decode and NMS on one device.

Preprocessing follows ultralytics: aspect-preserving resize onto a 114-gray
canvas, /255; boxes map back to original pixels by the exact inverse
letterbox, clipped to the image.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from video_desensitization_torch import resolve_device
from video_desensitization_torch.models.common import load_weights
from video_desensitization_torch.models.yolo import YoloV8
from video_desensitization_torch.ops.image import letterbox_device_auto, letterbox_params
from video_desensitization_torch.ops.nms import batched_nms_padded

YOLO_PAD_VALUE = 114.0


def _inverse_letterbox(xyxy, offset, gain, limit):
    """Letterboxed-input pixel boxes -> original pixels, clipped to
    [0, limit]: ``min(max((xyxy - offset) * gain, 0), limit)``."""
    return torch.minimum(torch.clamp((xyxy - offset) * gain, min=0), limit)


class PlateDetector:
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
    ):
        self.confidence = confidence
        self.nms_iou = nms_iou
        self.input_hw = (int(input_shape[0]), int(input_shape[1]))
        self.max_detections = max_detections
        self.dtype = dtype
        self.device = resolve_device(device)
        self.net = YoloV8(num_classes=num_classes, variant=variant)
        load_weights(self.net, state_dict, model_path, seed)
        self.net.eval().to(device=self.device, dtype=dtype)
        if self.device.type == "cuda":
            self.net.to(memory_format=torch.channels_last)

    def _forward_nms(self, x: torch.Tensor):
        """Normalized NHWC input -> NMS'd (B, K, 6) [x1,y1,x2,y2,score,cls]
        in input pixels + keep mask."""
        boxes, probs = self.net(x.to(self.dtype).permute(0, 3, 1, 2))
        score, cls = torch.max(probs, dim=-1, keepdim=True)
        dets = torch.cat([boxes, score, cls.to(torch.float32)], dim=-1)
        return batched_nms_padded(dets, self.confidence, self.nms_iou, self.max_detections)

    @torch.inference_mode()
    def _detect_program(self, frames_u8: torch.Tensor, image_shapes: torch.Tensor):
        """uint8 NHWC frames -> padded (B, K, 6) detections in original
        pixels + keep mask."""
        _, ih, iw, _ = frames_u8.shape
        x = letterbox_device_auto(frames_u8, self.input_hw, pad_value=YOLO_PAD_VALUE)
        dets, keep = self._forward_nms(x / 255.0)
        nh, nw, top, left = letterbox_params((ih, iw), self.input_hw)
        row = lambda *v: torch.tensor(v, dtype=torch.float32, device=dets.device)
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
        h, w = self.input_hw
        dev = lb_frames_u8.device
        oh, ow = image_shapes[:, 0:1], image_shapes[:, 1:2]
        nh, nw, top, left = (lb_geom[:, i : i + 1, None] for i in range(4))
        ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
        inside = (ys >= top) & (ys < top + nh) & (xs >= left) & (xs < left + nw)
        pad = torch.tensor(int(YOLO_PAD_VALUE), dtype=torch.uint8, device=dev)
        x = torch.where(inside[..., None], lb_frames_u8, pad)
        dets, keep = self._forward_nms(x.to(torch.float32) / 255.0)
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
        shapes = torch.tensor([[h, w]] * b, dtype=torch.float32, device=self.device)
        frames = torch.as_tensor(np.ascontiguousarray(frames_u8)).to(self.device)
        return self._detect_program(frames, shapes)

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
