"""RetinaFace detector: letterbox, mean-sub, forward, decode, NMS and
letterbox correction on one device, uint8 NHWC frames in.

Constructor keywords follow the reference class (``model_path``,
``backbone``, ``confidence``, ``nms_iou``, ``input_shape``,
``letterbox_image``); ``device`` picks the card (``cuda`` unless the caller
passes ``device="cpu"``) and ``dtype`` the network's compute type.
Results are padded (B, K, 15) rows plus a keep mask on the device, turned
into the reference's per-image box lists at the API boundary.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from video_desensitization_torch import resolve_device
from video_desensitization_torch.models.common import load_weights
from video_desensitization_torch.models.configs import get_config
from video_desensitization_torch.models.retinaface import RetinaFace as RetinaFaceNet
from video_desensitization_torch.ops.anchors import generate_anchors
from video_desensitization_torch.ops.boxes import (
    decode_boxes,
    decode_landmarks,
    letterbox_correction,
    scale_to_pixels,
)
from video_desensitization_torch.ops.image import preprocess_batch_device
from video_desensitization_torch.ops.nms import batched_nms_padded


class Retinaface:
    """Batched RetinaFace detector."""

    _defaults = {
        "model_path": None,
        "backbone": "resnet50",
        "confidence": 0.5,
        "nms_iou": 0.45,
        "input_shape": [1280, 1280, 3],
        "letterbox_image": True,
        "max_detections": 128,
        "dtype": torch.bfloat16,
        "seed": 0,
    }

    def __init__(
        self,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        device=None,
        **kwargs,
    ):
        self.__dict__.update(self._defaults)
        for name, value in kwargs.items():
            if name not in self._defaults:
                raise TypeError(f"unknown Retinaface option {name!r}")
            setattr(self, name, value)
        self.device = resolve_device(device)
        self.cfg = get_config(self.backbone)
        self.input_hw = (int(self.input_shape[0]), int(self.input_shape[1]))
        anchors = generate_anchors(
            self.input_hw, self.cfg["min_sizes"], self.cfg["steps"], self.cfg["clip"]
        )
        self.anchors = torch.from_numpy(anchors.copy()).to(self.device)
        self.net = RetinaFaceNet(self.cfg, mode="eval")
        load_weights(self.net, state_dict, self.model_path, self.seed)
        self.net.eval().to(device=self.device, dtype=self.dtype)
        if self.device.type == "cuda":
            self.net.to(memory_format=torch.channels_last)

    @torch.inference_mode()
    def _detect_program(self, frames_u8: torch.Tensor, image_shapes: torch.Tensor):
        """uint8 NHWC frames -> (dets_norm, dets_px, keep), all on device."""
        x = preprocess_batch_device(frames_u8, self.input_hw, dtype=self.dtype)
        loc, conf, landm = self.net(x.permute(0, 3, 1, 2))
        loc, conf, landm = loc.float(), conf.float(), landm.float()
        boxes = decode_boxes(loc, self.anchors, self.cfg["variance"])
        landms = decode_landmarks(landm, self.anchors, self.cfg["variance"])
        dets = torch.cat([boxes, conf[..., 1:2], landms], dim=-1)
        dets, keep = batched_nms_padded(
            dets, self.confidence, self.nms_iou, self.max_detections
        )
        if self.letterbox_image:
            dets = letterbox_correction(dets, self.input_hw, image_shapes)
            dets = torch.where(keep[..., None], dets, torch.zeros_like(dets))
        return dets, scale_to_pixels(dets, image_shapes), keep

    def detect_padded(
        self, frames_u8: np.ndarray, image_shapes: Optional[np.ndarray] = None
    ):
        """(B, H, W, 3) uint8 -> (dets_norm, dets_px, keep) tensors on the
        device. ``image_shapes`` defaults to the frame shape."""
        b, h, w, _ = frames_u8.shape
        if image_shapes is None:
            image_shapes = np.tile(np.array([[h, w]], np.float32), (b, 1))
        frames = torch.as_tensor(np.ascontiguousarray(frames_u8)).to(self.device)
        shapes = torch.as_tensor(np.asarray(image_shapes, np.float32)).to(self.device)
        return self._detect_program(frames, shapes)

    def detect_images(
        self, images: Sequence[np.ndarray]
    ) -> List[Tuple[np.ndarray, List[List[float]]]]:
        """list of HWC RGB uint8 arrays -> list of (image, [x1,y1,x2,y2]
        boxes in original pixels). Same-shape images share one batch."""
        if not isinstance(images, (list, tuple)):
            images = [images]
        outputs: List = [None] * len(images)
        by_shape: Dict[Tuple[int, int], List[int]] = {}
        for i, im in enumerate(images):
            by_shape.setdefault(im.shape[:2], []).append(i)
        for idxs in by_shape.values():
            batch = np.stack([np.asarray(images[i], np.uint8) for i in idxs])
            _, dets_px, keep = self.detect_padded(batch)
            dets_px, keep = dets_px.cpu().numpy(), keep.cpu().numpy()
            for row, i in enumerate(idxs):
                outputs[i] = (images[i], dets_px[row][keep[row]][:, :4].tolist())
        return outputs
