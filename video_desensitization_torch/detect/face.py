"""RetinaFace detector: letterbox, mean-sub, forward, decode, NMS and
letterbox correction on one device, uint8 NHWC frames in.

Constructor keywords follow the reference class (``model_path``,
``backbone``, ``confidence``, ``nms_iou``, ``input_shape``,
``letterbox_image``); ``device`` picks the card (``cuda`` unless the caller
passes ``device="cpu"``) and ``dtype`` the network's compute type.
Results are padded (B, K, 15) rows plus a keep mask on the device, turned
into the reference's per-image box lists at the API boundary. With a
``mesh`` (``parallel/mesh.py``) the detector holds one replica per data
shard and ``detect_padded`` pads the batch to the mesh's device count,
runs each shard on its device and joins the shards in order.
"""

from __future__ import annotations

import copy
import time
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
from video_desensitization_torch.parallel.mesh import (
    data_parallel_program,
    pad_batch_to_devices,
    shard_batch,
    shard_params,
)


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
        "mesh": None,
    }

    @classmethod
    def get_defaults(cls, n):
        """The default of option ``n``, else the reference's message for an
        unknown name (returned, not raised)."""
        return cls._defaults.get(n, f"Unrecognized attribute name '{n}'")

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
        if device is None and self.mesh is not None:
            device = self.mesh.devices.flat[0]
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
        if self.mesh is not None:
            self._replicas = self.replicate(self.mesh)
            self._mesh_program = data_parallel_program(
                self.mesh, Retinaface._detect_program, n_params=1, n_batch_args=2, n_out=3)

    def replicate(self, mesh) -> List["Retinaface"]:
        """This detector once per data shard of ``mesh``, on the shard's
        device (``shard_params``), with no mesh of its own."""
        replicas = []
        for dev, net in zip(mesh.data_devices(), shard_params(mesh, self.net)):
            r = copy.copy(self)
            r.__dict__.pop("_replicas", None)
            r.__dict__.pop("_mesh_program", None)
            r.mesh, r.device, r.net, r.anchors = None, dev, net, self.anchors.to(dev)
            replicas.append(r)
        return replicas

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
        if self.mesh is not None:
            return tuple(t[:b] for t in self._run(frames_u8, image_shapes)())
        return self._run(frames_u8, image_shapes)()

    def _run(self, frames_u8: np.ndarray, image_shapes: np.ndarray):
        """The inputs placed on the device (on a mesh: padded to its device
        count and sharded) and a call that runs the program on them."""
        frames_u8 = np.ascontiguousarray(frames_u8)
        image_shapes = np.asarray(image_shapes, np.float32)
        if self.mesh is None:
            frames = torch.as_tensor(frames_u8).to(self.device)
            shapes = torch.as_tensor(image_shapes).to(self.device)
            return lambda: self._detect_program(frames, shapes)
        n = self.mesh.size
        frames = shard_batch(self.mesh, pad_batch_to_devices(frames_u8, n)[0])
        shapes = shard_batch(self.mesh, pad_batch_to_devices(image_shapes, n)[0])
        return lambda: self._mesh_program(self._replicas, frames, shapes)

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

    def get_FPS(self, image: np.ndarray, test_interval: int = 100) -> float:
        """Reference-parity microbenchmark: mean seconds per detect call on
        one image, 10 warm-up calls then ``test_interval`` timed ones, the
        devices synchronised before and after the timed loop. On a mesh the
        image goes through the pad path, one frame per device."""
        batch = np.asarray(image, np.uint8)[None]
        run = self._run(batch, np.array([batch.shape[1:3]], np.float32))
        devices = [self.device] if self.mesh is None else self.mesh.data_devices()
        for _ in range(10):
            run()
        _synchronize(devices)
        t1 = time.time()
        for _ in range(test_interval):
            run()
        _synchronize(devices)
        return (time.time() - t1) / test_interval

    def get_map_txt(self, image: np.ndarray) -> np.ndarray:
        """Single-image detections for mAP evaluation: (M, 15) rows in
        pixels, the landmarks scaled too."""
        _, dets_px, keep = self.detect_padded(np.asarray(image, np.uint8)[None])
        return dets_px[0][keep[0]].cpu().numpy()


def _synchronize(devices) -> None:
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
