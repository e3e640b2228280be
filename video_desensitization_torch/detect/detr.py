"""Licence-plate detector on RT-DETR-R50 (``models/rtdetr.py``): no NMS.

Preprocessing follows ultralytics' ``RTDETRPredictor`` (``LetterBox(auto=
False, scale_fill=True)``) and lyuwenyu's eval (``Resize([640, 640])``): a
cv2-exact INTER_LINEAR stretch of the whole frame to ``input_hw``, /255, no
mean. The decoder's queries are scored by their best class's sigmoid; the
``max_detections`` best are kept where they reach ``confidence``, and their
cxcywh boxes map back by the frame's width and height, clipped to it.

Nothing is read on the host, so on CUDA the whole program, from the uint8
frames to the (B, K, 6) rows and the keep mask, replays one CUDA graph
(``utils/graphs.py``, span ``plate.graph``) from the second batch of a
shape on. The graph's outputs are its own buffers: a caller reads them on
the stream of the call before the detector's next call, as the engine's
copies do. The rest of the plate interface is ``detect/plate.py``'s: with
a ``mesh`` the batch is padded, sharded and run on one replica per data
shard there.

The detector takes whole frames: it never reads the engine's shared
letterbox canvas (``takes_letterbox`` False), so the tiered pipeline, whose
device program sees only letterboxed content, cannot run it.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from video_desensitization_torch import resolve_device
from video_desensitization_torch.detect.plate import PlateDetector
from video_desensitization_torch.models.common import init_weights
from video_desensitization_torch.models.rtdetr import PUBLISHED, RTDETR
from video_desensitization_torch.ops.image import cv2_resize_formula, resize_linear_cv2_exact
from video_desensitization_torch.parallel.mesh import data_parallel_program
from video_desensitization_torch.utils.graphs import SegmentGraphs, device_constant
from video_desensitization_torch.utils.timers import span


class RtDetrPlateDetector(PlateDetector):
    """``PlateDetector``'s interface (``detect_padded``, ``__call__``,
    ``replicate``, ``get_map_txt`` are its own) over RT-DETR's program."""

    takes_letterbox = False

    def __init__(
        self,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        model_path: Optional[str] = None,
        num_classes: int = 1,
        confidence: float = 0.5,
        input_shape=(640, 640),
        max_detections: int = 64,
        dtype=torch.bfloat16,
        device=None,
        seed: int = 0,
        mesh=None,
        **arch,
    ):
        """``arch``: ``models/rtdetr.py::RTDETR`` keywords over ``PUBLISHED``
        (tests build small ones). ``state_dict``: the port's own layout;
        a checkpoint file is not read yet (``model_path`` raises)."""
        if model_path is not None:
            raise ValueError(
                f"no RT-DETR checkpoint loader yet: cannot read {model_path!r}; "
                "pass a state_dict in the port's layout, or random weights")
        self.confidence = confidence
        self.input_hw = (int(input_shape[0]), int(input_shape[1]))
        self.max_detections = max_detections
        self.dtype = dtype
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.net = RTDETR(**dict(PUBLISHED, num_classes=num_classes, **arch))
        if state_dict is None:
            init_weights(self.net, torch.Generator().manual_seed(seed))
        else:
            self.net.load_state_dict(state_dict)
        self.net.eval().to(device=self.device, dtype=dtype)
        self.net.float_heads_()
        if self.device.type == "cuda":
            self.net.to(memory_format=torch.channels_last)
        self.top_k = min(max_detections, self.net.decoder.num_queries)
        self._graphs = SegmentGraphs("plate.graph")
        if mesh is not None:
            self._replicas = self.replicate(mesh)
            self._mesh_program = data_parallel_program(
                mesh, RtDetrPlateDetector._detect_program, n_params=1, n_batch_args=2, n_out=2)

    def _segment(self, frames_u8: torch.Tensor, tokens: bool = False):
        """uint8 NHWC frames -> (rows (B, K, 6) [x1, y1, x2, y2, score, cls]
        in the frame's pixels, zero where not kept; keep (B, K)). With
        ``tokens`` also the memory token (B, K) whose selected query gave
        each row, for a caller that judges rows by query; the program's
        graph never asks for it."""
        _, ih, iw, _ = frames_u8.shape
        formula = cv2_resize_formula((ih, iw), self.input_hw) or "scalar"
        x = resize_linear_cv2_exact(frames_u8, self.input_hw, formula).to(torch.float32) / 255.0
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        with span("detr.encoder"):
            feats = self.net.encoder(self.net.backbone(x))
        with span("detr.decoder"):
            logits, boxes, selected = self.net.decoder(feats)
        best, cls = torch.sigmoid(logits).max(-1)
        score, index = torch.topk(best, self.top_k, dim=1)
        cxcywh = boxes.gather(1, index[..., None].expand(-1, -1, 4))
        half = cxcywh[..., 2:] * 0.5
        dev = frames_u8.device
        size = device_constant((iw, ih, iw, ih), torch.float32, dev)
        xyxy = torch.minimum(torch.clamp(torch.cat([cxcywh[..., :2] - half, cxcywh[..., :2] + half],
                                                   -1) * size, min=0.0), size)
        keep = score >= self.confidence
        rows = torch.cat([xyxy, score[..., None], cls.gather(1, index)[..., None].float()], -1)
        rows = torch.where(keep[..., None], rows, torch.zeros_like(rows))
        return (rows, keep, selected.gather(1, index)) if tokens else (rows, keep)

    @torch.inference_mode()
    def _detect_program(self, frames_u8: torch.Tensor, image_shapes: torch.Tensor):
        """uint8 NHWC frames -> padded (B, K, 6) detections in the frames'
        pixels + keep mask, one graph replay on CUDA. ``image_shapes`` is
        taken for the plate interface: the stretch maps boxes back by the
        frames' own shape."""
        with span("plate.program"):
            return self._graphs(self._segment, frames_u8,
                                settings=(self.confidence, self.top_k))

    def _detect_letterboxed_program(self, *args):
        raise NotImplementedError(
            "RT-DETR stretches whole frames; it cannot read a letterboxed canvas "
            "(use the fused engine, not the tiered pipeline)")
