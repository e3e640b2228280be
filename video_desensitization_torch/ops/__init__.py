"""Closed-form tensor ops: anchors, boxes, NMS, image preprocessing, mosaic.

The mosaic kernel's wrappers (``ops/cuda_mosaic.py``) are not exported
here, as the JAX package does not export its Pallas kernel's."""

from video_desensitization_torch.ops.anchors import generate_anchors, num_anchors
from video_desensitization_torch.ops.boxes import (
    decode_boxes,
    decode_landmarks,
    letterbox_correction,
    pairwise_iou,
)
from video_desensitization_torch.ops.nms import batched_nms_padded, nms_padded
from video_desensitization_torch.ops.image import (
    letterbox_host,
    letterbox_device,
    preprocess_input,
    letterbox_params,
)
from video_desensitization_torch.ops.mosaic import (
    mosaic_boxes_batch,
    mosaic_host_inplace,
    mosaic_host_reference,
    build_mosaic_maps,
    gaussian_blur_boxes,
)

__all__ = [
    "generate_anchors",
    "num_anchors",
    "decode_boxes",
    "decode_landmarks",
    "letterbox_correction",
    "pairwise_iou",
    "batched_nms_padded",
    "nms_padded",
    "letterbox_host",
    "letterbox_device",
    "letterbox_params",
    "preprocess_input",
    "mosaic_boxes_batch",
    "mosaic_host_inplace",
    "mosaic_host_reference",
    "build_mosaic_maps",
    "gaussian_blur_boxes",
]
