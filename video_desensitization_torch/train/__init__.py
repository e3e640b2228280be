"""Training of RetinaFace: anchor targets, the multibox loss, the data
pipeline, the SGD step and checkpoints, on ``cuda`` unless the caller
passes ``device="cpu"``."""

from video_desensitization_torch.train.targets import encode_boxes, encode_landmarks, match_anchors
from video_desensitization_torch.train.losses import multibox_loss
from video_desensitization_torch.train.step import TrainState, create_train_state, make_train_step

__all__ = [
    "encode_boxes",
    "encode_landmarks",
    "match_anchors",
    "multibox_loss",
    "TrainState",
    "create_train_state",
    "make_train_step",
]
