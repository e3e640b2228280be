"""Training of RetinaFace: anchor targets, the multibox loss, the data
pipeline, the SGD step and checkpoints, on ``cuda`` unless the caller
passes ``device="cpu"``."""
