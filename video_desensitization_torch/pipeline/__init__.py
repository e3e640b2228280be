"""Orchestration: fused engine, tiered pipeline, batch/video/record jobs,
keyframe tracking and the resident watch-folder service."""

from video_desensitization_torch.pipeline.engine import DesensitizationEngine
from video_desensitization_torch.pipeline.service import (
    DesensitizationService,
    ServiceConfig,
)
from video_desensitization_torch.pipeline.throughput import TieredPipeline
from video_desensitization_torch.pipeline.tracking import TrackingEngine

__all__ = [
    "DesensitizationEngine",
    "DesensitizationService",
    "ServiceConfig",
    "TieredPipeline",
    "TrackingEngine",
]
