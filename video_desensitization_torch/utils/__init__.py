"""Logging, stage timing, profiling, and native builds."""

from video_desensitization_torch.utils.logging import setup_logger
from video_desensitization_torch.utils.timers import StageTimer

__all__ = ["setup_logger", "StageTimer"]
