"""Public configuration API (config.ini-compatible)."""

from video_desensitization_torch.api.config import PipelineConfig, load_config

__all__ = ["PipelineConfig", "load_config"]
