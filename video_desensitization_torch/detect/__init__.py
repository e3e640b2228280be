"""Face and licence-plate detectors."""

from video_desensitization_torch.detect.face import Retinaface
from video_desensitization_torch.detect.plate import PlateDetector

__all__ = ["Retinaface", "PlateDetector"]
