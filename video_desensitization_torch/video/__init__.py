"""Video I/O: native libav layer with an OpenCV fallback."""

from video_desensitization_torch.video.av import (
    VideoDecoder,
    VideoEncoder,
    PacketDemuxer,
    native_available,
)
from video_desensitization_torch.video.frames import (
    convert_video_to_frames,
    create_video,
    iter_frames,
)

__all__ = [
    "VideoDecoder",
    "VideoEncoder",
    "PacketDemuxer",
    "native_available",
    "convert_video_to_frames",
    "create_video",
    "iter_frames",
]
