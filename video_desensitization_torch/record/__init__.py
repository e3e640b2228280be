"""Apollo Cyber RT ``.record`` container I/O, packet repair, unpack/repack.

Host code, the counterpart of the reference's closed-source Cython modules
(``foreign/recordDeal.so`` and ``foreign/readPacket.so``), rebuilt from
their observable behavior: section-framed protobuf container format,
12-camera topic registry, keyframe-gated H.265 extraction, pts/sequence
repair, and HEVC repack at 10 Mbps preset medium.
"""

from video_desensitization_torch.record.topics import (
    CAMERA_TOPICS,
    camera_name_from_topic,
    topic_from_filename,
    hevc_filename_for_topic,
)
from video_desensitization_torch.record.reader import RecordReader
from video_desensitization_torch.record.writer import RecordWriter
from video_desensitization_torch.record.unpack import read_record2h265_all, get_tmp_record_path
from video_desensitization_torch.record.repack import write_allH265_record_all, match_topics_and_hevcs
from video_desensitization_torch.record.packets import ReadPacket

__all__ = [
    "CAMERA_TOPICS",
    "camera_name_from_topic",
    "topic_from_filename",
    "hevc_filename_for_topic",
    "RecordReader",
    "RecordWriter",
    "ReadPacket",
    "read_record2h265_all",
    "get_tmp_record_path",
    "write_allH265_record_all",
    "match_topics_and_hevcs",
]
