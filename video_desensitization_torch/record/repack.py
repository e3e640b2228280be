"""Record repack: write desensitized video back into a new .record.

The reference's ``recordDeal.write_allH265_record_all``: match processed
output videos to camera topics by filename (``match_topics_and_hevcs``),
re-encode each to HEVC at 10 Mbps preset medium, demux to packets, replace
the payloads of that topic's messages in the original record (preserving
every other channel untouched), and write the final .record to
``record_output_dir``. The re-encode needs libx265 and the demux needs
libav: both come from the native codec layer (``video/av.py``).
"""

from __future__ import annotations

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from video_desensitization_torch.record.packets import ReadPacket
from video_desensitization_torch.record.reader import RecordReader
from video_desensitization_torch.record.topics import (
    CAMERA_TOPICS,
    topic_from_filename,
)
from video_desensitization_torch.record.unpack import _list_records
from video_desensitization_torch.record.writer import RecordWriter
from video_desensitization_torch.utils.logging import get_logger
from video_desensitization_torch.video.av import HEVC_DEFAULTS, VideoDecoder, VideoEncoder
from video_desensitization_torch.video.nal import is_hevc_keyframe

REPACK_FPS = 30.0  # the reference's repack rate

VIDEO_EXTS = (".mp4", ".mov", ".avi", ".h265", ".hevc", ".265", ".mkv")


def match_topics_and_hevcs(output_videos_dir: str) -> Dict[str, str]:
    """Map camera topics -> processed video paths by camera_name in filename."""
    matches: Dict[str, str] = {}
    if not os.path.isdir(output_videos_dir):
        return matches
    for name in sorted(os.listdir(output_videos_dir)):
        if not name.lower().endswith(VIDEO_EXTS):
            continue
        topic = topic_from_filename(name)
        if topic:
            matches[topic] = os.path.join(output_videos_dir, name)
    return matches


def _reencode_to_hevc_packets(video_path: str, log) -> List:
    """Re-encode a processed video to HEVC (10 Mbps / medium) and demux the
    resulting packets in DECODE order.

    Decode order is the only correct order for record payloads: the record's
    concatenated message payloads form an Annex-B elementary stream, and HEVC
    at preset medium emits B-frames (decode order != presentation order)."""
    if not os.path.exists(video_path) or os.path.getsize(video_path) == 0:
        log.error("Video file is empty or not exists: %s", video_path)
        return []
    rp = ReadPacket()
    if video_path.lower().endswith((".h265", ".hevc", ".265")):
        # Already an elementary HEVC stream with the right payloads;
        # demux order = stream order = decode order.
        return rp.read_packet(video_path)
    with tempfile.NamedTemporaryFile(suffix=".h265", delete=False) as tmp:
        tmp_path = tmp.name
    try:
        with VideoDecoder(video_path) as dec:
            first = next(iter(dec), None)
            if first is None:
                log.error("Video file is empty or not exists: %s", video_path)
                return []
            h, w = first.shape[:2]
            with VideoEncoder(
                tmp_path, w, h, fps=REPACK_FPS, **HEVC_DEFAULTS
            ) as enc:
                enc.write(first)
                for frame in dec:
                    enc.write(frame)
        return rp.read_packet(tmp_path)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)


def write_allH265_record_all(
    record_dir: str,
    output_videos_dir: str,
    record_output_dir: str,
    topics: Sequence[str] = CAMERA_TOPICS,
) -> Optional[str]:
    """Write the desensitized data to the record file.

    Returns the output record path (or None if no input record)."""
    log = get_logger("recordDeal")
    records = _list_records(record_dir)
    if not records:
        log.error("The record dir %s has no records", record_dir)
        return None
    os.makedirs(record_output_dir, exist_ok=True)

    matches = match_topics_and_hevcs(output_videos_dir)
    topic_packets: Dict[str, List] = {}
    if matches:
        # Re-encode cameras concurrently: the HEVC encode is the record
        # job's tail, each camera is independent, and the native encoder
        # releases the GIL.
        with ThreadPoolExecutor(max_workers=min(4, len(matches))) as ex:
            futures = {
                topic: ex.submit(_reencode_to_hevc_packets, path, log)
                for topic, path in matches.items()
            }
            for topic, fut in futures.items():
                pkts = fut.result()
                if not pkts:
                    log.error(
                        "The record does not contain any data for topic: %s",
                        topic,
                    )
                    continue
                topic_packets[topic] = pkts

    out_path = None
    topics_set = set(topics)
    skipped_camera: Dict[str, int] = {}  # camera topics with no processed video
    dropped = {t: 0 for t in topic_packets}  # original frames left unpaired
    prekey = {t: 0 for t in topic_packets}  # leading pre-keyframe frames
    msg_totals = {t: 0 for t in topic_packets}
    # One packet stream per topic spans the whole record SET: segment 1's
    # messages continue where segment 0's left off (the processed video is
    # the concatenation of all segments), so the cursor must not reset.
    cursor = {t: 0 for t in topic_packets}
    # Mirror unpack's keyframe gating: unpack dropped each topic's leading
    # pre-keyframe messages, so packet i corresponds to the i-th SURVIVING
    # (post-gate) message — pairing from message 0 would shift every frame
    # k early for a record that starts mid-GOP. Pre-gate originals are
    # dropped from the output too (they were never desensitized).
    gated = {t: False for t in topic_packets}
    for record_path in records:
        reader = RecordReader(record_path)
        out_path = os.path.join(
            record_output_dir, os.path.basename(record_path)
        )
        with RecordWriter(out_path, compress=reader.header.compress) as writer:
            for name, ch in reader.channels.items():
                writer.write_channel(name, ch.message_type, ch.proto_desc)
            for topic, msg, t in reader.read_messages():
                if topic in topic_packets and hasattr(msg, "data"):
                    msg_totals[topic] += 1
                    if not gated[topic]:
                        if not is_hevc_keyframe(bytes(msg.data)):
                            prekey[topic] += 1
                            continue
                        gated[topic] = True
                    i = cursor[topic]
                    pkts = topic_packets[topic]
                    if i < len(pkts):
                        # The record timeline is authoritative: the i-th
                        # surviving message keeps its header/time, its
                        # payload becomes the i-th decode-order packet.
                        new_msg = type(msg)()
                        new_msg.CopyFrom(msg)
                        new_msg.data = bytes(pkts[i].data)
                        cursor[topic] = i + 1
                        writer.write_message(topic, new_msg, t)
                        continue
                    # More original frames than desensitized packets: drop
                    # the tail rather than leak raw frames.
                    dropped[topic] += 1
                    continue
                if topic in topics_set:
                    # A camera topic with NO desensitized stream (its video
                    # failed to process, or was never extracted). Copying the
                    # original payloads would write raw, un-blurred frames
                    # into the "desensitized" record — drop them instead.
                    skipped_camera[topic] = skipped_camera.get(topic, 0) + 1
                    continue
                writer.write_message(topic, msg, t)
        log.info(
            "All topic images data had changed: %s",
            sorted(cursor.keys()),
        )
        log.info(
            "The video has been successfully written, and the path has been "
            "added to: %s",
            out_path,
        )
    for topic, n_skip in skipped_camera.items():
        log.error(
            "topic %s: NO desensitized video matched — dropped all %d raw "
            "frames from the output record (raw camera frames are never "
            "copied through)",
            topic,
            n_skip,
        )
    for topic, n_pre in prekey.items():
        if n_pre:
            log.warning(
                "topic %s: dropped %d leading pre-keyframe frames (never "
                "desensitized; unpack gated them out)",
                topic,
                n_pre,
            )
    for topic, n_drop in dropped.items():
        if n_drop:
            log.warning(
                "topic %s: dropped %d/%d original frames (fewer desensitized "
                "packets than record messages)",
                topic,
                n_drop,
                msg_totals[topic],
            )
        unused = len(topic_packets[topic]) - cursor.get(topic, 0)
        if unused > 0:
            log.warning(
                "topic %s: %d desensitized packets unused (more packets than "
                "record messages)",
                topic,
                unused,
            )
    return out_path
