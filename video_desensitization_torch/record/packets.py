"""Packet-level utilities: the reference's ``readPacket.ReadPacket``.

Rebuilt from the reference module's observable behavior:

* ``read_packet(input_path)`` — demux a processed video into compressed
  packets (pts/dts/duration/keyframe), skipping until the first keyframe;
  returns [] with a log message when the file is missing/empty/keyless.
* ``fix_missing_pts(packets)`` — repair missing/reordered pts
  (``last_packet`` duration fallback).
* ``process_frames_reader(messages)`` — record messages -> contiguous HEVC
  byte stream + per-frame metadata.
* ``process_frames_write(messages, packets)`` — pair original record
  messages with desensitized packets in decode order, producing the final
  messages whose payloads are replaced but whose headers/times are preserved.

Packet demux needs the native libav layer (``video.av.PacketDemuxer``); it
has no cv2 fallback.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from operator import itemgetter
from typing import List, Optional, Sequence, Tuple

from video_desensitization_torch.utils.logging import get_logger
from video_desensitization_torch.video.av import PacketDemuxer
from video_desensitization_torch.video.nal import is_hevc_keyframe


@dataclass
class FramePacket:
    data: bytes
    pts: Optional[int] = None
    dts: Optional[int] = None
    duration: int = 0
    is_key_frame: bool = False
    sequence_num: int = 0
    time: int = 0  # record timestamp (ns)


class ReadPacket:
    """API-parity packet reader/repairer."""

    def __init__(self):
        self.log = get_logger("ReadPacket")

    def read_packet(self, input_path: str) -> List[FramePacket]:
        if not input_path or not os.path.exists(input_path):
            self.log.warning(" Not exists input path... input_path: %s", input_path)
            return []
        packets: List[FramePacket] = []
        with PacketDemuxer(input_path) as demux:
            for pkt in demux:
                packets.append(
                    FramePacket(
                        data=pkt.data,
                        pts=None if pkt.pts is None or pkt.pts < -(2**62) else pkt.pts,
                        dts=None if pkt.dts is None or pkt.dts < -(2**62) else pkt.dts,
                        duration=pkt.duration,
                        is_key_frame=pkt.is_key,
                    )
                )
        if not packets:
            self.log.warning("No messages found. Returning empty list.")
            return []
        # Drop leading non-keyframes (decoder can't start mid-GOP).
        start = next((i for i, p in enumerate(packets) if p.is_key_frame), None)
        if start is None:
            self.log.warning("No key frame found. Returning empty list.")
            return []
        return packets[start:]

    def fix_missing_pts(self, packets: List[FramePacket]) -> List[FramePacket]:
        """Assign missing pts from neighbors and return presentation order.

        Packets with pts present are sorted by pts; packets missing pts are
        placed in decode order, extrapolating from the last known packet's
        pts + duration (the reference's ``last_packet`` logic).
        """
        if not packets:
            return []
        default_dur = next((p.duration for p in packets if p.duration), 1)
        last_pts = None
        for p in packets:
            if p.pts is None:
                p.pts = (last_pts + (p.duration or default_dur)) if last_pts is not None else 0
            last_pts = p.pts
        sorted_frames = sorted(
            ((p.pts, i, p) for i, p in enumerate(packets)), key=itemgetter(0, 1)
        )
        return [p for _, _, p in sorted_frames]

    def reconcile_with_timeline(
        self,
        packets: List[FramePacket],
        timeline: Sequence[Tuple[int, int]],
    ) -> List[FramePacket]:
        """Pair decode-order packets with the original record timeline.

        ``timeline`` is [(time_ns, sequence_num), ...] from the original
        record messages — the authoritative ordering. Record payloads are an
        elementary stream, so record order == decode order: the i-th packet
        takes the i-th message's time and sequence. Count mismatches are
        logged and truncated to the shorter side (never pair a packet with
        the wrong timestamp).
        """
        if len(packets) != len(timeline):
            self.log.warning(
                "packet/timeline length mismatch: %d packets vs %d record "
                "messages; truncating to %d",
                len(packets),
                len(timeline),
                min(len(packets), len(timeline)),
            )
        out = []
        for p, (t, seq) in zip(packets, timeline):
            p.time = t
            p.sequence_num = seq
            out.append(p)
        return out

    def process_frames_reader(
        self, messages: Sequence[Tuple[object, int]]
    ) -> Tuple[bytes, List[FramePacket]]:
        """Record messages -> (contiguous hevc byte stream, frame metadata).

        ``messages`` is a sequence of (CompressedImage, time_ns). Frames
        before the first keyframe are filtered (keyframe gating).
        """
        frames_buffer: List[FramePacket] = []
        hevc_data = bytearray()
        key_seen = False
        for img, t in messages:
            data = bytes(img.data)
            key = is_hevc_keyframe(data)
            if not key_seen:
                if not key:
                    continue
                key_seen = True
            seq = img.header.sequence_num if img.HasField("header") else 0
            frames_buffer.append(
                FramePacket(
                    data=data,
                    is_key_frame=key,
                    sequence_num=seq,
                    time=t,
                )
            )
            hevc_data.extend(data)
        return bytes(hevc_data), frames_buffer

    def process_frames_write(
        self,
        messages: Sequence[Tuple[object, int]],
        packets: Sequence[FramePacket],
    ) -> List[Tuple[object, int]]:
        """Merge desensitized packets back into the original messages.

        The i-th surviving original message keeps its header, format, and
        record time, but its ``data`` payload becomes the i-th processed
        packet (pairing semantics shared with ``reconcile_with_timeline``).
        Extra originals beyond the processed packet count are dropped;
        extra packets are ignored.
        """
        filtered = [(img, t) for img, t in messages]
        timeline = [
            (t, img.header.sequence_num if hasattr(img, "header") else 0)
            for img, t in filtered
        ]
        paired = self.reconcile_with_timeline(list(packets), timeline)
        final_messages = []
        for (img, t), pkt in zip(filtered, paired):
            new_img = type(img)()
            new_img.CopyFrom(img)
            new_img.data = bytes(pkt.data)
            final_messages.append((new_img, t))
        return final_messages
