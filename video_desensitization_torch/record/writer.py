"""Cyber record container writer (chunked, indexed, header-finalized)."""

from __future__ import annotations

import bz2
from typing import Dict, Optional

from video_desensitization_torch.record import lz4block
from video_desensitization_torch.record.proto import cyber_record_pb2 as rp
from video_desensitization_torch.record.reader import HEADER_LENGTH, SECTION_STRUCT

MAJOR_VERSION = 1
MINOR_VERSION = 0
DEFAULT_CHUNK_INTERVAL_NS = 20_000_000_000
DEFAULT_SEGMENT_INTERVAL_NS = 60_000_000_000
DEFAULT_CHUNK_RAW_SIZE = 200 * 1024 * 1024


class RecordWriter:
    def __init__(
        self,
        path: str,
        chunk_message_limit: int = 500,
        chunk_raw_size: int = DEFAULT_CHUNK_RAW_SIZE,
        compress: int = rp.COMPRESS_NONE,
    ):
        if compress not in (rp.COMPRESS_NONE, rp.COMPRESS_BZ2, rp.COMPRESS_LZ4):
            raise ValueError(f"unsupported compression: {compress}")
        self.path = path
        self._compress = compress
        self._f = open(path, "wb")
        self._chunk = rp.ChunkBody()
        self._chunk_raw = 0
        self._chunk_begin: Optional[int] = None
        self._chunk_end: int = 0
        self._chunk_message_limit = chunk_message_limit
        self._chunk_raw_limit = chunk_raw_size
        self._index = rp.Index()
        self._channels: Dict[str, rp.Channel] = {}
        self._channel_counts: Dict[str, int] = {}
        self.header = rp.Header(
            major_version=MAJOR_VERSION,
            minor_version=MINOR_VERSION,
            compress=compress,
            chunk_interval=DEFAULT_CHUNK_INTERVAL_NS,
            segment_interval=DEFAULT_SEGMENT_INTERVAL_NS,
            is_complete=False,
        )
        self._begin_time: Optional[int] = None
        self._end_time = 0
        self._message_number = 0
        self._chunk_number = 0
        # Reserve the header slot; finalized in close().
        self._write_section(rp.SECTION_HEADER, self.header.SerializeToString())

    def _write_section(self, stype: int, payload: bytes) -> int:
        pos = self._f.tell()
        self._f.write(SECTION_STRUCT.pack(stype, len(payload)))
        if stype == rp.SECTION_HEADER:
            self._f.write(payload.ljust(HEADER_LENGTH, b"\x00"))
        else:
            self._f.write(payload)
        return pos

    def write_channel(
        self, name: str, message_type: str, proto_desc: bytes = b""
    ):
        if name in self._channels:
            return
        ch = rp.Channel(name=name, message_type=message_type, proto_desc=proto_desc)
        self._channels[name] = ch
        self._channel_counts[name] = 0
        pos = self._write_section(rp.SECTION_CHANNEL, ch.SerializeToString())
        idx = self._index.indexes.add()
        idx.type = rp.SECTION_CHANNEL
        idx.position = pos
        idx.channel_cache.name = name
        idx.channel_cache.message_type = message_type
        idx.channel_cache.proto_desc = proto_desc

    def write_message(self, channel_name: str, content, time_ns: int):
        if channel_name not in self._channels:
            raise ValueError(f"channel not declared: {channel_name}")
        if hasattr(content, "SerializeToString"):
            content = content.SerializeToString()
        m = self._chunk.messages.add()
        m.channel_name = channel_name
        m.time = time_ns
        m.content = content
        self._chunk_raw += len(content)
        self._chunk_begin = (
            time_ns if self._chunk_begin is None else min(self._chunk_begin, time_ns)
        )
        self._chunk_end = max(self._chunk_end, time_ns)
        self._begin_time = (
            time_ns if self._begin_time is None else min(self._begin_time, time_ns)
        )
        self._end_time = max(self._end_time, time_ns)
        self._message_number += 1
        self._channel_counts[channel_name] += 1
        if (
            len(self._chunk.messages) >= self._chunk_message_limit
            or self._chunk_raw >= self._chunk_raw_limit
        ):
            self._flush_chunk()

    def _flush_chunk(self):
        if not self._chunk.messages:
            return
        ch_header = rp.ChunkHeader(
            begin_time=self._chunk_begin or 0,
            end_time=self._chunk_end,
            message_number=len(self._chunk.messages),
            raw_size=self._chunk_raw,
        )
        pos = self._write_section(
            rp.SECTION_CHUNK_HEADER, ch_header.SerializeToString()
        )
        idx = self._index.indexes.add()
        idx.type = rp.SECTION_CHUNK_HEADER
        idx.position = pos
        idx.chunk_header_cache.begin_time = ch_header.begin_time
        idx.chunk_header_cache.end_time = ch_header.end_time
        idx.chunk_header_cache.message_number = ch_header.message_number
        idx.chunk_header_cache.raw_size = ch_header.raw_size

        body = self._chunk.SerializeToString()
        if self._compress == rp.COMPRESS_BZ2:
            body = bz2.compress(body)
        elif self._compress == rp.COMPRESS_LZ4:
            body = lz4block.compress(body)
        pos = self._write_section(rp.SECTION_CHUNK_BODY, body)
        idx = self._index.indexes.add()
        idx.type = rp.SECTION_CHUNK_BODY
        idx.position = pos
        idx.chunk_body_cache.message_number = len(self._chunk.messages)

        self._chunk_number += 1
        self._chunk = rp.ChunkBody()
        self._chunk_raw = 0
        self._chunk_begin = None
        self._chunk_end = 0

    def close(self):
        if self._f is None:
            return
        self._flush_chunk()
        for idx in self._index.indexes:
            if idx.type == rp.SECTION_CHANNEL:
                name = idx.channel_cache.name
                idx.channel_cache.message_number = self._channel_counts.get(name, 0)
        index_pos = self._write_section(
            rp.SECTION_INDEX, self._index.SerializeToString()
        )
        size = self._f.tell()
        self.header.index_position = index_pos
        self.header.chunk_number = self._chunk_number
        self.header.channel_number = len(self._channels)
        self.header.begin_time = self._begin_time or 0
        self.header.end_time = self._end_time
        self.header.message_number = self._message_number
        self.header.is_complete = True
        self.header.size = size
        self._f.seek(0)
        self._write_section(rp.SECTION_HEADER, self.header.SerializeToString())
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
