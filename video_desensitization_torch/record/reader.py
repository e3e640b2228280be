"""Cyber record container reader.

Parses the section-framed protobuf format: each section is a 16-byte little-
endian struct (int64 type, int64 size) followed by ``size`` bytes of proto.
The header section's proto region is a fixed 2048 bytes (zero-padded). The
public API mirrors ``cyber_record.record.Record``: ``read_messages()`` yields
``(topic, message, time_ns)`` tuples, with camera-topic payloads parsed as
``CompressedImage`` (raw bytes otherwise).
"""

from __future__ import annotations

import bz2
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple, Union

from video_desensitization_torch.record import lz4block
from video_desensitization_torch.record.proto import cyber_record_pb2 as rp
from video_desensitization_torch.record.proto import sensor_image_pb2 as sp
from video_desensitization_torch.record.topics import COMPRESSED_IMAGE_TYPE

SECTION_STRUCT = struct.Struct("<qq")
HEADER_LENGTH = 2048


class RecordException(Exception):
    pass


def _parse_payload(message_type: str, content: bytes):
    if message_type == COMPRESSED_IMAGE_TYPE:
        img = sp.CompressedImage()
        try:
            img.ParseFromString(content)
        except Exception:  # malformed message: surface raw bytes, don't kill
            # the whole record iteration (the reference logs "The record ...
            # data exception" per message and continues)
            return content
        return img
    return content


class RecordReader:
    """Read a .record file: header, channels, and chunked messages."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise RecordException(f"record not found: {path}")
        self.path = path
        self._file_size = os.path.getsize(path)
        self.header = rp.Header()
        self.channels: Dict[str, rp.Channel] = {}
        self._scan()

    def _read_section(self, f) -> Optional[Tuple[int, bytes]]:
        raw = f.read(SECTION_STRUCT.size)
        if len(raw) < SECTION_STRUCT.size:
            return None
        stype, size = SECTION_STRUCT.unpack(raw)
        # Sanity-check before trusting a corruption-controlled int64 (a
        # garbage "size" must not drive a huge allocation).
        if size < 0 or size > self._file_size or stype < 0 or stype > 4:
            raise RecordException(
                f"{self.path}: corrupt section framing "
                f"(type={stype}, size={size})"
            )
        if stype == rp.SECTION_HEADER:
            if size > HEADER_LENGTH:
                raise RecordException(
                    f"{self.path}: header section size {size} exceeds the "
                    f"fixed {HEADER_LENGTH}-byte header region"
                )
            data = f.read(HEADER_LENGTH)
            return stype, data[:size]
        data = f.read(size)
        if len(data) < size:
            raise RecordException("truncated section")
        return stype, data

    def _scan(self):
        with open(self.path, "rb") as f:
            first = self._read_section(f)
            if first is None or first[0] != rp.SECTION_HEADER:
                raise RecordException(f"{self.path}: missing record header")
            self.header.ParseFromString(first[1])
            if self.header.compress not in (
                rp.COMPRESS_NONE,
                rp.COMPRESS_BZ2,
                rp.COMPRESS_LZ4,
            ):
                raise RecordException(
                    f"unsupported compression: {self.header.compress}"
                )
            while True:
                sec = self._read_section(f)
                if sec is None:
                    break
                stype, data = sec
                if stype == rp.SECTION_CHANNEL:
                    ch = rp.Channel()
                    ch.ParseFromString(data)
                    self.channels[ch.name] = ch
                # chunks are read in read_messages; the index is advisory

    def _decompress_chunk(self, data: bytes, raw_size_hint: int = 0) -> bytes:
        """Undo the header-declared chunk-body compression (NONE/BZ2/LZ4)."""
        if self.header.compress == rp.COMPRESS_BZ2:
            return bz2.decompress(data)
        if self.header.compress == rp.COMPRESS_LZ4:
            return lz4block.decompress(data, size_hint=raw_size_hint)
        return data

    def read_messages(
        self, topics: Optional[Union[str, List[str]]] = None
    ) -> Iterator[Tuple[str, object, int]]:
        """Yield (topic, parsed_message_or_bytes, time_ns) in file order."""
        if isinstance(topics, str):
            topics = [topics]
        want = set(topics) if topics else None
        with open(self.path, "rb") as f:
            # Skip header.
            self._read_section(f)
            raw_size_hint = 0
            while True:
                sec = self._read_section(f)
                if sec is None:
                    break
                stype, data = sec
                if stype == rp.SECTION_CHUNK_HEADER:
                    # Advisory only: a corrupt chunk header must neither
                    # abort iteration nor drive an unbounded allocation.
                    ch_header = rp.ChunkHeader()
                    try:
                        ch_header.ParseFromString(data)
                        raw = int(ch_header.raw_size)
                    except Exception:
                        raw = 0
                    # Sizing hint for LZ4 (raw message bytes; proto framing
                    # adds a little on top — decompress() grows as needed),
                    # clamped to a sane multiple of the file size.
                    cap = max(64 << 20, self._file_size * 64)
                    raw_size_hint = min(int(raw * 1.25) + 4096, cap)
                    continue
                if stype != rp.SECTION_CHUNK_BODY:
                    continue
                body = rp.ChunkBody()
                body.ParseFromString(self._decompress_chunk(data, raw_size_hint))
                for m in body.messages:
                    if want is not None and m.channel_name not in want:
                        continue
                    ch = self.channels.get(m.channel_name)
                    mtype = ch.message_type if ch else ""
                    yield m.channel_name, _parse_payload(mtype, m.content), m.time

    def message_count(self, topic: Optional[str] = None) -> int:
        return sum(1 for _ in self.read_messages(topic))
