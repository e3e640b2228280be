"""Annex-B NAL unit parsing for H.265/H.264 elementary streams.

Used for keyframe gating during record unpack and repack (the reference's
``is_key_frame``/``key_frame_written`` state per camera topic). The camera
streams are HEVC; ``is_keyframe`` also answers for H.264.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

# HEVC NAL unit types (nal_unit_type in [16, 21] are IRAP pictures).
HEVC_IRAP_TYPES = frozenset(range(16, 22))  # BLA_W_LP .. CRA_NUT
HEVC_IDR_TYPES = frozenset({19, 20})  # IDR_W_RADL, IDR_N_LP
HEVC_PARAM_TYPES = frozenset({32, 33, 34})  # VPS, SPS, PPS

H264_IDR = 5
H264_PARAM = frozenset({7, 8})  # SPS, PPS


def iter_nal_units(stream: bytes) -> Iterator[Tuple[int, int]]:
    """Yield (start, end) byte offsets of NAL payloads (after start code)."""
    n = len(stream)
    i = stream.find(b"\x00\x00\x01")
    starts: List[int] = []
    while i != -1:
        starts.append(i + 3)
        i = stream.find(b"\x00\x00\x01", i + 3)
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # Strip the optional extra zero of 4-byte start codes from the tail.
        while e > s and k + 1 < len(starts) and stream[e - 1] == 0:
            e -= 1
        yield s, e


def hevc_nal_type(stream: bytes, offset: int) -> int:
    return (stream[offset] >> 1) & 0x3F


def is_hevc_keyframe(payload: bytes) -> bool:
    """True if the access unit contains an IRAP picture (or IDR)."""
    for s, _ in iter_nal_units(payload):
        if s < len(payload) and hevc_nal_type(payload, s) in HEVC_IRAP_TYPES:
            return True
    return False


def is_h264_keyframe(payload: bytes) -> bool:
    """True if the access unit contains an H.264 IDR slice."""
    for s, _ in iter_nal_units(payload):
        if s < len(payload) and (payload[s] & 0x1F) == H264_IDR:
            return True
    return False


def is_keyframe(payload: bytes, codec: str = "hevc") -> bool:
    """The keyframe test of ``codec``: "hevc"/"h265" or "h264"/"avc"."""
    if codec in ("hevc", "h265"):
        return is_hevc_keyframe(payload)
    if codec in ("h264", "avc"):
        return is_h264_keyframe(payload)
    raise ValueError(f"unknown codec {codec}")
