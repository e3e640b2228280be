"""Python bindings for the native libav layer (ctypes), with a cv2 fallback.

``VideoDecoder`` / ``VideoEncoder`` / ``PacketDemuxer`` wrap the C++ shim in
``csrc/vdt_av.cpp``, built with g++ against the system's libavformat,
libavcodec, libavutil and libswscale at first use, into
``video_desensitization_torch/_build/`` (``utils/native.py``). If the native
library cannot be built or loaded, decode falls back to cv2.VideoCapture and
encode to cv2.VideoWriter codecs (no HEVC); packet demux has no fallback.
This is a codec fallback only: it decides how frames are read and written,
never where they are processed. ``codec_path()`` says which path runs.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from video_desensitization_torch.utils import native
from video_desensitization_torch.utils.logging import get_logger

SOURCE = native.PACKAGE_DIR / "csrc" / "vdt_av.cpp"
CXX = ["g++", "-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]
AV_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]

_lib = None
_load_error: Optional[str] = None
_load_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    if _lib is not None or _load_error is not None:
        return _lib
    # Serialize the first load: threads of one process must not build and
    # load the library at once.
    with _load_lock:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(native.build_library(SOURCE, CXX, AV_LIBS)))
    except (OSError, RuntimeError) as e:
        _load_error = " ".join(str(e).split())[:300] or repr(e)
        get_logger("av").info("native libav layer unavailable (%s); using cv2", _load_error)
        return None

    lib.vdt_last_error.restype = ctypes.c_char_p
    lib.vdt_decoder_open.restype = ctypes.c_void_p
    lib.vdt_decoder_open.argtypes = [ctypes.c_char_p]
    lib.vdt_decoder_info.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.vdt_decoder_next.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vdt_decoder_next_i420.argtypes = lib.vdt_decoder_next.argtypes
    lib.vdt_decoder_close.argtypes = [ctypes.c_void_p]
    lib.vdt_encoder_open.restype = ctypes.c_void_p
    lib.vdt_encoder_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_char_p,
    ]
    lib.vdt_encoder_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.vdt_encoder_write_i420.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.vdt_encoder_close.argtypes = [ctypes.c_void_p]
    lib.vdt_demux_open.restype = ctypes.c_void_p
    lib.vdt_demux_open.argtypes = [ctypes.c_char_p]
    lib.vdt_demux_time_base.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vdt_demux_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vdt_demux_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def codec_path() -> str:
    """Which codec path decodes and encodes: "native libav", or "cv2" with
    the reason the native library did not load."""
    return "native libav" if native_available() else f"cv2 ({_load_error})"


class I420UnsupportedError(IOError):
    """The stream has no lossless I420 form (odd dims, non-yuv420p source
    like full-range MJPEG or 4:2:2/10-bit). The probed frame is RETAINED:
    callers fall back to the RGB iterator without losing it. This is the
    TYPED fallback signal — pipeline code must catch this class, never
    match error-message substrings."""


class VideoDecoder:
    """Iterate RGB uint8 frames of a video file (container or raw .h265)."""

    def __init__(self, path: str, initial_guess_hw: Tuple[int, int] = (2176, 3840)):
        """initial_guess_hw sizes the first buffer for raw streams whose
        dims are unknown until the first decode; a larger frame triggers one
        clean grow-and-retry (never an out-of-bounds write)."""
        self.path = path
        self._initial_guess_hw = initial_guess_hw
        self._lib = _load()
        self._h = None
        self._cap = None
        if self._lib is not None:
            self._h = self._lib.vdt_decoder_open(path.encode())
            if not self._h:
                raise IOError(
                    f"decode open failed: {self._lib.vdt_last_error().decode()}"
                )
            w = ctypes.c_int()
            h = ctypes.c_int()
            fps = ctypes.c_double()
            n = ctypes.c_int64()
            self._lib.vdt_decoder_info(self._h, w, h, fps, n)
            self.width, self.height = w.value, h.value
            self.fps = fps.value
            self.nframes = n.value or None
        else:
            import cv2

            self._cap = cv2.VideoCapture(path)
            if not self._cap.isOpened():
                raise IOError(f"cv2 cannot open {path}")
            self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self.fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 0.0
            self.nframes = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)) or None

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        pending = getattr(self, "_pending_rgb", None)
        if pending is not None:
            self._pending_rgb = None
            return pending
        if self._h is not None:
            # Raw .h265 streams report 0x0 until the first frame: start with
            # a 4K-sized guess. vdt_decoder_next takes the buffer CAPACITY and
            # fails cleanly with -3 (frame retained) when the decoded frame is
            # larger — the exact dims come back in out_w/out_h, so one retry
            # with a right-sized buffer always succeeds. No OOB writes for
            # oversized streams or mid-stream resolution changes.
            cap = self.height * self.width * 3
            if cap == 0:
                gh, gw = self._initial_guess_hw
                cap = gh * gw * 3
            # Allocate slack past the logical capacity: sws_scale's SIMD row
            # writes can overshoot unaligned row ends by a few bytes.
            slack = 256
            out_w = ctypes.c_int()
            out_h = ctypes.c_int()
            buf = np.empty((cap + slack,), np.uint8)
            rc = self._lib.vdt_decoder_next(
                self._h, buf.ctypes.data, cap, out_w, out_h
            )
            if rc == -3:  # frame exceeds buffer: retry with exact capacity
                cap = out_w.value * out_h.value * 3
                buf = np.empty((cap + slack,), np.uint8)
                rc = self._lib.vdt_decoder_next(
                    self._h, buf.ctypes.data, cap, out_w, out_h
                )
            if rc == 0:
                raise StopIteration
            if rc < 0:
                raise IOError(self._lib.vdt_last_error().decode())
            w, h = out_w.value, out_h.value
            self.width, self.height = w, h
            # Contiguous-slice view (no copy); keeps the slack alive via base.
            return buf[: h * w * 3].reshape(h, w, 3)
        import cv2

        ok, frame = self._cap.read()
        if not ok:
            raise StopIteration
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def read_i420(self) -> "np.ndarray | None":
        """Next frame as planar I420 (H*3/2, W) uint8, or None at EOF.

        The zero-conversion transport for the fused engine's yuv420 IO mode:
        HEVC camera frames are yuv420p natively, so the native path is a
        plane copy (no sws RGB pass). Falls back to the RGB iterator + cv2
        conversion when the native library is unavailable, and raises for
        odd-dimensioned streams (no I420 form — use the RGB iterator)."""
        if self._h is not None:
            cap = self.height * self.width * 3 // 2
            if cap == 0:
                gh, gw = self._initial_guess_hw
                cap = gh * gw * 3 // 2
            slack = 256
            out_w = ctypes.c_int()
            out_h = ctypes.c_int()
            buf = np.empty((cap + slack,), np.uint8)
            rc = self._lib.vdt_decoder_next_i420(
                self._h, buf.ctypes.data, cap, out_w, out_h
            )
            if rc == -3:  # frame exceeds buffer: retry with exact capacity
                cap = out_w.value * out_h.value * 3 // 2
                buf = np.empty((cap + slack,), np.uint8)
                rc = self._lib.vdt_decoder_next_i420(
                    self._h, buf.ctypes.data, cap, out_w, out_h
                )
            if rc == 0:
                return None
            if rc == -4:  # no I420 form; frame retained for the RGB iterator
                raise I420UnsupportedError(self._lib.vdt_last_error().decode())
            if rc < 0:
                raise IOError(self._lib.vdt_last_error().decode())
            w, h = out_w.value, out_h.value
            self.width, self.height = w, h
            return buf[: h * 3 // 2 * w].reshape(h * 3 // 2, w)
        try:
            frame = next(self)
        except StopIteration:
            return None
        import cv2

        if (frame.shape[0] | frame.shape[1]) & 1:
            # Mirror the native path's frame-retained contract: stash the
            # decoded frame so a caller probing I420 support can fall back
            # to the RGB iterator without losing it (__next__ checks this).
            self._pending_rgb = frame
            raise I420UnsupportedError(
                f"I420 needs even dims, got {frame.shape[1]}x{frame.shape[0]}"
            )
        return cv2.cvtColor(frame, cv2.COLOR_RGB2YUV_I420)

    def close(self):
        if self._h is not None:
            self._lib.vdt_decoder_close(self._h)
            self._h = None
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# Reference repack settings: HEVC 10 Mbps, preset medium (recordDeal.so
# strings 'b:v'/'10M'/'preset'/'medium' — SURVEY.md C2).
HEVC_DEFAULTS = dict(codec="libx265", bitrate=10_000_000, preset="medium")


def default_codec_for(path_or_ext: str) -> str:
    """Default encoder by output extension (single source of truth).

    mp4/mov map to MPEG-4 part 2 — the reference's cv2 'mp4v' writer
    (combine_detect.py:501-508) and ~8x cheaper than libx264 on one core;
    pass an explicit codec for H.264.
    """
    ext = path_or_ext.lower().rsplit(".", 1)[-1]
    return {
        "h265": "libx265",
        "hevc": "libx265",
        "265": "libx265",
        "avi": "mjpeg",
    }.get(ext, "mpeg4")


class VideoEncoder:
    """Encode RGB uint8 frames to a video file.

    Native path supports HEVC/H.264/MJPEG into any libav-supported container
    (including raw .h265 Annex-B when the path ends in .h265/.hevc/.265).
    """

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        fps: float = 30.0,
        codec: str = "libx265",
        bitrate: int = 10_000_000,
        preset: str = "medium",
        x265_params: str = "",
    ):
        """x265_params: raw colon-separated x265 option string forwarded to
        libx265 (native path only; ignored for other codecs). The encode
        threading knob on many-core hosts — e.g. "pools=8:frame-threads=4"
        — where the default preset-driven auto threading is the record
        job's tail bottleneck ([SETTINGS] encode_threads builds this)."""
        self.path = path
        self.width, self.height = width, height
        self._lib = _load()
        self._h = None
        self._writer = None
        if self._lib is not None:
            self._h = self._lib.vdt_encoder_open(
                path.encode(),
                width,
                height,
                float(fps),
                codec.encode(),
                int(bitrate),
                preset.encode(),
                x265_params.encode(),
            )
            if not self._h:
                raise IOError(
                    f"encode open failed: {self._lib.vdt_last_error().decode()}"
                )
        else:
            import cv2

            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            self._writer = cv2.VideoWriter(path, fourcc, fps, (width, height))
            if not self._writer.isOpened():
                raise IOError(f"cv2 VideoWriter cannot open {path}")

    def write(self, frame_rgb: np.ndarray):
        frame_rgb = np.ascontiguousarray(frame_rgb, np.uint8)
        if self._h is not None:
            rc = self._lib.vdt_encoder_write(self._h, frame_rgb.ctypes.data)
            if rc < 0:
                raise IOError(self._lib.vdt_last_error().decode())
        else:
            import cv2

            self._writer.write(cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR))

    def write_i420(self, frame_yuv: np.ndarray):
        """Write a planar I420 (H*3/2, W) uint8 frame — the fused engine's
        yuv420 output, straight into the yuv420p encoder with no RGB pass."""
        frame_yuv = np.ascontiguousarray(frame_yuv, np.uint8)
        if frame_yuv.shape != (self.height * 3 // 2, self.width):
            raise ValueError(
                f"expected I420 ({self.height * 3 // 2}, {self.width}), "
                f"got {frame_yuv.shape}"
            )
        if self._h is not None:
            rc = self._lib.vdt_encoder_write_i420(self._h, frame_yuv.ctypes.data)
            if rc < 0:
                raise IOError(self._lib.vdt_last_error().decode())
        else:
            import cv2

            self._writer.write(cv2.cvtColor(frame_yuv, cv2.COLOR_YUV2BGR_I420))

    def close(self):
        if self._h is not None:
            self._lib.vdt_encoder_close(self._h)
            self._h = None
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Packet:
    __slots__ = ("data", "pts", "dts", "duration", "is_key")

    def __init__(self, data: bytes, pts: int, dts: int, duration: int, is_key: bool):
        self.data = data
        self.pts = pts
        self.dts = dts
        self.duration = duration
        self.is_key = is_key


class PacketDemuxer:
    """Compressed-packet iterator (the readPacket.ReadPacket analog)."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native av layer unavailable: {_load_error}")
        self._lib = lib
        self._h = lib.vdt_demux_open(path.encode())
        if not self._h:
            raise IOError(f"demux open failed: {lib.vdt_last_error().decode()}")
        num = ctypes.c_int()
        den = ctypes.c_int()
        lib.vdt_demux_time_base(self._h, num, den)
        self.time_base = (num.value, den.value)

    def __iter__(self) -> Iterator[Packet]:
        return self

    def __next__(self) -> Packet:
        data = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_int()
        pts = ctypes.c_int64()
        dts = ctypes.c_int64()
        dur = ctypes.c_int64()
        key = ctypes.c_int()
        rc = self._lib.vdt_demux_next(self._h, data, size, pts, dts, dur, key)
        if rc == 0:
            raise StopIteration
        if rc < 0:
            raise IOError(self._lib.vdt_last_error().decode())
        buf = ctypes.string_at(data, size.value)
        return Packet(buf, pts.value, dts.value, dur.value, bool(key.value))

    def close(self):
        if self._h:
            self._lib.vdt_demux_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_packets(self) -> List[Packet]:
        return list(self)
