"""LZ4 *block* codec for record chunk compression (COMPRESS_LZ4).

Apollo Cyber RT compresses each record chunk body with raw LZ4 block calls
(``LZ4_compress_default`` / ``LZ4_decompress_safe``). The fast path is the
clean-room C++ codec in ``csrc/vdt_lz4.cpp``, built with g++ at first use
into ``_build/`` (``utils/native.py``). Where it cannot be built or loaded,
a pure-Python decoder and a literal-only encoder (the spec's trivial
encoding: valid LZ4 that any decoder accepts, just uncompressed) take its
place. Both are host codecs; nothing here runs on the card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from video_desensitization_torch.utils import native

SOURCE = native.PACKAGE_DIR / "csrc" / "vdt_lz4.cpp"
CXX = ["g++", "-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib = None
_load_error: Optional[str] = None
_load_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    # The unpack's reader and the writers may reach here from several
    # threads: one builds and loads, the others wait for it.
    with _load_lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(native.build_library(SOURCE, CXX)))
        except (OSError, RuntimeError) as e:
            _load_error = " ".join(str(e).split())[:300] or repr(e)
            return None
        for name in ("vdt_lz4_decompress", "vdt_lz4_compress"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
        lib.vdt_lz4_compress_bound.restype = ctypes.c_long
        lib.vdt_lz4_compress_bound.argtypes = [ctypes.c_long]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def decompress(data: bytes, size_hint: int = 0) -> bytes:
    """Decompress one LZ4 block. ``size_hint`` (e.g. the chunk header's
    raw_size) avoids buffer-growth retries but is not required."""
    lib = _load()
    if lib is None:
        return _decompress_py(data)
    cap = max(int(size_hint), 4 * len(data), 1 << 16)
    for _ in range(12):  # growth capped: 64 KiB -> 256 GiB
        # np.empty: no zero-fill of the (possibly much larger) capacity;
        # tobytes() copies exactly the n decompressed bytes.
        dst = np.empty(cap, np.uint8)
        n = lib.vdt_lz4_decompress(data, len(data), dst.ctypes.data, cap)
        if n >= 0:
            return dst[:n].tobytes()
        if n == -1:
            raise ValueError("malformed LZ4 block")
        cap *= 4  # -2: destination too small
    raise ValueError("LZ4 block decompressed size out of bounds")


def compress(data: bytes) -> bytes:
    lib = _load()
    if lib is None:
        return _compress_literal_py(data)
    cap = int(lib.vdt_lz4_compress_bound(len(data)))
    dst = np.empty(cap, np.uint8)
    n = lib.vdt_lz4_compress(data, len(data), dst.ctypes.data, cap)
    if n < 0:
        raise ValueError("LZ4 compression failed")
    return dst[:n].tobytes()


# -- pure-Python codecs -------------------------------------------------------


def _decompress_py(data: bytes) -> bytes:
    src = memoryview(data)
    n = len(src)
    out = bytearray()
    i = 0
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise ValueError("malformed LZ4 block")
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise ValueError("malformed LZ4 block")
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break
        if i + 2 > n:
            raise ValueError("malformed LZ4 block")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise ValueError("malformed LZ4 block")
        mlen = token & 15
        if mlen == 15:
            while True:
                if i >= n:
                    raise ValueError("malformed LZ4 block")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - offset
        for j in range(mlen):  # overlap-safe byte copy
            out.append(out[start + j])
    return bytes(out)


def _compress_literal_py(data: bytes) -> bytes:
    """Literal-only LZ4 block (valid, uncompressed encoding)."""
    out = bytearray()
    lit = len(data)
    if lit >= 15:
        out.append(15 << 4)
        rem = lit - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    else:
        out.append(lit << 4)
    out += data
    return bytes(out)
