"""The mosaic kernel (``csrc/mosaic.cu``): build, bind, dispatch.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, into
``video_desensitization_torch/_build/`` under a name that carries the
source's hash, and loaded with ``ctypes``. A CPU tensor goes to the plain
PyTorch version (``ops.mosaic.mosaic_boxes_batch_``); a CUDA tensor goes to
the kernel or the call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from video_desensitization_torch.ops.mosaic import (
    DEFAULT_MOSAIC_LEVEL,
    composed_mosaic_table,
    mosaic_boxes_batch_,
)

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "mosaic.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_library(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless a library built from the same bytes exists.
    Returns the library's path; compiler output goes to ``<lib>.log``."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.vdt_mosaic_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.vdt_mosaic_scratch_bytes
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    return lib


@lru_cache(maxsize=8)
def _device_table(level: int, maxdim: int, device: torch.device) -> torch.Tensor:
    """The composed table on ``device``, after checking the properties the
    kernel's reachable-box lists rely on: every row of T is non-decreasing,
    and T[b][t] lies in [0, b) for t < b (a box's sources lie inside it)."""
    if maxdim > np.iinfo(np.int16).max:
        raise ValueError(f"frame dimension {maxdim} exceeds the int16 table")
    table = composed_mosaic_table(level, maxdim)
    if np.any(np.diff(table, axis=1) < 0):
        raise ValueError(f"mosaic table level {level} has a decreasing row")
    extent = np.arange(maxdim + 1)[:, None]
    inside = np.arange(maxdim)[None, :] < extent
    if np.any(inside & ((table < 0) | (table >= extent))):
        raise ValueError(f"mosaic table level {level} reads outside its box")
    return torch.from_numpy(table.copy()).to(device)


def mosaic_boxes_batch_cuda_(
    frames: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    level: int = DEFAULT_MOSAIC_LEVEL,
) -> torch.Tensor:
    """Mosaic every valid box of a contiguous (B, H, W, C) uint8 batch IN
    PLACE (the input is mutated and returned), C in {1, 2, 3}, any level
    >= 1. boxes: (B, K, 4) int pixel xyxy, unclipped ok; valid: (B, K) bool.

    CPU tensors run the plain PyTorch version; CUDA tensors launch the
    kernel on the current stream, counted once per call in
    ``mosaic_boxes_batch_cuda_.launches``: two CUDA kernels per 128 boxes of
    K (a snapshot of the boxes' source rows and each tile's list of boxes
    into scratch, then the in-place write). The boxes are never read on the
    host, so the call does not wait for the device.
    """
    b, h, w, c = frames.shape
    if c not in (1, 2, 3):
        raise ValueError(f"{c} channels; the kernel takes 1, 2 or 3")
    if level < 1:
        raise ValueError(f"mosaic level must be >= 1, got {level}")
    if frames.dtype != torch.uint8 or not frames.is_contiguous():
        raise ValueError("frames must be a contiguous uint8 tensor")
    if boxes.shape[:2] != valid.shape or boxes.shape[0] != b or boxes.shape[-1] != 4:
        raise ValueError(f"boxes {tuple(boxes.shape)} / valid {tuple(valid.shape)}")
    if frames.device.type == "cpu":
        return mosaic_boxes_batch_(frames, boxes, valid, level)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if frames.numel() == 0 or boxes.shape[1] == 0:
        return frames  # nothing to launch
    boxes = boxes.to(device=frames.device, dtype=torch.int32).contiguous()
    valid = valid.to(device=frames.device, dtype=torch.bool).contiguous()
    maxdim = max(h, w)
    table = _device_table(level, maxdim, frames.device)
    lib = load_library()
    scratch = torch.empty(
        lib.vdt_mosaic_scratch_bytes(b, h, w, c), dtype=torch.uint8, device=frames.device
    )
    err = lib.vdt_mosaic_launch(
        frames.data_ptr(), boxes.data_ptr(), valid.data_ptr(), table.data_ptr(),
        scratch.data_ptr(), b, h, w, c, boxes.shape[1], maxdim,
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mosaic kernel launch failed: cudaError {err}")
    mosaic_boxes_batch_cuda_.launches += 1
    return frames


mosaic_boxes_batch_cuda_.launches = 0
