"""The mosaic kernel (``csrc/mosaic.cu``): build, bind, dispatch.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, into
``video_desensitization_torch/_build/`` under a name that carries the
source's hash (``utils/native.py``), and loaded with ``ctypes``. A CPU
tensor goes to the plain PyTorch version (``ops.mosaic``); a CUDA tensor
goes to the kernel or the call raises.

Two wrappers: ``mosaic_boxes_batch_cuda_`` on (B, H, W, C) frames, one
kernel call each, and ``mosaic_i420_batch_cuda_`` on planar I420 frames,
two kernel calls each (``i420_kernel_calls``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from video_desensitization_torch.ops.mosaic import (
    DEFAULT_MOSAIC_LEVEL,
    chroma_boxes,
    composed_mosaic_table,
    i420_frame_hw,
    mosaic_boxes_batch_,
    mosaic_i420_batch,
)
from video_desensitization_torch.utils import native

SOURCE = native.PACKAGE_DIR / "csrc" / "mosaic.cu"
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
    """Compile ``source`` with nvcc unless a library built from the same
    bytes exists. Returns the library's path; compiler output goes to
    ``<lib>.log``."""
    return native.build_library(source, [_nvcc(), *NVCC_FLAGS])


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


def i420_kernel_calls(yuv: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor, level: int):
    """The two kernel calls that mosaic a contiguous (B, H*3/2, W) I420
    batch in place, as ``(frames, boxes, valid, level)`` arguments of
    ``mosaic_boxes_batch_cuda_``, each frames a view of ``yuv`` (no copy):

    * Y: each frame's whole buffer as (B, H*3/2, W, 1), with the boxes
      clipped to the H x W Y plane first. A box's sources lie inside it, so
      no box reads or writes a chroma row and the Y rows come out as the
      plane's own mosaic.
    * U and V: each frame's buffer is six (H/2, W/2) blocks, four of Y, then
      U, then V; as (B*6, H/2, W/2, 1), with ``chroma_boxes`` valid on the U
      and V blocks only, at ``max(1, level // 2)``. The mosaic gathers each
      channel alike, so U and V as two planes equal the interleaved (U, V)
      plane of ``ops.mosaic.mosaic_i420_batch``.
    """
    b, h15, w = yuv.shape
    h, k = i420_frame_hw(yuv.shape)[0], boxes.shape[1]
    y_boxes = torch.stack(
        [boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
         boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)],
        dim=-1,
    )
    block_boxes = chroma_boxes(boxes)[:, None].expand(b, 6, k, 4).reshape(b * 6, k, 4)
    block_valid = torch.cat(
        [torch.zeros((b, 4, k), dtype=torch.bool, device=valid.device),
         valid[:, None].expand(b, 2, k)],
        dim=1,
    ).reshape(b * 6, k)
    return [
        (yuv.view(b, h15, w, 1), y_boxes, valid, level),
        (yuv.view(b * 6, h // 2, w // 2, 1), block_boxes, block_valid, max(1, level // 2)),
    ]


def mosaic_i420_batch_cuda_(
    yuv: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    level: int = DEFAULT_MOSAIC_LEVEL,
) -> torch.Tensor:
    """Mosaic every valid box of a contiguous (B, H*3/2, W) uint8 I420 batch
    IN PLACE (the input is mutated and returned), H and W even. boxes:
    (B, K, 4) int full-resolution pixel xyxy, unclipped ok; valid: (B, K).

    CPU tensors run the plain ``ops.mosaic.mosaic_i420_batch``; CUDA tensors
    make the two kernel calls of ``i420_kernel_calls`` on the current
    stream, each counted once in ``mosaic_boxes_batch_cuda_.launches``. The
    boxes are never read on the host.
    """
    i420_frame_hw(yuv.shape)
    if level < 1:
        raise ValueError(f"mosaic level must be >= 1, got {level}")
    if yuv.dtype != torch.uint8 or not yuv.is_contiguous():
        raise ValueError("frames must be a contiguous uint8 tensor")
    if boxes.shape[:2] != valid.shape or boxes.shape[0] != yuv.shape[0] or boxes.shape[-1] != 4:
        raise ValueError(f"boxes {tuple(boxes.shape)} / valid {tuple(valid.shape)}")
    if yuv.device.type == "cpu":
        return yuv.copy_(mosaic_i420_batch(yuv, boxes, valid, level))
    if yuv.device.type != "cuda":
        raise ValueError(f"unsupported device {yuv.device}")
    boxes = boxes.to(device=yuv.device, dtype=torch.int32)
    valid = valid.to(device=yuv.device, dtype=torch.bool)
    for call in i420_kernel_calls(yuv, boxes, valid, level):
        mosaic_boxes_batch_cuda_(*call)
    return yuv
