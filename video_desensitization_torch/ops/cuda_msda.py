"""The multi-scale deformable attention kernel (``csrc/msda.cu``): build,
bind, dispatch.

Built and loaded as the mosaic kernel is (``ops/cuda_mosaic.py``): ``nvcc``
for ``sm_90a`` at first use into ``video_desensitization_torch/_build/``,
a plain C interface through ``ctypes``. A CPU tensor goes to the plain
PyTorch form (``ops/msda.py::msda_plain``); a CUDA tensor goes to the
kernel or the call raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import Sequence, Tuple

import torch

from video_desensitization_torch.ops.cuda_mosaic import NVCC_FLAGS, _nvcc
from video_desensitization_torch.ops.msda import msda_plain
from video_desensitization_torch.utils import native

SOURCE = native.PACKAGE_DIR / "csrc" / "msda.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_launch_lock = threading.Lock()


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(native.build_library(SOURCE, [_nvcc(), *NVCC_FLAGS])))
    fn = lib.vdt_msda_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return lib


def msda_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    offsets: torch.Tensor,
    logits: torch.Tensor,
    ref: torch.Tensor,
) -> torch.Tensor:
    """``msda_plain``'s contract: value (B, S, H, D) float32, bfloat16 or
    float16; offsets (B, Q, H, L, P, 2), logits (B, Q, H, L*P) and ref
    (B, Q, 4) float32 -> (B, Q, H*D) in value's dtype.

    CUDA tensors make one kernel call on the current stream of the value's
    card, counted in ``msda_cuda.launches`` (under a lock); no host read
    and no synchronising call, so a CUDA graph can hold it."""
    b, s, n_head, d = value.shape
    _, q, _, n_levels, n_points, _ = offsets.shape
    if offsets.shape[:3] != (b, q, n_head) or logits.shape != (b, q, n_head, n_levels * n_points):
        raise ValueError(f"offsets {tuple(offsets.shape)} / logits {tuple(logits.shape)}")
    if ref.shape != (b, q, 4) or len(spatial_shapes) != n_levels:
        raise ValueError(f"ref {tuple(ref.shape)} / {len(spatial_shapes)} levels")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial shapes {list(spatial_shapes)} do not make {s} rows")
    if value.device.type == "cpu":
        return msda_plain(value, spatial_shapes, offsets, logits, ref)
    if value.device.type != "cuda":
        raise ValueError(f"unsupported device {value.device}")
    if value.dtype not in DTYPE_CODES:
        raise ValueError(f"value dtype {value.dtype}")
    if any(t.dtype != torch.float32 or t.device != value.device for t in (offsets, logits, ref)):
        raise ValueError("offsets, logits and ref must be float32 on the value's device")
    value, offsets, logits, ref = (t.contiguous() for t in (value, offsets, logits, ref))
    out = value.new_empty((b, q, n_head * d))
    shapes = (ctypes.c_int * (2 * n_levels))(*[v for hw in spatial_shapes for v in hw])
    lib = load_library()
    with torch.cuda.device(value.device):
        err = lib.vdt_msda_launch(
            value.data_ptr(), offsets.data_ptr(), logits.data_ptr(), ref.data_ptr(),
            out.data_ptr(), DTYPE_CODES[value.dtype], b, s, q, n_head, d, n_levels, n_points,
            shapes, torch.cuda.current_stream(value.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"msda kernel launch failed: cudaError {err}")
    with _launch_lock:
        msda_cuda.launches += 1
    return out


msda_cuda.launches = 0
