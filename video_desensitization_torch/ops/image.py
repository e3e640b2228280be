"""Image preprocessing: letterbox resize and mean subtraction on NHWC batches.

``letterbox`` = aspect-preserving resize to fit, centered on a gray canvas;
``preprocess_input`` = subtract the detector mean (104, 117, 123) in the
channel order of the input.

cv2.resize(u8, INTER_LINEAR) is not float bilinear: coefficients are short
fixed-point (scaled by 2^11 with round-half-even), the horizontal pass
accumulates u8*short exactly in int32, and the vertical pass combines two
int32 rows with one final rounding. ``resize_linear_cv2_exact`` rebuilds
that integer pipeline on tensors, so the letterbox canvas is bitwise equal
to a host cv2 letterbox. The vertical rounding has two variants (OpenCV's
scalar and SIMD kernels); ``cv2_resize_formula`` probes which one the
installed cv2 uses for a geometry, and returns None when cv2 is missing
or neither matches. Callers then take the float path (``letterbox_device``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BGR_MEAN = (104.0, 117.0, 123.0)
PAD_VALUE = 128.0

_INTER_BITS = 11  # OpenCV INTER_RESIZE_COEF_BITS
_INTER_SCALE = 1 << _INTER_BITS


def letterbox_params(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]):
    """Static letterbox geometry (new_h, new_w, top, left): scale =
    min(dst_w/src_w, dst_h/src_h), new dims truncate, offsets centre."""
    ih, iw = src_hw
    h, w = dst_hw
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    top, left = (h - nh) // 2, (w - nw) // 2
    return nh, nw, top, left


def letterbox_geometry(image_shapes, dst_hw: Tuple[int, int]) -> np.ndarray:
    """Host-exact per-image letterbox geometry for a batch: (B, 2)
    [orig_h, orig_w] -> (B, 4) float32 [nh, nw, top, left] through
    ``letterbox_params``. Device programs take this as an input: float32 on
    the device can place the content one pixel off for some source heights
    (1077 rows at 640: host nh 639, float32 floor 640)."""
    shapes = np.asarray(image_shapes)
    out = np.empty((shapes.shape[0], 4), np.float32)
    for i, (ih, iw) in enumerate(shapes):
        out[i] = letterbox_params((int(ih), int(iw)), dst_hw)
    return out


def letterbox_host(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """The reference's letterbox with cv2. ``size`` is (width, height) as
    the reference passes it. Returns the float64 (h, w, 3) canvas the
    reference builds (``np.ones() * 128``)."""
    import cv2

    ih, iw = image.shape[:2]
    w, h = size
    nh, nw, top, left = letterbox_params((ih, iw), (h, w))
    canvas = np.ones([h, w, 3]) * PAD_VALUE
    canvas[top : top + nh, left : left + nw] = cv2.resize(image, (nw, nh))
    return canvas


def preprocess_input(image: torch.Tensor) -> torch.Tensor:
    """Subtract the detector training mean, preserving channel order."""
    return image - torch.tensor(BGR_MEAN, dtype=image.dtype, device=image.device)


def _pad_canvas(resized: torch.Tensor, dst_hw, top: int, left: int, pad_value):
    """Place an NHWC batch at (top, left) on a ``pad_value`` canvas."""
    b, nh, nw, c = resized.shape
    h, w = dst_hw
    canvas = torch.full(
        (b, h, w, c), pad_value, dtype=resized.dtype, device=resized.device
    )
    canvas[:, top : top + nh, left : left + nw] = resized
    return canvas


def letterbox_device(
    frames: torch.Tensor, dst_hw: Tuple[int, int], pad_value: float = PAD_VALUE
) -> torch.Tensor:
    """Float letterbox of an NHWC batch (half-pixel bilinear, no antialias).
    Returns float32 (B, dst_h, dst_w, C)."""
    _, ih, iw, _ = frames.shape
    nh, nw, top, left = letterbox_params((ih, iw), dst_hw)
    x = frames.to(torch.float32).permute(0, 3, 1, 2)
    resized = F.interpolate(
        x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=False
    ).permute(0, 2, 3, 1)
    return _pad_canvas(resized, dst_hw, top, left, pad_value)


def cv2_linear_axis_tables(src: int, dst: int):
    """Per-axis cv2 INTER_LINEAR sampling tables (i0, i1, a0, a1).

    The source coordinate is computed in double then cast to float32; the
    short coefficients are round-half-even of float32 coefficient * 2048.
    Tap indices are clamped into range while the fractional weights are not
    (cv2's border handling for upscales).
    """
    scale = np.float64(src) / np.float64(dst)
    d = np.arange(dst, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    u = (f - s).astype(np.float32)
    i0 = np.clip(s, 0, src - 1).astype(np.int32)
    i1 = np.clip(s + 1, 0, src - 1).astype(np.int32)
    a1 = np.rint(u * np.float32(_INTER_SCALE)).astype(np.int32)
    a0 = np.rint((np.float32(1.0) - u) * np.float32(_INTER_SCALE)).astype(np.int32)
    return i0, i1, a0, a1


_FORMULA_CACHE: dict = {}


def cv2_resize_formula(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]):
    """"scalar", "simd", or None: which rounding of
    ``resize_linear_cv2_exact`` matches the installed cv2 for this geometry,
    found by resizing random images with both (on the CPU). None when cv2
    does not import or neither matches."""
    key = (tuple(src_hw), tuple(dst_hw))
    if key in _FORMULA_CACHE:
        return _FORMULA_CACHE[key]
    try:
        import cv2
    except ImportError:
        _FORMULA_CACHE[key] = None
        return None
    rng = np.random.default_rng(0)
    imgs = [
        rng.integers(0, 256, (*src_hw, 3), dtype=np.uint8) for _ in range(2)
    ] + [np.full((*src_hw, 3), 128, np.uint8)]
    verdict = None
    for formula in ("simd", "scalar"):
        if all(
            np.array_equal(
                resize_linear_cv2_exact(torch.from_numpy(im[None]), dst_hw, formula)[0].numpy(),
                cv2.resize(im, (dst_hw[1], dst_hw[0]), interpolation=cv2.INTER_LINEAR),
            )
            for im in imgs
        ):
            verdict = formula
            break
    _FORMULA_CACHE[key] = verdict
    return verdict


def resize_linear_cv2_exact(
    frames: torch.Tensor, dst_hw: Tuple[int, int], formula: str = "scalar"
) -> torch.Tensor:
    """cv2-INTER_LINEAR-exact resize of a uint8 NHWC batch -> uint8
    (B, dh, dw, C). An axis whose second coefficients are all zero (exact
    1/N scales, identity) is a point selection with weight 2048, which the
    full formula below reproduces bit for bit."""
    _, ih, iw, _ = frames.shape
    dh, dw = dst_hw
    x0, x1, ax0, ax1 = cv2_linear_axis_tables(iw, dw)
    y0, y1, by0, by1 = cv2_linear_axis_tables(ih, dh)
    if (ih, iw) == (dh, dw) and not ax1.any() and not by1.any():
        return frames  # identity geometry
    dev = frames.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    src = frames.to(torch.int32)
    if ax1.any():
        rows = torch.index_select(src, 2, t(x0)) * t(ax0)[None, None, :, None] + (
            torch.index_select(src, 2, t(x1)) * t(ax1)[None, None, :, None]
        )
    else:  # horizontal point selection (a0 == 2048 everywhere)
        rows = torch.index_select(src, 2, t(x0)) << _INTER_BITS
    r0 = torch.index_select(rows, 1, t(y0))
    b0 = t(by0)[None, :, None, None]
    if by1.any():
        r1 = torch.index_select(rows, 1, t(y1))
        b1 = t(by1)[None, :, None, None]
    else:  # vertical point selection: the zero-weight tap contributes 0
        r1 = torch.zeros_like(r0)
        b1 = torch.zeros_like(b0)
    if formula == "scalar":
        out = (r0 * b0 + r1 * b1 + (1 << (2 * _INTER_BITS - 1))) >> (2 * _INTER_BITS)
    else:
        out = ((((r0 >> 4) * b0) >> 16) + (((r1 >> 4) * b1) >> 16) + 2) >> 2
    return torch.clamp(out, 0, 255).to(torch.uint8)


def letterbox_device_exact(
    frames: torch.Tensor,
    dst_hw: Tuple[int, int],
    pad_value: float = PAD_VALUE,
    formula: str = "scalar",
) -> torch.Tensor:
    """Float32 letterbox with the cv2-exact integer resize: bitwise
    ``letterbox_host`` when ``formula`` is ``cv2_resize_formula``'s verdict
    for the content resize."""
    _, ih, iw, _ = frames.shape
    nh, nw, top, left = letterbox_params((ih, iw), dst_hw)
    resized = resize_linear_cv2_exact(frames, (nh, nw), formula).to(torch.float32)
    return _pad_canvas(resized, dst_hw, top, left, pad_value)


def letterbox_canvas_u8(
    frames: torch.Tensor,
    dst_hw: Tuple[int, int],
    pad_value: int = int(PAD_VALUE),
    formula: str = "scalar",
) -> torch.Tensor:
    """Bit-exact letterbox kept in uint8: the shared canvas that both
    detectors of the engine read."""
    _, ih, iw, _ = frames.shape
    nh, nw, top, left = letterbox_params((ih, iw), dst_hw)
    resized = resize_linear_cv2_exact(frames, (nh, nw), formula)
    return _pad_canvas(resized, dst_hw, top, left, pad_value)


def letterbox_canvas_formula(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]):
    """The cv2 rounding formula for the letterbox content resize of this
    geometry, or None (callers then letterbox per detector in float)."""
    nh, nw, _, _ = letterbox_params(src_hw, dst_hw)
    return cv2_resize_formula(src_hw, (nh, nw))


def letterbox_device_auto(
    frames: torch.Tensor,
    dst_hw: Tuple[int, int],
    pad_value: float = PAD_VALUE,
    exact: str = "auto",
) -> torch.Tensor:
    """Float32 letterbox with the cv2-exact path chosen when possible.

    ``exact``: "auto" takes the cv2-exact integer resize when the installed
    cv2's rounding is recognised for this geometry, else the float resize;
    "never" forces the float path; "scalar"/"simd" force a formula.
    """
    _, ih, iw, _ = frames.shape
    formula: Optional[str] = None
    if exact in ("scalar", "simd"):
        formula = exact
    elif exact == "auto":
        formula = letterbox_canvas_formula((ih, iw), dst_hw)
    if formula is None:
        return letterbox_device(frames, dst_hw, pad_value=pad_value)
    return letterbox_device_exact(frames, dst_hw, pad_value, formula)


def preprocess_batch_device(
    frames: torch.Tensor,
    input_hw: Tuple[int, int],
    dtype=torch.float32,
    exact: str = "auto",
) -> torch.Tensor:
    """uint8 NHWC frames -> letterboxed, mean-subtracted NHWC model input."""
    x = letterbox_device_auto(frames, input_hw, exact=exact)
    return preprocess_input(x).to(dtype)
