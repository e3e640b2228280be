"""Detection-interval tracking: detect every Nth frame, cover the rest.

The reference detects on every frame (combine_detect.py:183-277). This
module keeps every frame but amortizes the detectors over an ordered
stream: full detection runs on keyframes (every ``interval``-th frame), and
the frames in between are covered by matched, linearly interpolated,
margin-inflated keyframe boxes, pixelated on the host with cv2. Gap frames
never reach the device; that is the design, not a fallback.

Privacy semantics:

- Keyframes run the engine's own program and mosaic; tracks the detector
  missed at a keyframe (coasting, below) are blurred on the host on top.
- A box seen at both flanking keyframes is linearly interpolated and
  inflated by ``margin`` x box size + ``motion_slack`` x displacement,
  peaked mid-gap.
- A box seen at only one flanking keyframe is applied across the whole
  gap, growing by ``appear_slack`` x box size toward the unseen side.
- A box missed at both flanking keyframes is still covered: every box is
  remembered as a track (``KeyframeTracker``), and an unmatched track
  coasts for up to ``coast`` keyframes, velocity-extrapolated, its
  inflation growing with the extrapolation distance. A box missed at more
  than ``coast`` consecutive keyframes is unprotected until seen again.
- ``interval = 1`` is the identity: every frame is a keyframe.

``TrackingEngine`` wraps a fused or tiered engine (``[TPU] detect_interval
= N`` in config.ini); it tracks only on the ordered stream path
(``process_stream``) and delegates everything else to the base engine.
The multicam record job keeps one ``CameraTracker`` per camera
(``pipeline/multicam.py``) and co-batches only the keyframes.

The numbers are float64 numpy throughout, so the boxes equal the JAX
package's ``pipeline/tracking.py`` exactly on the same detections.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from video_desensitization_torch.ops.mosaic import (
    gaussian_blur_host_inplace,
    i420_host_planes,
    mosaic_host_inplace,
    mosaic_i420_host_inplace,
)
from video_desensitization_torch.pipeline.engine import EngineResult

Box = Sequence[float]  # [x1, y1, x2, y2] in pixels

# TrackingEngine's keyframe batches in flight and the host threads that
# blur gap frames (TrackingEngine and the multicam job); the JAX package's
# values.
DEPTH = 2
BLUR_WORKERS = 4


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of two (N,4) / (M,4) xyxy box arrays -> (N, M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def greedy_match(
    a: np.ndarray, b: np.ndarray, iou_thresh: float = 0.3
) -> Tuple[List[Tuple[int, int]], List[int], List[int]]:
    """Greedy best-first IoU matching.

    Returns (pairs, unmatched_a, unmatched_b); a pair is accepted only at
    IoU >= iou_thresh, each box matched at most once.
    """
    iou = iou_matrix(a, b).copy()
    pairs: List[Tuple[int, int]] = []
    used_a: set = set()
    used_b: set = set()
    while iou.size:
        i, j = np.unravel_index(np.argmax(iou), iou.shape)
        if iou[i, j] < iou_thresh:
            break
        pairs.append((int(i), int(j)))
        used_a.add(int(i))
        used_b.add(int(j))
        iou[i, :] = -1.0
        iou[:, j] = -1.0
    un_a = [i for i in range(len(a)) if i not in used_a]
    un_b = [j for j in range(len(b)) if j not in used_b]
    return pairs, un_a, un_b


def _inflate_clip(
    b: np.ndarray, pad_x: float, pad_y: float, w: int, h: int
) -> Optional[List[float]]:
    x1 = max(0.0, float(b[0]) - pad_x)
    y1 = max(0.0, float(b[1]) - pad_y)
    x2 = min(float(w), float(b[2]) + pad_x)
    y2 = min(float(h), float(b[3]) + pad_y)
    if x2 - x1 < 1.0 or y2 - y1 < 1.0:
        return None
    return [x1, y1, x2, y2]


def propagate_boxes(
    d0: Sequence[Box],
    d1: Optional[Sequence[Box]],
    n_gap: int,
    frame_hw: Tuple[int, int],
    margin: float = 0.2,
    motion_slack: float = 0.5,
    appear_slack: float = 0.5,
    iou_thresh: float = 0.3,
) -> List[List[List[float]]]:
    """Cover the ``n_gap - 1`` frames strictly between two keyframes.

    d0 / d1: pixel boxes detected at the earlier / later keyframe
    (``d1=None`` for a stream tail after the last keyframe). Returns one
    box list per intermediate frame, in time order. Matched boxes are
    lerped and inflated by ``margin`` x size plus a mid-gap-peaked
    ``motion_slack`` x displacement term; one-sided boxes persist across
    the gap growing by ``appear_slack`` x size toward the unseen end.
    """
    h, w = frame_hw
    a0 = np.asarray(d0, np.float64).reshape(-1, 4)
    out: List[List[List[float]]] = [[] for _ in range(max(0, n_gap - 1))]
    if d1 is None:
        a1 = np.zeros((0, 4))
        pairs: List[Tuple[int, int]] = []
        un0 = list(range(len(a0)))
        un1: List[int] = []
    else:
        a1 = np.asarray(d1, np.float64).reshape(-1, 4)
        pairs, un0, un1 = greedy_match(a0, a1, iou_thresh)
    for j in range(max(0, n_gap - 1)):
        alpha = (j + 1) / n_gap
        boxes: List[Optional[List[float]]] = []
        for i0, i1 in pairs:
            b0, b1 = a0[i0], a1[i1]
            b = (1 - alpha) * b0 + alpha * b1
            delta = np.abs(b1 - b0)
            peak = 2.0 * motion_slack * alpha * (1 - alpha)
            pad_x = margin * (b[2] - b[0]) + peak * max(delta[0], delta[2])
            pad_y = margin * (b[3] - b[1]) + peak * max(delta[1], delta[3])
            boxes.append(_inflate_clip(b, pad_x, pad_y, w, h))
        for i0 in un0:
            b = a0[i0]
            gx = (margin + alpha * appear_slack) * (b[2] - b[0])
            gy = (margin + alpha * appear_slack) * (b[3] - b[1])
            boxes.append(_inflate_clip(b, gx, gy, w, h))
        for i1 in un1:
            b = a1[i1]
            gx = (margin + (1 - alpha) * appear_slack) * (b[2] - b[0])
            gy = (margin + (1 - alpha) * appear_slack) * (b[3] - b[1])
            boxes.append(_inflate_clip(b, gx, gy, w, h))
        out[j] = [bx for bx in boxes if bx is not None]
    return out


class KeyframeTracker:
    """Per-class track memory across keyframes, with miss coasting.

    ``propagate_boxes`` alone covers a gap from its two flanking keyframe
    detections, so a box the detector missed at both of them would get no
    cover. This tracker remembers every box across keyframes: a track
    unmatched at a keyframe coasts for up to ``coast`` further keyframes,
    extrapolated by its last observed per-keyframe velocity.

    One tracker per (stream, detection class); feed keyframe detections in
    time order through :meth:`observe`.
    """

    def __init__(
        self, coast: int = 3, iou_thresh: float = 0.3, dist_thresh: float = 3.0
    ):
        self.coast = int(coast)
        self.iou_thresh = iou_thresh  # kept for API symmetry; see dist_thresh
        # Tracks match detections by normalized CENTER DISTANCE, not IoU: at
        # large intervals the displacement between keyframes exceeds the box
        # size (IoU 0 for the same object), and an IoU gate would turn every
        # fast mover into a ghost coasting track. dist_thresh is in units of
        # the box diagonal, scaled by the extrapolation gap (+1 per missed
        # keyframe).
        self.dist_thresh = dist_thresh
        # each: {"box": (4,) at last sighting, "vel": (4,)/keyframe, "miss": int}
        self.tracks: List[dict] = []

    @staticmethod
    def _dist_match(preds: np.ndarray, d: np.ndarray, limits: np.ndarray):
        """Greedy nearest-center matching with per-track distance limits."""
        pairs: List[Tuple[int, int]] = []
        if len(preds) == 0 or len(d) == 0:
            return pairs, list(range(len(preds))), list(range(len(d)))
        ca = (preds[:, :2] + preds[:, 2:]) / 2.0
        cb = (d[:, :2] + d[:, 2:]) / 2.0
        dist = np.linalg.norm(ca[:, None, :] - cb[None, :, :], axis=-1)
        score = dist / np.maximum(limits[:, None], 1e-9)
        used_t: set = set()
        used_d: set = set()
        while score.size:
            i, j = np.unravel_index(np.argmin(score), score.shape)
            if score[i, j] > 1.0:
                break
            pairs.append((int(i), int(j)))
            used_t.add(int(i))
            used_d.add(int(j))
            score[i, :] = np.inf
            score[:, j] = np.inf
        un_t = [i for i in range(len(preds)) if i not in used_t]
        un_d = [j for j in range(len(d)) if j not in used_d]
        return pairs, un_t, un_d

    def observe(self, det: Sequence[Box]) -> List[dict]:
        """Update with one keyframe's detections (in time order).

        Returns the coasting snapshot for THIS keyframe: one dict per live
        unmatched track -- {"box": extrapolated position at this keyframe,
        "vel": per-keyframe velocity, "miss": keyframes since last sighting
        (>= 1)}. Matched and newly seen boxes are absorbed into the track
        state and not returned (``propagate_boxes`` covers them).
        """
        d = np.asarray(det, np.float64).reshape(-1, 4)
        if self.tracks:
            preds = np.stack(
                [t["box"] + t["vel"] * (t["miss"] + 1) for t in self.tracks]
            )
            diag = np.hypot(
                preds[:, 2] - preds[:, 0], preds[:, 3] - preds[:, 1]
            )
            gaps = np.array([t["miss"] + 1 for t in self.tracks], np.float64)
            limits = self.dist_thresh * diag * gaps
            pairs, un_t, un_d = self._dist_match(preds, d, limits)
        else:
            pairs, un_t, un_d = [], [], list(range(len(d)))
        nxt: List[dict] = []
        for ti, di in pairs:
            t = self.tracks[ti]
            steps = t["miss"] + 1
            nxt.append(
                {"box": d[di], "vel": (d[di] - t["box"]) / steps, "miss": 0}
            )
        coasted: List[dict] = []
        for ti in un_t:
            t = self.tracks[ti]
            miss = t["miss"] + 1
            if miss > self.coast:
                continue
            nxt.append({"box": t["box"], "vel": t["vel"], "miss": miss})
            coasted.append(
                {"box": t["box"] + t["vel"] * miss, "vel": t["vel"], "miss": miss}
            )
        for di in un_d:
            nxt.append({"box": d[di], "vel": np.zeros(4), "miss": 0})
        self.tracks = nxt
        return coasted


def coast_boxes(
    coasted: List[dict],
    n_gap: int,
    frame_hw: Tuple[int, int],
    margin: float = 0.2,
    motion_slack: float = 0.5,
    appear_slack: float = 0.5,
) -> Tuple[List[List[float]], List[List[List[float]]]]:
    """Cover boxes for coasting tracks at a keyframe and across its gap.

    coasted: :meth:`KeyframeTracker.observe`'s snapshot for the keyframe
    that opens the gap. Returns ``(kf_boxes, per_gap_frame_boxes)``:
    ``kf_boxes`` protect the keyframe itself (the detector missed there,
    so the engine did not blur them), and ``per_gap_frame_boxes[j]`` adds
    to frame ``j``'s propagated set. Each box extrapolates the track's
    velocity and inflates with the total extrapolation distance ``dist``
    (missed keyframes + fractional gap position): ``margin + dist *
    appear_slack`` of box size plus ``motion_slack * dist`` of the
    per-keyframe displacement.
    """
    h, w = frame_hw
    kf_boxes: List[List[float]] = []
    per_frame: List[List[List[float]]] = [[] for _ in range(max(0, n_gap - 1))]
    for t in coasted:
        vel = np.asarray(t["vel"], np.float64)
        base = np.asarray(t["box"], np.float64)
        vstep = max(abs(float(vel[0])), abs(float(vel[1])),
                    abs(float(vel[2])), abs(float(vel[3])))
        for j in range(-1, max(0, n_gap - 1)):
            alpha = (j + 1) / n_gap
            b = base + vel * alpha
            dist = t["miss"] + alpha
            gx = (margin + dist * appear_slack) * (b[2] - b[0])
            gy = (margin + dist * appear_slack) * (b[3] - b[1])
            pad = motion_slack * dist * vstep
            bx = _inflate_clip(b, gx + pad, gy + pad, w, h)
            if bx is None:
                continue
            if j < 0:
                kf_boxes.append(bx)
            else:
                per_frame[j].append(bx)
    return kf_boxes, per_frame


def blur_host_inplace(
    frame: np.ndarray,
    boxes: List[List[float]],
    level: int = 8,
    anonymizer: str = "mosaic",
) -> None:
    """Pixelate (or blur) boxes on one frame with cv2, in place.

    frame: (H, W, 3) RGB or a C-contiguous (H*3/2, W) planar I420 view
    into the caller's buffer. On I420 the chroma planes are cut at byte
    offsets (H/2 x W/2 samples each after H x W of Y), so any even H works;
    the gaussian branch blurs U and V under the halved boxes at half the
    sigma and radius."""
    if not boxes:
        return
    if frame.ndim == 3:
        if anonymizer == "gaussian":
            gaussian_blur_host_inplace(frame, boxes)
        else:
            mosaic_host_inplace(frame, boxes, level)
        return
    if anonymizer != "gaussian":
        mosaic_i420_host_inplace(frame, boxes, level)
        return
    y, u, v = i420_host_planes(frame)
    gaussian_blur_host_inplace(y, boxes)
    cb = [[x1 / 2, y1 / 2, (x2 + 1) / 2, (y2 + 1) / 2] for x1, y1, x2, y2 in boxes]
    gaussian_blur_host_inplace(u, cb, sigma=3.0, kernel_radius=6)
    gaussian_blur_host_inplace(v, cb, sigma=3.0, kernel_radius=6)


def _frame_hw(frame: np.ndarray) -> Tuple[int, int]:
    if frame.ndim == 3:
        return frame.shape[0], frame.shape[1]
    return (frame.shape[0] * 2) // 3, frame.shape[1]


def emit_segment(
    seg: dict,
    next_det: Optional[tuple],
    pool: ThreadPoolExecutor,
    level: int = 8,
    anonymizer: str = "mosaic",
    margin: float = 0.2,
    motion_slack: float = 0.5,
    appear_slack: float = 0.5,
    iou_match: float = 0.3,
) -> Iterator[EngineResult]:
    """Emit one keyframe segment: the engine-blurred keyframe, then its
    host-covered gap frames, one EngineResult per frame in time order.

    seg: {"det": (blurred_kf_frame, face_boxes, plate_boxes),
    "coast": (coasted_faces, coasted_plates) from KeyframeTracker.observe,
    "gap": [raw frames...]}. next_det is the NEXT keyframe's detection
    tuple (None at the stream tail). Shared by TrackingEngine (pull-style,
    one stream) and CameraTracker (push-style, multicam)."""
    kf_frame, faces0, plates0 = seg["det"]
    kf_frame = np.asarray(kf_frame)
    gap = seg["gap"]
    n_gap = len(gap) + 1
    hw = _frame_hw(kf_frame)
    ckw = dict(margin=margin, motion_slack=motion_slack, appear_slack=appear_slack)
    # Coasting tracks were missed at THIS keyframe, so the engine did not
    # blur them: cover the keyframe here, and add their extrapolated boxes
    # to every gap frame.
    coast_f, coast_p = seg["coast"]
    kf_f, coast_ft = coast_boxes(coast_f, n_gap, hw, **ckw)
    kf_p, coast_pt = coast_boxes(coast_p, n_gap, hw, **ckw)
    if kf_f or kf_p:
        if not kf_frame.flags.writeable:
            kf_frame = kf_frame.copy()
        blur_host_inplace(kf_frame, kf_f + kf_p, level, anonymizer)
    yield EngineResult(
        frames=kf_frame[None],
        face_boxes=[list(faces0) + kf_f],
        plate_boxes=[list(plates0) + kf_p],
        num_faces=len(faces0) + len(kf_f),
        num_plates=len(plates0) + len(kf_p),
    )
    if not gap:
        return
    kw = dict(iou_thresh=iou_match, **ckw)
    d1f = next_det[1] if next_det is not None else None
    d1p = next_det[2] if next_det is not None else None
    faces_t = propagate_boxes(faces0, d1f, n_gap, hw, **kw)
    plates_t = propagate_boxes(plates0, d1p, n_gap, hw, **kw)
    for j in range(n_gap - 1):
        faces_t[j].extend(coast_ft[j])
        plates_t[j].extend(coast_pt[j])
    futs = [
        pool.submit(
            blur_host_inplace, frame, faces_t[j] + plates_t[j], level, anonymizer
        )
        for j, frame in enumerate(gap)
    ]
    for j, (frame, fut) in enumerate(zip(gap, futs)):
        fut.result()
        yield EngineResult(
            frames=frame[None],
            face_boxes=[faces_t[j]],
            plate_boxes=[plates_t[j]],
            num_faces=len(faces_t[j]),
            num_plates=len(plates_t[j]),
        )


class TrackingEngine:
    """Wrap an engine (fused or tiered) with detection-interval tracking.

    ``process_stream`` runs full detection on every ``interval``-th frame
    through the base engine, ``DEPTH`` keyframe batches in flight through
    ``dispatch_batch``/``finalize_batch`` (both engines have them), and
    host-blurs the gap frames under propagated boxes on ``BLUR_WORKERS``
    threads. Everything else (``process_batch``, ``process_batch_yuv``,
    ``dispatch_batch``, ``letterbox_batch``, ...) goes to the base engine
    untouched, so the image-directory and multicam paths keep per-frame
    detection.

    Memory: up to ``(DEPTH + 1) * detect_batch * interval`` raw frames wait
    while their keyframes' detections are in flight (6.2 MB a 1080p RGB
    frame, half that as I420), and the first result needs ``detect_batch *
    interval`` frames in. ``cli.main.build_engine`` sets ``detect_batch``
    to ``[SETTINGS] batch_size`` unless ``[TPU] track_detect_batch`` is
    set.
    """

    def __init__(self, base, interval: int = 4, detect_batch: int = 4, coast: int = 3):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.base = base
        self.interval = int(interval)
        self.detect_batch = max(1, int(detect_batch))
        self.coast = max(0, int(coast))

    def __getattr__(self, name):
        # Everything not defined here (process_batch, dispatch_batch,
        # process_batch_yuv, mosaic_level, device, ...) is the base
        # engine's. hasattr(self, "process_batch_yuv") is therefore the
        # base's answer, which is what the stream's I420 gate asks; and the
        # stream's device stage takes process_stream first, so tracking
        # engages only on the ordered stream path.
        if name == "base":  # not set yet (copy, unpickling): no recursion
            raise AttributeError(name)
        return getattr(self.base, name)

    def _emit_kwargs(self) -> dict:
        return dict(
            level=getattr(self.base, "mosaic_level", 8),
            anonymizer=getattr(self.base, "anonymizer", "mosaic"),
        )

    def _dispatch(self, kf_frames: List[np.ndarray]):
        # A partial batch (the stream's tail) is padded to detect_batch by
        # repeating its last keyframe, as the JAX package does: every
        # dispatch then has one shape, one mosaic kernel call covers it,
        # and the detections equal the JAX package's batch for batch.
        # Only the first len(kf_frames) results are read.
        if len(kf_frames) < self.detect_batch:
            kf_frames = kf_frames + [kf_frames[-1]] * (self.detect_batch - len(kf_frames))
        batch = np.stack(kf_frames)
        if hasattr(self.base, "dispatch_batch"):
            return ("handle", self.base.dispatch_batch(batch))
        return ("result", self.base.process_batch(batch))

    def _finalize(self, token):
        kind, payload = token
        if kind == "handle":
            return self.base.finalize_batch(payload)
        return payload

    def process_stream(
        self, batches: Iterable[np.ndarray]
    ) -> Iterator[EngineResult]:
        """Desensitize an ordered frame stream, one result per frame.

        Yields :class:`EngineResult` objects whose ``frames`` is a single
        frame ``(1, ...)`` view, in input order. Gap frames are blurred IN
        PLACE in the caller's batches. ``num_faces``/``num_plates`` count
        blurred regions (detections and coasted boxes on keyframes,
        propagated boxes on gap frames)."""
        if self.interval == 1:
            yield from self._passthrough(batches)
            return

        # One segment per keyframe, in time order: the gap frames after its
        # keyframe and, once known, the keyframe's detection. A segment is
        # emitted when the NEXT segment's detection (its d1) is known.
        segments: "deque[dict]" = deque()
        pending: "deque[Tuple[object, int]]" = deque()  # (token, n_keyframes)
        kf_buf: List[np.ndarray] = []
        pool = ThreadPoolExecutor(max_workers=BLUR_WORKERS, thread_name_prefix="vdt-track")
        face_tracks = KeyframeTracker(self.coast)
        plate_tracks = KeyframeTracker(self.coast)

        def assign(res, n):
            # A detect batch's results belong to the first n segments still
            # without a detection, in order (dispatch order == segment order).
            it = (s for s in segments if s["det"] is None)
            for i in range(n):
                seg = next(it)
                seg["det"] = (res.frames[i], res.face_boxes[i], res.plate_boxes[i])
                seg["coast"] = (
                    face_tracks.observe(res.face_boxes[i]),
                    plate_tracks.observe(res.plate_boxes[i]),
                )

        def drain_ready():
            while (
                len(segments) >= 2
                and segments[0]["det"] is not None
                and segments[1]["det"] is not None
            ):
                seg = segments.popleft()
                yield from emit_segment(seg, segments[0]["det"], pool, **self._emit_kwargs())

        try:
            idx = 0
            for batch in batches:
                for frame in batch:
                    if idx % self.interval == 0:
                        segments.append({"gap": [], "det": None})
                        kf_buf.append(frame)
                        if len(kf_buf) >= self.detect_batch:
                            pending.append((self._dispatch(kf_buf), len(kf_buf)))
                            kf_buf = []
                        while len(pending) > DEPTH:
                            token, n = pending.popleft()
                            assign(self._finalize(token), n)
                            yield from drain_ready()
                    else:
                        segments[-1]["gap"].append(frame)
                    idx += 1
            # Flush: dispatch the partial keyframe batch, finalize all in
            # flight, then emit every remaining segment (the last one with
            # d1=None: the stream's tail).
            if kf_buf:
                pending.append((self._dispatch(kf_buf), len(kf_buf)))
            while pending:
                token, n = pending.popleft()
                assign(self._finalize(token), n)
            yield from drain_ready()
            if segments:
                seg = segments.popleft()
                assert not segments and seg["det"] is not None
                yield from emit_segment(seg, None, pool, **self._emit_kwargs())
        finally:
            pool.shutdown(wait=True)

    def _passthrough(self, batches) -> Iterator[EngineResult]:
        if hasattr(self.base, "process_stream"):
            yield from self.base.process_stream(batches)
            return
        for batch in batches:
            if batch.ndim == 3 and hasattr(self.base, "process_batch_yuv"):
                yield self.base.process_batch_yuv(batch)
            else:
                yield self.base.process_batch(batch)


class CameraTracker:
    """Push-style detection-interval tracking for ONE ordered stream.

    ``TrackingEngine`` drives a single stream pull-style; the multicam
    record job instead co-batches KEYFRAMES from many cameras into shared
    device batches, and each camera owns one of these with its own
    segments and coast memory. Contract (all calls from one routing
    thread, per camera in stream order):

    - ``push_frame(frame)`` -> bool: True means a keyframe: the caller runs
      detection on it and later feeds the result to ``push_detection``;
      False means it was buffered as a gap frame.
    - ``push_detection(blurred_kf, faces, plates)``: the result of the
      camera's OLDEST outstanding keyframe (multicam dispatches FIFO).
      Returns the EngineResults that became ready, in frame order.
    - ``flush()``: after the stream ended AND every outstanding detection
      was pushed; emits the tail segment.
    """

    def __init__(
        self,
        interval: int,
        pool: ThreadPoolExecutor,
        level: int = 8,
        anonymizer: str = "mosaic",
        coast: int = 3,
    ):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.interval = int(interval)
        self.pool = pool
        self._ekw = dict(level=level, anonymizer=anonymizer)
        self.face_tracks = KeyframeTracker(coast)
        self.plate_tracks = KeyframeTracker(coast)
        self.segments: "deque[dict]" = deque()
        self.idx = 0

    def push_frame(self, frame: np.ndarray) -> bool:
        if self.idx % self.interval == 0:
            self.segments.append({"gap": [], "det": None, "coast": None})
            kf = True
        else:
            self.segments[-1]["gap"].append(frame)
            kf = False
        self.idx += 1
        return kf

    def _drain_ready(self) -> List[EngineResult]:
        out: List[EngineResult] = []
        while (
            len(self.segments) >= 2
            and self.segments[0]["det"] is not None
            and self.segments[1]["det"] is not None
        ):
            seg = self.segments.popleft()
            out.extend(emit_segment(seg, self.segments[0]["det"], self.pool, **self._ekw))
        return out

    def push_detection(
        self, blurred_kf: np.ndarray, faces: list, plates: list
    ) -> List[EngineResult]:
        seg = next(s for s in self.segments if s["det"] is None)
        seg["det"] = (blurred_kf, faces, plates)
        seg["coast"] = (
            self.face_tracks.observe(faces),
            self.plate_tracks.observe(plates),
        )
        return self._drain_ready()

    def flush(self) -> List[EngineResult]:
        out = self._drain_ready()
        if self.segments:
            seg = self.segments.popleft()
            if seg["det"] is None or self.segments:
                raise RuntimeError(
                    "flush() with outstanding keyframe detections pending"
                )
            out.extend(emit_segment(seg, None, self.pool, **self._ekw))
        return out
