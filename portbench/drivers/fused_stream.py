"""The stream job's device stage on the fused engine.

Timed entry: ``pipeline/streaming.py::_run_device_stage`` on the engine
``cli/main.py::build_engine`` makes from the configuration (``engine =
fused``), two batches in flight through ``dispatch_batch`` /
``finalize_batch``. A feeder thread fills the stage's input queue as the
stream job's decoder does (``queue_depth`` batches deep), cycling a pool of
distinct batches made from the seed; a drain thread takes the blurred
frames from the output queue as its encoder does and lets each batch go;
of a sample of batches drawn from the seed it first copies the frames
into host memory made at set-up, for the comparison. The codec is left
out: on the card's machine it is cv2's host codec, not the port.

Compared once the window has closed, on every batch that came back, the
kept boxes against the reference's detections of the same frames, each
kept box as the reference's box of the prior nearest to it: ``box_err``,
the median over kept boxes of that widest coordinate gap over the
reference box's longer side; ``score_gap``, the 99th percentile over kept
boxes of how far, in logits, such a prior's reference margin lies below
the margin of the reference's ``max_detections``-th best candidate (a box
the reference would not have ranked among the kept); ``set_gap``, the
share of boxes of either side that no box of the other side overlaps by
more than the detector's NMS threshold (a box missed, or one kept that
the reference has nowhere). On the held batches, the blurred frames
against the reference mosaic of the frame with the engine's own boxes
(``mosaic_px``: pixels that differ). The record of a run also has the
mean gap, the widest shortfall and the gap in box counts.
"""

from __future__ import annotations

import contextlib
import queue
import subprocess
import threading
import time
import warnings
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from portbench import host, traffic, weights
from portbench.arith import flops as arith_flops
from portbench.arith import mosaic_bytes
from portbench.common import subseed
from portbench.reference import detect, nets
from portbench.trace import TRACE_SECONDS, Spans

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
JOIN_S = 120.0
# A traced run's trace opens this long into the window, once the two
# batches in flight and the queue behind them have filled.
TRACE_SETTLE_S = 2.0


def _reference_nets(cfg: Dict, device="meta"):
    face = nets.RetinaFace(cfg["in_channel"], cfg["out_channel"]).to(device)
    plate = nets.YOLOv8(cfg["nc"], cfg["depth_multiple"], cfg["width_multiple"],
                        cfg["max_channels"]).to(device)
    return face, plate


def _seeded(cfg: Dict, device, dtype):
    """The configuration's face and plate weights in ``dtype``: drawn from
    its ``weights_seed`` (one model, as a deployment serves one, whatever
    frames the run's seed draws) and calibrated on ``calibration_frames``
    frames of the same seed's traffic (``weights.calibrate_``)."""
    seed = cfg["weights_seed"]
    face, plate = _reference_nets(cfg, device)
    pool = traffic.frame_pool(dict(cfg["calibration_traffic"], pool_batches=1,
                                   batch=cfg["calibration_frames"]), subseed(seed, "frames"), device)
    frames = torch.from_numpy(pool[0]).to(device)
    hw = (cfg["input_size"], cfg["input_size"])
    out = []
    for net, name, x in (
            (face, "face", detect.letterbox(frames, hw, 128.0)
             - torch.tensor(detect.FACE_MEAN, device=device).view(1, 3, 1, 1)),
            (plate, "plate", detect.letterbox(frames, hw, 114.0) / 255.0)):
        sd = weights.seeded_state_dict(net, subseed(seed, name), device, torch.float32)
        with weights.no_tf32():
            weights.calibrate_(net, sd, x)
        out.append({k: v.to(dtype) if v.is_floating_point() and not k.endswith(
            ("running_mean", "running_var")) else v for k, v in sd.items()})
    return out


def power_limit(device) -> str:
    if device.type != "cuda":
        return "no card"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


class _Recorder:
    """The engine as the stage sees it, keeping each finalized batch's
    kept boxes (the lists the engine's result already holds)."""

    def __init__(self, engine):
        self.engine = engine
        self.boxes: List = []

    def dispatch_batch(self, frames, image_shapes=None):
        return self.engine.dispatch_batch(frames, image_shapes)

    def finalize_batch(self, handle):
        res = self.engine.finalize_batch(handle)
        self.boxes.append((res.face_boxes, res.plate_boxes))
        return res


def _timer(spans):
    from video_desensitization_torch.utils.timers import StageTimer

    class RecordingTimer(StageTimer):
        """The port's stage timer, also keeping each span for the trace."""

        hook = None  # called before each span opens, in the stage's own thread

        @contextlib.contextmanager
        def stage(self, name):
            if self.hook is not None:
                self.hook()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                self.totals[name] += t1 - t0
                self.counts[name] += 1
                spans.add(name, t0, t1)

    return RecordingTimer()


def _stage(rec, pool, depth, timer, n_batches=None, seconds=None, hold=None, trace=None):
    """One call of the stage over a feeder and a drain thread. ``hold``
    maps batch indices to host arrays made at set-up: the drain copies
    those batches' frames into them and lets every pinned buffer go, as an
    encoder does (holding one would make the engine pin a fresh one).
    ``trace``, a ``DeviceTrace``, is started before the stream (started
    during it, the profiler stalls the stage for seconds), opened once the
    stream has run ``TRACE_SETTLE_S`` and stopped ``TRACE_SECONDS`` later,
    each time by the stage itself between two of its spans
    (``timer.hook``): it sees the stream as it runs. Returns (t_start, put
    times, take times, held frames by batch index)."""
    from video_desensitization_torch.pipeline.streaming import (
        _SENTINEL,
        StreamStats,
        _run_device_stage,
    )

    in_q: "queue.Queue" = queue.Queue(maxsize=depth)
    out_q: "queue.Queue" = queue.Queue(maxsize=depth)
    put_t: List[float] = []
    take_t: List[float] = []
    held: Dict[int, np.ndarray] = {}
    errors: List[BaseException] = []
    stop = threading.Event()
    if trace is not None:
        trace.start()
    t_start = time.perf_counter()
    deadline = None if seconds is None else t_start + seconds
    if trace is not None:
        open_at = t_start + min(TRACE_SETTLE_S, seconds / 4)
        close_at = min(open_at + TRACE_SECONDS, deadline)

        def hook():
            now = time.perf_counter()
            if now >= close_at:
                trace.stop()
            elif now >= open_at:
                trace.open()

        timer.hook = hook

    def feed():
        try:
            j = 0
            while (n_batches is None or j < n_batches) and not stop.is_set():
                if deadline is not None and time.perf_counter() >= deadline:
                    break
                in_q.put(pool[j % len(pool)])
                put_t.append(time.perf_counter())
                j += 1
        except BaseException as e:  # noqa: BLE001 - raised again by the caller
            errors.append(e)
        finally:
            in_q.put(_SENTINEL)

    def drain():
        while True:
            item = out_q.get()
            if item is _SENTINEL:
                return
            take_t.append(time.perf_counter())
            j = len(take_t) - 1
            if hold and j in hold:
                np.copyto(hold[j], item)
                held[j] = hold[j]

    threads = [threading.Thread(target=feed, daemon=True), threading.Thread(target=drain, daemon=True)]
    for t in threads:
        t.start()
    ok = False
    try:
        _run_device_stage(rec, in_q, out_q, StreamStats(), timer)
        ok = True
    finally:
        timer.hook = None
        if trace is not None:
            trace.stop()
        out_q.put(_SENTINEL)
        if not ok:
            stop.set()
            with contextlib.suppress(queue.Empty):
                while in_q.get(timeout=10.0) is not _SENTINEL:
                    pass
        for t in threads:
            t.join(JOIN_S)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("the feeder or drain thread did not end")
    if errors:
        raise errors[0]
    return t_start, put_t, take_t, held


def _host_syncs(engine, frames) -> int:
    """Synchronising calls the CUDA sync debug mode reports in one batch."""
    if not torch.cuda.is_available():
        return 0
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            engine.finalize_batch(engine.dispatch_batch(frames))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def run(ctx) -> Dict:
    cfg, tp, dev = ctx.config, ctx.traffic, ctx.device
    served = DTYPES[cfg["dtype"]]
    smi = power_limit(dev)  # before any profiler session: a child process disturbs its counts

    # ---- inputs and weights, made from the seed on the device
    pool = traffic.frame_pool(tp, subseed(ctx.seed, "frames"), dev)
    face_sd, plate_sd = _seeded(cfg, dev, served)
    seeded = [{k: v.cpu() for k, v in sd.items()} for sd in (face_sd, plate_sd)]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the program, as the configuration states it
    from video_desensitization_torch.api.config import PipelineConfig
    from video_desensitization_torch.cli.main import build_engine
    from video_desensitization_torch.ops import cuda_mosaic

    pcfg = PipelineConfig(
        engine="fused", model_path="random", model_weights="random",
        batch_size=tp["batch"], dtype=cfg["dtype"], input_size=cfg["input_size"],
        max_detections=cfg["max_detections"], confidence=cfg["confidence"],
        nms_iou=cfg["nms_iou"], plate_confidence=cfg["plate_confidence"],
        mosaic_level=cfg["mosaic_level"], transfer=cfg["transfer"])
    engine = build_engine(pcfg, with_plates=True, allow_random=True, device=dev)
    if (engine.plate.nms_iou, engine.plate.max_detections) != (
            cfg["plate_nms_iou"], cfg["plate_max_detections"]):
        raise RuntimeError("the engine's plate settings differ from the configuration's")
    engine.face.net.load_state_dict(face_sd)
    engine.plate.net.load_state_dict(plate_sd)
    del face_sd, plate_sd
    rec = _Recorder(engine)
    depth = tp["queue_depth"]

    # ---- warm-up: every pool batch through the stage once
    _stage(rec, pool, depth, _timer(Spans()), n_batches=len(pool))
    syncs = _host_syncs(engine, pool[0])
    launches0 = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    rec.boxes.clear()

    # ---- the window
    rng = np.random.default_rng(subseed(ctx.seed, "held"))
    hold = {int(j): np.ones_like(pool[0]) for j in
            rng.choice(tp["held_min_batches"], tp["held_batches"], replace=False)}
    timer = _timer(ctx.spans)
    copy_probe = np.empty_like(pool[0])
    copy_before = host.copy_gbps(copy_probe, pool[0])
    host0 = host.snapshot()
    t_start, put_t, take_t, held = _stage(rec, pool, depth, timer, seconds=ctx.seconds, hold=hold,
                                          trace=ctx.device_trace if ctx.trace else None)
    host_window = host.delta(host0, host.snapshot())
    t_end = t_start + ctx.seconds
    setup_s = t_start - ctx.t_process
    memory_peak = ctx.memory_peak_bytes()
    launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches - launches0
    batches_window = sum(1 for t in take_t if t <= t_end)
    frames_per_s = tp["batch"] * batches_window / ctx.seconds
    n_total = len(take_t)
    boxes_total = sum(len(f) + len(p) for fb, pb in rec.boxes for f, p in zip(fb, pb))
    stages = {k: round(timer.totals[k] / timer.counts[k] * 1e3, 3) for k in timer.totals}
    ctx.note(f"stage ms a call {stages} | median ms between two batches taken "
             f"{float(np.median(np.diff(take_t))) * 1e3:.3f}")
    ctx.note(f"host over the window {host_window} | host copy GB/s before {copy_before:.3f}, after "
             f"{host.copy_gbps(copy_probe, pool[0]):.3f} | process CPU ms a batch in the window "
             f"{host_window['cpu_s'] / max(batches_window, 1) * 1e3:.3f}")
    ctx.note(f"{smi} | batches in the window {batches_window} of {len(put_t)} fed, "
             f"{n_total} through the stage | mosaic launches a batch {launches / max(n_total, 1):.4f} | "
             f"boxes a frame {boxes_total / max(n_total * tp['batch'], 1):.3f} | host syncs a batch "
             f"{syncs} | peak memory {memory_peak} bytes")
    boxes = list(rec.boxes)
    del engine, rec, copy_probe
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # per-layer readings over the traced seconds (without a trace, the window)
    dt = ctx.device_trace
    t_a, t_b = (dt.t_open, dt.t_end) if dt.t_end > dt.t_open > 0 else (t_start, t_end)
    traced = [j for j, t in enumerate(take_t) if t_a <= t <= t_b]
    totals: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for name, s0, s1 in ctx.spans.items:
        if t_a <= s0 < t_b:
            totals[name] += s1 - s0
            counts[name] += 1
    obs = {
        "batches": len(traced),
        "frames_window": tp["batch"] * len(traced),
        "window_s": t_b - t_a,
        "latencies_s": [take_t[j] - put_t[j] for j in traced],
        "timer_totals": dict(totals),
        "timer_counts": dict(counts),
    }
    if ctx.trace:
        face_m, plate_m = _reference_nets(cfg)
        shape = (1, 3, cfg["input_size"], cfg["input_size"])
        obs["flops_per_frame"] = (arith_flops.forward_flops(face_m, shape)
                                  + arith_flops.forward_flops(plate_m, shape))
        obs["mosaic_bytes"] = _mosaic_bytes([boxes[j] for j in traced], tp, cfg["mosaic_level"], dev)
        ctx.note(f"reference FLOPs a frame {obs['flops_per_frame']:.6e} | mosaic least bytes "
                 f"{obs['mosaic_bytes']} over the {len(traced)} batches of the traced "
                 f"{t_b - t_a:.6f} s")

    numbers = _compare(ctx, pool, seeded, boxes, held)
    return {
        "e2e": {"frames_per_s": frames_per_s, "setup_s": setup_s},
        "attempted": len(put_t),
        "failed": len(put_t) - n_total,
        "memory_peak_bytes": memory_peak,
        "numbers": numbers,
        "obs": obs,
    }


def _frame_boxes(face, plate) -> np.ndarray:
    return np.asarray(list(face) + list(plate), np.float64).reshape(-1, 4)


def _mosaic_bytes(boxes, tp, level, device) -> int:
    """Least bytes of every batch's mosaic; frames with the same boxes
    (the pool repeats) are counted once and reused."""
    cache: Dict = {}
    total = 0
    for fb, pb in boxes:
        for f, p in zip(fb, pb):
            key = np.trunc(_frame_boxes(f, p)).astype(np.int64).tobytes()
            if key not in cache:
                cache[key] = mosaic_bytes.frame_bytes(tp["height"], tp["width"], 3,
                                                      _frame_boxes(f, p), level, device)
            total += cache[key]
    return total


@torch.no_grad()
def _compare(ctx, pool, seeded, boxes, held) -> Dict[str, float]:
    cfg, dev = ctx.config, ctx.device
    t0 = time.perf_counter()
    ref = reference_detections(cfg, seeded, pool, dev, qdtype=None)
    every = judge(boxes, ref, pool, held, cfg["mosaic_level"], dev, cfg)
    worst = every.pop("_worst")
    ctx.note(f"reference and comparison {time.perf_counter() - t0:.2f} s over {len(boxes)} "
             f"batches, {len(held)} held | every number {every} | the box furthest below the "
             f"reference's selection: {worst}")
    return {k: every[k] for k in ctx.workload["limits"]}


def reference_detections(cfg, seeded, pool, device, qdtype=None):
    """The reference's detections of every pool frame (``detect``), from
    the seed's weights as served (``seeded``: the face's and the plate's
    state), computed in float32, not TF32 (``qdtype``: 8-bit float
    convolutions, the control)."""
    face, plate = _reference_nets(cfg, device)
    for net, sd in zip((face, plate), seeded):
        net.load_state_dict({k: v.float() if v.is_floating_point() else v for k, v in sd.items()})
    face, plate = nets.set_qdtype(face.eval(), qdtype), nets.set_qdtype(plate.eval(), qdtype)
    out = []
    with weights.no_tf32():
        for batch in pool:
            frames = torch.from_numpy(batch).to(device)
            out.append((detect.detect_faces(face, frames, cfg), detect.detect_plates(plate, frames, cfg)))
    return out


def judge(boxes, ref, pool, held, level, device, cfg) -> Dict[str, float]:
    """The compared numbers of a window: ``boxes`` each batch's (face
    lists, plate lists) in order, ``ref`` each pool batch's reference
    detections, ``held`` blurred frames by batch index. A frame's boxes
    that repeat (the pool cycles) are judged once and counted each time."""
    gaps: List[np.ndarray] = []
    shortfalls: List[np.ndarray] = []
    count_diff = count_ref = unmatched = n_boxes = 0
    worst = (-1.0, None)
    seen: Dict = {}
    for j, (fb, pb) in enumerate(boxes):
        rf, rp = ref[j % len(pool)]
        for i in range(len(fb)):
            for side, ours, theirs, iou in (("f", fb[i], rf[i], cfg["nms_iou"]),
                                            ("p", pb[i], rp[i], cfg["plate_nms_iou"])):
                ours = np.asarray(ours, np.float64).reshape(-1, 4)
                key = (j % len(pool), i, side, ours.tobytes())
                if key not in seen:
                    kept = theirs["kept"][:, :4]
                    seen[key] = (*detect.judge_boxes(ours, theirs), abs(len(ours) - len(kept)),
                                 len(kept), detect.set_gap(ours, kept, iou), len(ours) + len(kept))
                gap, short, diff, n_ref, n_un, n_both = seen[key]
                if len(short) and short.max() > worst[0]:
                    worst = (float(short.max()), (side, ours, theirs))
                gaps.append(gap)
                shortfalls.append(short)
                count_diff += diff
                count_ref += n_ref
                unmatched += n_un
                n_boxes += n_both
    mosaic_px = 0
    for j, frames in held.items():
        fb, pb = boxes[j]
        src = pool[j % len(pool)]
        for i in range(len(frames)):
            want = detect.mosaic_(torch.tensor(src[i], device=device), _frame_boxes(fb[i], pb[i]), level)
            got = torch.as_tensor(np.asarray(frames[i])).to(device)
            mosaic_px += int((want != got).any(-1).sum())
    if not held:
        mosaic_px = float("inf")  # nothing held, nothing judged: never correct
    inf = float("inf")
    gap = np.concatenate(gaps) if gaps else np.zeros(0)
    short = np.concatenate(shortfalls) if shortfalls else np.zeros(0)
    return {"box_err": float(np.median(gap)) if len(gap) else inf,
            "box_err_mean": float(gap.mean()) if len(gap) else inf,
            "score_gap": float(np.quantile(short, 0.99)) if len(short) else inf,
            "score_gap_widest": float(short.max()) if len(short) else inf,
            "count_gap": count_diff / count_ref if count_ref else inf,
            "set_gap": unmatched / n_boxes if n_boxes else inf,
            "mosaic_px": mosaic_px,
            "_worst": None if worst[1] is None else
            dict(side=worst[1][0], **detect.describe_worst(worst[1][1], worst[1][2]))}
