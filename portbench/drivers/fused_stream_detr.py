"""The stream job's device stage on the fused engine with RT-DETR-R50 in
the plate slot.

Timed entry: ``pipeline/streaming.py::_run_device_stage`` on the engine
``cli/main.py::build_engine`` makes from the configuration (``engine =
fused``, ``plate_arch = rtdetr-r50vd``): the face reads the shared
letterbox canvas, RT-DETR the frames it stretches, and its whole program
replays one CUDA graph a batch (no NMS, no host read). Stage, feeder,
drain, held batches, recorder and timer are the fused cell's
(``fused_stream.py``).

Compared once the window has closed under ``fused_stream.py::judge``'s
number names: face boxes as there; plate boxes by query. Each kept plate's
query is known by the memory token it was selected at (the detector's
program run once more on each pool batch, eagerly, with its tokens: the
graph replays it bitwise). Where the reference
(``reference/rtdetr.py::detect_plates``) selected the same token, the
plate is judged against that query's final box and best class logit
(``kth`` the logit the ``plate_max_detections``-th best query that
reaches the threshold has, or the threshold's); ``set_gap`` counts the
kept plates of either side whose token the other side did not keep, so a
token that bf16 and float32 select on either side of the query boundary
falls there, not into a score gap. The held frames are held against the
reference mosaic of the frame with the engine's own boxes.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import seeding, stream_window, traffic, weights
from portbench.arith import detr_flops, msda_bytes
from portbench.arith import flops as arith_flops
from portbench.common import subseed
from portbench.drivers import fused_stream as fs
from portbench.reference import detect, nets, rtdetr
from portbench.trace import Spans


def _reference_nets(cfg: Dict, device="meta"):
    face = nets.RetinaFace(cfg["in_channel"], cfg["out_channel"]).to(device)
    plate = rtdetr.RTDETR(cfg["nc"], hidden=cfg["hidden_dim"], heads=cfg["nhead"],
                          ffn=cfg["dim_feedforward"], queries=cfg["num_queries"],
                          dec_layers=cfg["num_decoder_layers"]).to(device)
    return face, plate


def box_refinements(plate) -> List[str]:
    """The last layer of each of RT-DETR's box heads. lyuwenyu starts them
    at zero, so that boxes start at the anchors and each decoder layer
    refines them; calibrated to unit std like the rest, each layer would
    move a box by a logit and most boxes would flatten to a line at the
    frame's edge, so they are calibrated to ``box_refinement_std``."""
    heads = [plate.decoder.enc_bbox_head, *plate.decoder.dec_bbox_head]
    names = {m: n for n, m in plate.named_modules()}
    return [names[h.layers[-1]] for h in heads]


def _seeded(cfg: Dict, device, dtype):
    """The configuration's face and plate weights in ``dtype``, drawn from
    its ``weights_seed`` and calibrated on ``calibration_frames`` frames of
    that seed's traffic: the face exactly as the YOLOv8n cell's
    (``weights.py``), RT-DETR with its linear layers and layer norms
    (``seeding.py``) on the stretched frames."""
    seed = cfg["weights_seed"]
    face, plate = _reference_nets(cfg, device)
    pool = traffic.frame_pool(dict(cfg["calibration_traffic"], pool_batches=1,
                                   batch=cfg["calibration_frames"]),
                              subseed(seed, "frames"), device)
    frames = torch.from_numpy(pool[0]).to(device)
    hw = (cfg["input_size"], cfg["input_size"])
    face_sd = weights.seeded_state_dict(face, subseed(seed, "face"), device, torch.float32)
    plate_sd = seeding.seeded_state_dict(plate, subseed(seed, "plate"), device, torch.float32)
    with weights.no_tf32():
        weights.calibrate_(face, face_sd, detect.letterbox(frames, hw, 128.0)
                           - torch.tensor(detect.FACE_MEAN, device=device).view(1, 3, 1, 1))
        seeding.calibrate_(plate, plate_sd, rtdetr.stretch(frames, cfg["input_size"]),
                           {n: cfg["box_refinement_std"] for n in box_refinements(plate)})
    return [{k: v.to(dtype) if v.is_floating_point() and not k.endswith(
        ("running_mean", "running_var")) else v for k, v in sd.items()}
        for sd in (face_sd, plate_sd)]


def reference_detections(cfg, seeded, pool, device, qdtype=None, locations=None):
    """Each pool batch's (face, plate) reference detections in float32, not
    TF32 (``qdtype``: 8-bit float convolutions and linear layers, the
    control). ``locations``: a list that gets each batch's decoder
    layers' sampling locations."""
    face, plate = _reference_nets(cfg, device)
    for net, sd in zip((face, plate), seeded):
        net.load_state_dict({k: v.float() if v.is_floating_point() else v for k, v in sd.items()})
    face = nets.set_qdtype(face.eval(), qdtype)
    plate = rtdetr.set_qdtype(plate.eval(), qdtype)
    out = []
    with weights.no_tf32():
        for batch in pool:
            frames = torch.from_numpy(batch).to(device)
            record: List[torch.Tensor] = []
            rtdetr.record_locations(plate, record if locations is not None else None)
            out.append((detect.detect_faces(face, frames, cfg),
                        rtdetr.detect_plates(plate, frames, cfg)))
            if locations is not None:
                locations.append(record)
    return out


def port_tokens(detector, pool, boxes, device) -> Tuple[List, float]:
    """The memory token of each kept plate of each batch of ``boxes``: the
    detector's program run once more on each pool batch, eagerly, each
    recorded plate box taken as the row nearest it. Returns the tokens (by
    batch, by frame) and the widest pixel gap between a recorded box and
    its row (0 where the window's replays and this run agree bitwise)."""
    rows = []
    with torch.inference_mode():
        for batch in pool:
            r, keep, tok = detector._segment(torch.from_numpy(batch).to(device), tokens=True)
            rows.append([(r[i][keep[i]][:, :4].double().cpu().numpy(),
                          tok[i][keep[i]].cpu().numpy()) for i in range(len(batch))])
    widest, seen, out = 0.0, {}, []
    for j, (_, pb) in enumerate(boxes):
        frames = []
        for i, plates in enumerate(pb):
            ours = np.asarray(plates, np.float64).reshape(-1, 4)
            key = (j % len(pool), i, ours.tobytes())
            if key not in seen:
                theirs, tok = rows[j % len(pool)][i]
                if len(ours) and not len(theirs):
                    raise RuntimeError("a kept plate that the detector's rerun does not keep")
                gap = np.abs(ours[:, None] - theirs[None]).max(-1) if len(ours) else np.zeros((0, 1))
                seen[key] = tok[gap.argmin(1)] if len(ours) else tok[:0]
                widest = max(widest, float(gap.min(1).max()) if len(ours) else 0.0)
            frames.append(seen[key])
        out.append(frames)
    return out, widest


def judge_plates(ours: np.ndarray, tokens: np.ndarray, ref: Dict):
    """One frame's kept plates (K, 4) and their tokens against the
    reference's detections of the frame, by query -> (box gaps over the
    reference box's longer side, shortfalls of the reference logit below
    ``kth``, each for the plates whose token the reference selected;
    plates of either side whose token the other side did not keep; kept
    plates of both sides; plates whose token the reference did not
    select)."""
    where = {int(t): q for q, t in enumerate(ref["tokens"])}
    q = np.array([where.get(int(t), -1) for t in tokens], np.int64)
    sel = q >= 0
    theirs = ref["boxes"][torch.as_tensor(q[sel], device=ref["boxes"].device)].cpu().numpy()
    longer = np.maximum(np.maximum(theirs[:, 2] - theirs[:, 0], theirs[:, 3] - theirs[:, 1]), 1.0)
    gaps = np.abs(ours[sel] - theirs).max(-1) / longer if len(theirs) else np.zeros(0)
    shorts = np.maximum(ref["kth"] - np.asarray(ref["margin"])[q[sel]], 0.0)
    mine, kept = {int(t) for t in tokens}, {int(t) for t in ref["kept_tokens"]}
    return (gaps, shorts, len(mine - kept) + len(kept - mine), len(tokens) + len(kept),
            int((~sel).sum()))


def judged(cfg, boxes, tokens, ref, pool, held, device) -> Dict:
    """The compared numbers of a window under ``fused_stream.judge``'s
    names: ``boxes`` each batch's (face lists, plate lists), ``tokens`` the
    plates' tokens (``port_tokens``), ``ref`` each pool batch's reference
    detections, ``held`` blurred frames by batch index. Faces are judged
    as ``judge`` judges them (``set_gap`` at ``nms_iou``), plates by query
    (``judge_plates``); a frame that repeats (the pool cycles) is judged
    once and counted each time."""
    gaps: List[np.ndarray] = []
    shortfalls: List[np.ndarray] = []
    count_diff = count_ref = unmatched = n_boxes = swaps = plates = 0
    worst = (-1.0, None)
    seen: Dict = {}
    for j, (fb, pb) in enumerate(boxes):
        rf, rp = ref[j % len(pool)]
        for i in range(len(fb)):
            faces = np.asarray(fb[i], np.float64).reshape(-1, 4)
            ours = np.asarray(pb[i], np.float64).reshape(-1, 4)
            key = (j % len(pool), i, faces.tobytes(), ours.tobytes())
            if key not in seen:
                f_gap, f_short = detect.judge_boxes(faces, rf[i])
                p_gap, p_short, p_un, p_n, p_swap = judge_plates(ours, tokens[j][i], rp[i])
                kept_f, kept_p = len(rf[i]["kept"]), len(rp[i]["kept"])
                seen[key] = (np.concatenate([f_gap, p_gap]), f_short, p_short,
                             abs(len(faces) - kept_f) + abs(len(ours) - kept_p), kept_f + kept_p,
                             detect.set_gap(faces, rf[i]["kept"][:, :4], cfg["nms_iou"]) + p_un,
                             len(faces) + kept_f + p_n, p_swap)
            gap, f_short, p_short, diff, n_ref, n_un, n_both, n_swap = seen[key]
            if len(f_short) and f_short.max() > worst[0]:
                worst = (float(f_short.max()), ("f", faces, rf[i], None))
            if len(p_short) and p_short.max() > worst[0]:
                worst = (float(p_short.max()), ("p", ours, rp[i], tokens[j][i]))
            gaps.append(gap)
            shortfalls += [f_short, p_short]
            count_diff += diff
            count_ref += n_ref
            unmatched += n_un
            n_boxes += n_both
            swaps += n_swap
            plates += len(ours)
    mosaic_px = 0
    for j, frames in held.items():
        fb, pb = boxes[j]
        src = pool[j % len(pool)]
        for i in range(len(frames)):
            want = detect.mosaic_(torch.tensor(src[i], device=device),
                                  fs._frame_boxes(fb[i], pb[i]), cfg["mosaic_level"])
            got = torch.as_tensor(np.asarray(frames[i])).to(device)
            mosaic_px += int((want != got).any(-1).sum())
    inf = float("inf")
    gap = np.concatenate(gaps) if gaps else np.zeros(0)
    short = np.concatenate(shortfalls) if shortfalls else np.zeros(0)
    return {"box_err": float(np.median(gap)) if len(gap) else inf,
            "box_err_mean": float(gap.mean()) if len(gap) else inf,
            "score_gap": float(np.quantile(short, 0.99)) if len(short) else inf,
            "score_gap_widest": float(short.max()) if len(short) else inf,
            "count_gap": count_diff / count_ref if count_ref else inf,
            "set_gap": unmatched / n_boxes if n_boxes else inf,
            "plate_swaps": swaps / plates if plates else 0.0,
            "mosaic_px": mosaic_px if held else inf,  # nothing held, nothing judged
            "_worst": _describe(*worst[1]) if worst[1] else None}


def _describe(side, ours, ref, tokens) -> Dict:
    """For the record of a run: the box that falls furthest below the
    reference's selection."""
    if side == "f":
        return dict(side=side, **detect.describe_worst(ours, ref))
    _, shorts, *_ = judge_plates(ours, tokens, ref)
    where = {int(t): q for q, t in enumerate(ref["tokens"])}
    sel = [k for k, t in enumerate(tokens) if int(t) in where]
    k = sel[int(np.argmax(shorts))]
    q = where[int(tokens[k])]
    return {"side": side, "token": int(tokens[k]), "query": q, "shortfall": float(shorts.max()),
            "kth": ref["kth"], "margin": float(ref["margin"][q]),
            "box": [round(float(v), 2) for v in ours[k]],
            "reference box": [round(float(v), 2) for v in ref["boxes"][q].tolist()]}


def run(ctx) -> Dict:
    cfg, tp, dev = ctx.config, ctx.traffic, ctx.device
    served = fs.DTYPES[cfg["dtype"]]
    from video_desensitization_torch.api.config import PipelineConfig

    # first: a program without the plate slot's choice fails here, at once
    pcfg = PipelineConfig(
        engine=cfg["engine"], plate_arch=cfg["plate_arch"], model_path="random",
        model_weights="random", batch_size=tp["batch"], dtype=cfg["dtype"],
        input_size=cfg["input_size"], max_detections=cfg["max_detections"],
        confidence=cfg["confidence"], nms_iou=cfg["nms_iou"],
        plate_confidence=cfg["plate_confidence"], mosaic_level=cfg["mosaic_level"],
        transfer=cfg["transfer"])
    smi = fs.power_limit(dev)

    pool = traffic.frame_pool(tp, subseed(ctx.seed, "frames"), dev)
    face_sd, plate_sd = _seeded(cfg, dev, served)
    seeded = [{k: v.cpu() for k, v in sd.items()} for sd in (face_sd, plate_sd)]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    from video_desensitization_torch.cli.main import build_engine
    from video_desensitization_torch.ops import cuda_mosaic, cuda_msda

    engine = build_engine(pcfg, with_plates=True, allow_random=True, device=dev)
    plate_net = engine.plate.net
    if (engine.plate.max_detections, plate_net.decoder.num_queries,
            len(plate_net.decoder.decoder.layers)) != (
            cfg["plate_max_detections"], cfg["num_queries"], cfg["num_decoder_layers"]):
        raise RuntimeError("the engine's plate settings differ from the configuration's")
    engine.face.net.load_state_dict(face_sd)
    plate_net.load_state_dict(plate_sd)
    del face_sd, plate_sd
    rec = fs._Recorder(engine)

    # ---- warm-up: every pool batch through the stage once
    fs._stage(rec, pool, tp["queue_depth"], fs._timer(Spans()), n_batches=len(pool))
    syncs = fs._host_syncs(engine, pool[0])
    launches0 = cuda_mosaic.mosaic_boxes_batch_cuda_.launches
    msda0 = cuda_msda.msda_cuda.launches
    rec.boxes.clear()

    # ---- the window
    w = stream_window.measure(ctx, rec, pool)
    launches = cuda_mosaic.mosaic_boxes_batch_cuda_.launches - launches0
    msda_calls = cuda_msda.msda_cuda.launches - msda0
    n = max(w.n_total, 1)
    frames_seen = n * tp["batch"]
    plates = sum(len(p) for _, pb in rec.boxes for p in pb)
    faces = sum(len(f) for fb, _ in rec.boxes for f in fb)
    stages = {k: round(w.timer.totals[k] / w.timer.counts[k] * 1e3, 3) for k in w.timer.totals}
    ctx.note(f"stage ms a call {stages} | {stream_window.host_note(w)}")
    ctx.note(f"{smi} | batches in the window {w.batches_window} of {len(w.put_t)} fed, "
             f"{w.n_total} through the stage | mosaic launches a batch {launches / n:.4f} | msda "
             f"wrapper calls a batch {msda_calls / n:.4f} (graph replays call no wrapper) | boxes "
             f"a frame: faces {faces / frames_seen:.3f}, plates {plates / frames_seen:.3f} | host "
             f"syncs a batch {syncs} | peak memory {w.memory_peak} bytes")
    boxes = list(rec.boxes)
    tokens, rerun_gap = port_tokens(engine.plate, pool, boxes, dev)
    del engine, rec, plate_net
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    locations: List = []
    ref = reference_detections(cfg, seeded, pool, dev, locations=locations if ctx.trace else None)
    obs, traced = w.obs, w.traced
    if ctx.trace:
        face_m, plate_m = _reference_nets(cfg)
        shape = (1, 3, cfg["input_size"], cfg["input_size"])
        obs["detr_flops_per_frame"] = (arith_flops.forward_flops(face_m, shape)
                                       + detr_flops.forward_flops(plate_m, shape))
        obs["mosaic_bytes"] = fs._mosaic_bytes([boxes[j] for j in traced], tp,
                                               cfg["mosaic_level"], dev)
        shapes = [(cfg["input_size"] // s,) * 2 for s in cfg["feat_strides"]]
        elem = torch.finfo(served).bits // 8
        head_dim = cfg["hidden_dim"] // cfg["nhead"]
        per_batch = [sum(msda_bytes.call_bytes(loc, shapes, head_dim, elem) for loc in layers)
                     for layers in locations]
        obs["msda_bytes"] = sum(per_batch[j % len(pool)] for j in traced)
        ctx.note(f"reference FLOPs a frame {obs['detr_flops_per_frame']:.6e} | mosaic least bytes "
                 f"{obs['mosaic_bytes']} | msda least bytes a pool batch {per_batch} | over the "
                 f"{len(traced)} batches of the traced {obs['window_s']:.6f} s")
    every = judged(cfg, boxes, tokens, ref, pool, w.held, dev)
    worst = every.pop("_worst")
    ctx.note(f"reference and comparison {time.perf_counter() - t0:.2f} s over {len(boxes)} "
             f"batches, {len(w.held)} held | plates' rows rerun for their tokens, widest gap "
             f"{rerun_gap} px | every number {every} | the box furthest below the reference's "
             f"selection: {worst}")
    return {
        "e2e": {"frames_per_s": w.frames_per_s, "setup_s": w.setup_s},
        "attempted": len(w.put_t),
        "failed": len(w.put_t) - w.n_total,
        "memory_peak_bytes": w.memory_peak,
        "numbers": {k: every[k] for k in ctx.workload["limits"]},
        "obs": obs,
    }
