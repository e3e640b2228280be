"""The trainer's step.

Timed entry: the step of ``train/step.py::make_train_step`` with the
optimizer of ``cli/train.py::build_optimizer``, both from the trainer's
own argument parser at the configuration's values, on ``RetinaFace`` in
train mode. The batches come from the port's data path
(``train/data.py::batch_iterator``) over labelled JPEGs the traffic
generator makes from the seed under ``TMPDIR``: made at set-up, held on
the host as the iterator yields them, and cycled; each step copies its
batch to the card. Every ``log_every`` steps the loop reads the loss, as
the trainer's loop does to log it.

Set-up builds the training state once and drives it through its first
three steps, on three batches whose rows all differ, through the same
call and feed as the window; the window goes on with the same state. The
plain reference follows those three steps in float32 and is compared,
once the window has closed, by the worst leaf (see ``gaps``): each step's
loss (``loss_gap``), the norm of the first step's gradient as the
optimizer got it, read from its momentum after one step (``grad_gap``),
and the norm of each parameter's change over the three steps, read
before the fourth (``update_gap``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import host, traffic, weights
from portbench.arith import flops as arith_flops
from portbench.common import subseed
from portbench.reference import detect, nets
from portbench.reference import train as ref_train
from portbench.trace import TRACE_SECONDS

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CHECKED_STEPS = 3
# Leaves whose reference gradient is under this share of the median
# leaf's move by rounding alone (a bias under softmax, say): their change
# is not compared.
STILL_LEAF = 1e-3


def write_set(root: str, examples) -> None:
    """JPEGs and a retinaface label.txt for ``examples`` ((image, rows))."""
    import cv2

    lines = []
    for k, (img, rows) in enumerate(examples):
        name = f"im{k:04d}.jpg"
        cv2.imwrite(os.path.join(root, name), img[..., ::-1])
        lines.append(f"# {name}")
        for r in rows:
            x1, y1, x2, y2 = r[:4]
            row = f"{x1:.1f} {y1:.1f} {x2 - x1:.1f} {y2 - y1:.1f}"
            if r[4] >= 0:
                row += "".join(f" {r[4 + 2 * i]:.1f} {r[5 + 2 * i]:.1f} 0.0" for i in range(5)) + " 0.9"
            lines.append(row)
    with open(os.path.join(root, "label.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def read_rows(path: str) -> Dict[str, np.ndarray]:
    """``write_set``'s label file back: (N, 14) pixel rows an image,
    ``[x1, y1, x2, y2]`` and ten landmark coordinates or -1."""
    out: Dict[str, list] = {}
    name = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("#"):
                name = line[1:].strip()
                out[name] = []
            elif line:
                v = [float(t) for t in line.split()]
                lm = [c for i in range(5) for c in v[4 + 3 * i:6 + 3 * i]] if len(v) > 4 else [-1.0] * 10
                out[name].append([v[0], v[1], v[0] + v[2], v[1] + v[3], *lm])
    return {k: np.asarray(r, np.float64).reshape(-1, 14) for k, r in out.items()}


def trainer_args(cfg: Dict, root: str):
    from video_desensitization_torch.cli.train import parse_args

    opt = cfg["optimizer"]
    return parse_args([
        "--labels", os.path.join(root, "label.txt"), "--images", root,
        "--backbone", "resnet50", "--input-size", str(cfg["input_size"]),
        "--batch-size", str(cfg["batch_size"]), "--max-gt", str(cfg["max_gt"]),
        "--lr", str(opt["lr"]), "--momentum", str(opt["momentum"]),
        "--weight-decay", str(opt["weight_decay"]), "--gamma", str(opt["gamma"]),
        "--milestones", opt["milestones"], "--warmup-epochs", str(opt["warmup_epochs"]),
        "--compute-dtype", cfg["compute_dtype"], "--log-every", str(cfg["log_every"])])


def first_step_bn_stats(model, momentum: float) -> Dict[str, torch.Tensor]:
    """Each batch norm's batch variance in the first step, read back from
    the running variance the step left (the configuration's update:
    ``running = momentum * running + (1 - momentum) * biased batch
    variance``, from 1)."""
    return {name: ((m.running_var.detach().double() - momentum) / (1.0 - momentum)).cpu()
            for name, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}


def reference_net(cfg: Dict, device="meta"):
    return nets.RetinaFace(cfg["in_channel"], cfg["out_channel"]).to(device)


def run(ctx) -> Dict:
    cfg, tp, dev = ctx.config, ctx.traffic, ctx.device
    from portbench.drivers.fused_stream import power_limit

    smi = power_limit(dev)
    hw = (cfg["input_size"], cfg["input_size"])
    examples = traffic.labelled_images(tp, subseed(ctx.seed, "images"))
    root = tempfile.mkdtemp(prefix="portbench-train-")
    try:
        return _run(ctx, smi, hw, examples, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(ctx, smi, hw, examples, root) -> Dict:
    cfg, dev = ctx.config, ctx.device
    write_set(root, examples)
    sd = weights.seeded_state_dict(reference_net(cfg), subseed(ctx.seed, "face"), dev,
                                   torch.float32)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the program: the trainer's model, optimizer, step and data path
    from video_desensitization_torch.cli.train import build_optimizer
    from video_desensitization_torch.models.configs import cfg_re50
    from video_desensitization_torch.models.retinaface import RetinaFace
    from video_desensitization_torch.ops.anchors import generate_anchors
    from video_desensitization_torch.train.data import batch_iterator, load_retinaface_labels
    from video_desensitization_torch.train.step import create_train_state, make_train_step

    args = trainer_args(cfg, root)
    labels = load_retinaface_labels(args.labels)
    anchors = generate_anchors(hw, cfg_re50["min_sizes"], cfg_re50["steps"])
    batches = list(batch_iterator(labels, args.images, hw, anchors, batch_size=args.batch_size,
                                  max_gt=args.max_gt, shuffle=False, device=dev))
    if len(batches) < CHECKED_STEPS:
        raise RuntimeError(f"{len(batches)} batches; the check needs {CHECKED_STEPS}")
    model = RetinaFace(cfg_re50, mode="train").to(dev)
    model.load_state_dict(sd)
    del sd
    optimizer, schedule = build_optimizer(args, len(batches), model)
    state = create_train_state(model, optimizer, schedule, device=dev)
    step_fn = make_train_step(DTYPES[args.compute_dtype])
    log_every = args.log_every

    def step(i):
        _, metrics = step_fn(state, batches[i % len(batches)])
        if state.step % log_every == 0:
            loss = float(metrics["loss"])  # the trainer's loop logs it: a sync
            if not np.isfinite(loss):
                raise RuntimeError(f"loss {loss} at step {state.step}")
        return metrics

    # ---- the checked first steps (they warm up every shape of the window)
    params = [p for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    p0 = [p.detach().clone() for p in params]
    terms = [{k: float(v) for k, v in step(0).items()}]
    wd = optimizer.param_groups[0]["weight_decay"]
    bufs = [optimizer.state[p].get("momentum_buffer") for p in params]
    bn_stats = first_step_bn_stats(model, cfg["batch_norm"]["momentum"])
    grads = [(b - wd * q).cpu() if b is not None else torch.zeros(q.shape) for b, q in zip(bufs, p0)]
    for i in range(1, CHECKED_STEPS):
        terms.append({k: float(v) for k, v in step(i).items()})
    losses = [t["loss"] for t in terms]
    updates = [(p.detach() - q).cpu() for p, q in zip(params, p0)]
    lrs = [schedule(k) for k in range(CHECKED_STEPS)]
    del p0, bufs

    # ---- the window (a traced run traces its last TRACE_SECONDS)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    host0 = host.snapshot()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t_process
    deadline = t_start + ctx.seconds
    trace_from = deadline - min(ctx.seconds, TRACE_SECONDS) if ctx.trace else float("inf")
    steps = traced_steps = 0
    t_traced = None
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        if t_traced is None and t0 >= trace_from:
            ctx.device_trace.start()
            t_traced, traced_steps = time.perf_counter(), steps
        step(CHECKED_STEPS + steps)
        ctx.spans.add("step", t0, time.perf_counter())
        steps += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_done = time.perf_counter()
    host_window = host.delta(host0, host.snapshot())
    if t_traced is not None:
        ctx.device_trace.stop()
    window_s = t_done - t_start
    memory_peak = ctx.memory_peak_bytes()
    images_per_s = steps * args.batch_size / window_s
    ctx.note(f"host over the window {host_window}")
    ctx.note(f"{smi} | {steps} steps in {window_s:.6f} s | peak memory {memory_peak} bytes | "
             f"losses of the checked steps {losses}")
    del state, model, optimizer, step_fn, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    obs = {"steps": steps, "window_s": window_s, "batch": args.batch_size}
    if t_traced is not None:
        obs.update(steps=steps - traced_steps, window_s=t_done - t_traced)
    if ctx.trace:
        obs["flops_per_step"] = arith_flops.train_step_flops(
            reference_net(cfg), (args.batch_size, 3, *hw))
        ctx.note(f"reference FLOPs a step {obs['flops_per_step']:.6e}")

    t0 = time.perf_counter()
    ref = reference_steps(cfg, ctx.seed, root, dev, lrs, args)
    ours = {"losses": losses, "terms": terms, "grads": grads, "updates": updates, "bn": bn_stats}
    every = gaps(ours, ref)
    numbers = {k: every[k] for k in ctx.workload["limits"]}
    ctx.note(f"reference {time.perf_counter() - t0:.2f} s | losses {ref['losses']} | "
             f"leaves compared {ref['moving']} of {len(names)} | every gap {every} | worst "
             f"leaves (name, ours, reference): {worst_leaves(ours, ref, names)}")
    return {
        "e2e": {"images_per_s": images_per_s, "setup_s": setup_s},
        "attempted": steps,
        "failed": 0,
        "memory_peak_bytes": memory_peak,
        "numbers": numbers,
        "obs": obs,
    }


def reference_steps(cfg: Dict, seed: int, root: str, device, lrs: List[float],
                    args, qdtype=None, fault=None, autocast=None) -> Dict:
    """The reference's first three steps from the seed's weights on the
    labelled JPEGs under ``root`` (``write_set``'s), the benchmark's own
    annotation rows re-read from its label file: each step's loss,
    each leaf's first gradient norm and its change over the three steps.
    ``qdtype`` runs its convolutions in 8-bit floats (the control);
    ``fault`` = "half_batch" takes each step's loss over the first half of
    the batch; ``autocast`` runs the forward and backward under
    ``torch.autocast`` in that type (a witness of what the type alone
    does)."""
    import cv2

    with weights.no_tf32():
        hw = (cfg["input_size"], cfg["input_size"])
        net = reference_net(cfg, device)
        sd = weights.seeded_state_dict(reference_net(cfg), subseed(seed, "face"), device,
                                       torch.float32)
        net.load_state_dict(sd)
        nets.set_qdtype(net.train(), qdtype)
        pri = detect.priors(hw, cfg["min_sizes"], cfg["steps"]).to(device)
        params = list(net.parameters())
        p0 = [p.detach().clone() for p in params]
        bufs: List = [None] * len(params)
        b = args.batch_size
        losses, terms, grads = [], [], None
        bn_stats: Dict[str, torch.Tensor] = {}

        def bn_hook(name):
            def hook(m, inp, out):
                if not bn_stats.get("_done"):
                    x = inp[0].detach().double()
                    bn_stats[name] = x.var(dim=(0, 2, 3), unbiased=False).cpu()
            return hook

        hooks = [m.register_forward_hook(bn_hook(n)) for n, m in net.named_modules()
                 if isinstance(m, torch.nn.BatchNorm2d)]
        rows = read_rows(os.path.join(root, "label.txt"))
        for k in range(len(lrs)):
            xs, targets = [], []
            for i in range(k * b, (k + 1) * b):
                name = f"im{i:04d}.jpg"
                decoded = np.ascontiguousarray(cv2.imread(os.path.join(root, name))[..., ::-1])
                x, gt = ref_train.example(decoded, rows[name], hw, args.max_gt, device)
                xs.append(x)
                targets.append(ref_train.match(gt, pri, cfg["match_iou"], cfg["variance"]))
            if fault == "half_batch":
                xs, targets = xs[:b // 2], targets[:b // 2]
            loc_t, landm_t, labels = (torch.stack(t) for t in zip(*targets))
            with torch.autocast(device.type, dtype=autocast, enabled=autocast is not None):
                heads = net(torch.stack(xs))
            loc, cls, landm = (h.float() for h in heads)
            loss, parts = ref_train.multibox_loss(loc, cls, landm, loc_t, landm_t, labels, cfg["loss"])
            net.zero_grad(set_to_none=True)
            loss.backward()
            if k == 0:
                grads = [p.grad.detach().cpu() for p in params]
                bn_stats["_done"] = True
            opt = cfg["optimizer"]
            ref_train.sgd_step(params, bufs, lrs[k], opt["momentum"], opt["weight_decay"])
            losses.append(float(loss.detach()))
            terms.append({k: float(v.detach()) for k, v in parts.items()})
        updates = [(p.detach() - q).cpu() for p, q in zip(params, p0)]
        for h in hooks:
            h.remove()
    bn_stats.pop("_done")
    median = float(np.median([float(g.norm()) for g in grads]))
    return {"losses": losses, "terms": terms, "grads": grads, "updates": updates, "bn": bn_stats,
            "moving": sum(float(g.norm()) >= STILL_LEAF * median for g in grads)}


def _norms(vectors) -> np.ndarray:
    return np.asarray([float(v.double().norm()) for v in vectors])


def worst_leaves(ours: Dict, ref: Dict, names: List[str], k: int = 3) -> Dict[str, list]:
    """The ``k`` leaves of largest norm gap, for the record of a run."""
    out = {}
    for key in ("grads", "updates"):
        a, r = _norms(ours[key]), _norms(ref[key])
        med = float(np.median(r))
        gap = np.abs(a - r) / np.maximum(r, med)
        out[key] = [(names[i], float(a[i]), float(r[i])) for i in np.argsort(-gap)[:k]]
    return out


def gaps(ours: Dict, ref: Dict) -> Dict[str, float]:
    """Per leaf, against the reference's norm of that leaf or of the median
    leaf, whichever is larger: the gap between our norm and the reference's
    (``grad_gap``, ``update_gap``: the worst leaf; ``..._median``: the
    median leaf) and the norm of our difference from the reference
    (``grad_diff``, ``update_diff``: the median leaf; ``..._worst``); loss
    gaps over the reference's loss, the worst step's (``loss_gap``) and the
    first step's (``loss1_gap``). Updates leave out the leaves whose
    reference gradient is under ``STILL_LEAF`` of the median leaf's."""
    g_ref = _norms(ref["grads"])
    g_med = float(np.median(g_ref))
    moving = g_ref >= STILL_LEAF * g_med
    u_ref = _norms(ref["updates"])
    u_med = float(np.median(u_ref[moving]))
    g_floor = np.maximum(g_ref, g_med)
    u_floor = np.maximum(u_ref, u_med)[moving]
    g_gap = np.abs(_norms(ours["grads"]) - g_ref) / g_floor
    u_gap = (np.abs(_norms(ours["updates"]) - u_ref) / np.maximum(u_ref, u_med))[moving]
    g_diff = _norms([a.double() - b.double() for a, b in zip(ours["grads"], ref["grads"])]) / g_floor
    u_diff = _norms([a.double() - b.double() for a, b, m in zip(ours["updates"], ref["updates"], moving)
                     if m]) / u_floor
    loss = [abs(a - r) / abs(r) for a, r in zip(ours["losses"], ref["losses"])]
    first = {f"{k[5:]}1_gap": abs(ours["terms"][0][k] - v) / max(abs(v), 1e-12)
             for k, v in ref["terms"][0].items()}
    bn = np.asarray([float((ours["bn"][k] - v).norm() / v.norm()) for k, v in ref["bn"].items()])
    return {"loss_gap": float(max(loss)), "loss1_gap": float(loss[0]), **first,
            "bn_var_gap": float(np.median(bn)), "bn_var_gap_worst": float(bn.max()),
            "grad_gap": float(g_gap.max()), "grad_gap_median": float(np.median(g_gap)),
            "update_gap": float(u_gap.max()), "update_gap_median": float(np.median(u_gap)),
            "grad_diff": float(np.median(g_diff)), "grad_diff_worst": float(g_diff.max()),
            "update_diff": float(np.median(u_diff)), "update_diff_worst": float(u_diff.max())}
