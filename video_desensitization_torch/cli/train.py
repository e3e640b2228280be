"""Training CLI for RetinaFace on PyTorch/CUDA.

    label.txt + images  ->  batch_iterator (letterbox + anchor matching)
                        ->  train step (SGD, bf16 or float32 compute)
                        ->  checkpoints ep0001, ep0002, ... (resumable)
                        ->  msgpack inference export (loads into either
                            package's Retinaface)

Usage:

    python -m video_desensitization_torch.cli.train \\
        --labels data/widerface/train/label.txt \\
        --images data/widerface/train/images \\
        --backbone resnet50 --epochs 100 --batch-size 32 \\
        --ckpt-dir ckpts/ --export retinaface.msgpack

The flags and defaults are the JAX trainer's: SGD momentum 0.9, weight
decay 5e-4, base lr 1e-3 with x0.1 decays at epoch milestones and a linear
warmup. It runs on ``cuda`` unless ``--device cpu`` is given.
``--mesh-data`` and ``--mesh-model`` take the JAX rules: data 0 means
every device divided by model, the first data x model devices are used,
and the batch must divide by data. A mesh of more than one device runs one
process per device (this one is rank 0 and starts the others; under a
launcher that made the process group already, each process is its rank),
and only rank 0 logs steps, writes checkpoints and exports.
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing
import os
import time

import numpy as np
import torch
import torch.distributed as dist

# How long rank 0 waits for the other ranks to exit once it is done.
JOIN_TIMEOUT_S = 120


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train RetinaFace on PyTorch/CUDA")
    p.add_argument("--labels", required=True, help="retinaface-style label.txt")
    p.add_argument("--images", required=True, help="image root the label paths are relative to")
    p.add_argument("--backbone", default="resnet50", choices=["resnet50", "mobilenet"])
    p.add_argument("--input-size", type=int, default=640, help="square train resolution")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-gt", type=int, default=64, help="ground-truth pad count per image")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--gamma", type=float, default=0.1, help="lr decay factor at milestones")
    p.add_argument(
        "--milestones",
        default="70,90",
        help="comma-separated EPOCH numbers where lr decays by --gamma",
    )
    p.add_argument("--warmup-epochs", type=float, default=1.0)
    p.add_argument(
        "--compute-dtype", default="float32",
        choices=["float32", "bfloat16"],
        help="forward/backward compute dtype; parameters, optimizer state "
        "and the loss stay float32",
    )
    p.add_argument("--mesh-data", type=int, default=1,
                   help="data-parallel axis size (0 = all devices / model)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel axis size (conv output channels)")
    p.add_argument("--ckpt-dir", default=None, help="checkpoint directory")
    p.add_argument("--save-every", type=int, default=1, help="checkpoint every N epochs")
    p.add_argument("--resume", default=None, help="checkpoint file to resume from")
    p.add_argument("--export", default=None,
                   help="write final weights as a msgpack the Retinaface wrapper loads")
    p.add_argument("--log-every", type=int, default=10, help="log metrics every N steps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--val-frac",
        type=float,
        default=0.0,
        help="hold out this fraction of images (deterministic split) and "
        "report validation multibox loss after every epoch",
    )
    p.add_argument("--device", help="torch device to run on (default: cuda; 'cpu' must be asked for)")
    return p.parse_args(argv)


def build_optimizer(args, steps_per_epoch: int, model: torch.nn.Module):
    """SGD over ``model``'s parameters and its step -> lr schedule."""
    from video_desensitization_torch.train.data import multistep_lr

    milestones = [
        int(round(float(m) * steps_per_epoch))
        for m in str(args.milestones).split(",")
        if str(m).strip()
    ]
    schedule = multistep_lr(
        args.lr,
        milestones,
        gamma=args.gamma,
        warmup_steps=int(round(args.warmup_epochs * steps_per_epoch)),
    )
    optimizer = torch.optim.SGD(model.parameters(), lr=schedule(0), momentum=args.momentum,
                                weight_decay=args.weight_decay)
    return optimizer, schedule


def train(args: argparse.Namespace):
    """Run the training loop; returns the final TrainState (rank 0's on a
    mesh, with its own slice of any split kernel)."""
    from video_desensitization_torch import resolve_device

    device = resolve_device(args.device)
    mesh = build_mesh(args, device)
    if mesh is None:
        return _train(args, device, None)
    if dist.is_initialized():  # a launcher started one process per device
        return _train(args, mesh.devices.flat[dist.get_rank()], mesh)
    return _launch(args, mesh)


def build_mesh(args: argparse.Namespace, device: torch.device):
    """The JAX CLI's mesh of ``--mesh-data`` x ``--mesh-model`` over the
    devices of ``device``'s kind, or None for one device."""
    from video_desensitization_torch.parallel import mesh as mesh_lib

    devices = mesh_lib.local_devices(device.type)
    if args.mesh_data == 0 and (len(devices) > 1 or args.mesh_model > 1):
        mesh = mesh_lib.make_mesh(devices, model=args.mesh_model)
    elif args.mesh_data > 1 or args.mesh_model > 1:
        mesh = mesh_lib.make_mesh(
            devices[: args.mesh_data * args.mesh_model],
            data=max(1, args.mesh_data),
            model=args.mesh_model,
        )
    else:
        return None
    if args.batch_size % mesh.shape["data"] != 0:
        raise ValueError(
            f"batch {args.batch_size} not divisible by data axis {mesh.shape['data']}"
        )
    return mesh


def _launch(args: argparse.Namespace, mesh):
    """Run rank 0 here and ranks 1.. in spawned processes, one a device of
    ``mesh``, over a process group on localhost (gloo on the CPU, NCCL on
    the cards); raise if any rank fails."""
    from video_desensitization_torch.parallel.mesh import distributed_init, localhost_address

    devices = list(mesh.devices.flat)
    address = localhost_address()
    backend = "gloo" if devices[0].type == "cpu" else "nccl"
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main, args=(
            rank, address, args, devices, mesh.devices.shape, backend, torch.get_num_threads()))
        for rank in range(1, len(devices))
    ]
    for p in procs:
        p.start()
    try:
        if devices[0].type == "cuda":
            torch.cuda.set_device(devices[0])
        distributed_init(address, len(devices), 0, backend)
        state = _train(args, devices[0], mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
            if p.is_alive():
                p.terminate()
                p.join()
    failed = [(rank, p.exitcode) for rank, p in enumerate(procs, 1) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"training ranks failed (rank, exit code): {failed}")
    return state


def _rank_main(rank, address, args, devices, shape, backend, threads) -> None:
    """A spawned rank of ``_launch``."""
    from video_desensitization_torch.parallel.mesh import distributed_init, make_mesh

    torch.set_num_threads(threads)
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
    distributed_init(address, len(devices), rank, backend)
    try:
        _train(args, devices[rank], make_mesh(devices, *shape))
    finally:
        dist.destroy_process_group()


def _train(args: argparse.Namespace, device: torch.device, mesh):
    """The training loop on ``device``: alone, or as this process's rank of
    ``mesh``."""
    from video_desensitization_torch.models.common import load_weights
    from video_desensitization_torch.models.configs import cfg_mnet, cfg_re50
    from video_desensitization_torch.models.retinaface import RetinaFace
    from video_desensitization_torch.ops.anchors import generate_anchors
    from video_desensitization_torch.parallel.tensor import shard_model
    from video_desensitization_torch.train.checkpoint import (
        export_inference_variables,
        restore_train_state,
        save_train_state,
    )
    from video_desensitization_torch.train.data import batch_iterator, load_retinaface_labels
    from video_desensitization_torch.train.step import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )
    from video_desensitization_torch.utils.logging import get_logger

    if mesh is not None and device.type == "cuda":
        torch.cuda.set_device(device)  # a launcher's rank comes here unset
    log = get_logger("train")
    if mesh is not None and dist.get_rank() != 0:
        log.setLevel(logging.WARNING)  # rank 0 logs the run
    hw = (args.input_size, args.input_size)
    cfg = cfg_re50 if args.backbone == "resnet50" else cfg_mnet
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32

    labels = load_retinaface_labels(args.labels)
    if not labels:
        raise ValueError(f"no annotations parsed from {args.labels}")
    val_labels: dict = {}
    if args.val_frac > 0:
        keys = sorted(labels)
        n_val = max(1, int(round(len(keys) * args.val_frac)))
        if n_val >= len(keys):
            raise ValueError(f"--val-frac {args.val_frac} leaves no train data")
        val_keys = set(
            np.random.default_rng(args.seed).choice(keys, size=n_val, replace=False).tolist()
        )
        val_labels = {k: labels[k] for k in val_keys}
        labels = {k: v for k, v in labels.items() if k not in val_keys}
        if len(val_labels) < args.batch_size:
            log.warning(
                "validation split (%d images) smaller than one batch (%d): "
                "validation will be skipped (full batches only)",
                len(val_labels), args.batch_size,
            )
    steps_per_epoch = max(1, len(labels) // args.batch_size)
    log.info(
        "%d annotated images | %d steps/epoch @ batch %d | input %dx%d (%s) on %s",
        len(labels), steps_per_epoch, args.batch_size, *hw, args.backbone, device,
    )
    if mesh is not None:
        log.info("mesh: %s, one process a device", mesh.shape)

    model = RetinaFace(cfg, mode="train")
    load_weights(model, None, None, args.seed)
    if mesh is not None:
        shard_model(model, mesh)
    optimizer, schedule = build_optimizer(args, steps_per_epoch, model)
    state = create_train_state(model, optimizer, schedule, device=device, mesh=mesh)
    if args.resume:
        state = restore_train_state(args.resume, state)
        log.info("resumed from %s at step %d", args.resume, state.step)

    anchors = generate_anchors(hw, min_sizes=cfg["min_sizes"], steps=cfg["steps"])
    step_fn = make_train_step(compute_dtype, mesh=mesh)
    eval_fn = make_eval_step(compute_dtype, mesh=mesh) if val_labels else None

    def run_validation(epoch):
        n, tot = 0, 0.0
        for vb in batch_iterator(
            val_labels, args.images, hw, anchors,
            batch_size=args.batch_size, max_gt=args.max_gt,
            shuffle=False, drop_remainder=True, device=device,
        ):
            tot += float(eval_fn(state, vb)["loss"])
            n += 1
        if n:
            log.info("epoch %d validation: loss %.4f over %d batches", epoch, tot / n, n)

    total_steps = args.epochs * steps_per_epoch
    start_epoch = state.step // steps_per_epoch
    t_start = time.time()
    metrics = {}
    for epoch in range(start_epoch, args.epochs):
        it = batch_iterator(
            labels, args.images, hw, anchors,
            batch_size=args.batch_size, max_gt=args.max_gt,
            shuffle=True, seed=args.seed + epoch, device=device,
        )
        t_ep = time.time()
        n_steps = 0
        for batch in it:
            lr = schedule(state.step)
            state, metrics = step_fn(state, batch)
            n_steps += 1
            if state.step % args.log_every == 0 or n_steps == 1:
                m = {k: float(v) for k, v in metrics.items()}
                log.info(
                    "epoch %d step %d/%d lr %.2e | loss %.4f (loc %.4f cls %.4f landm %.4f)",
                    epoch, state.step, total_steps, lr, m["loss"], m["loss_loc"],
                    m["loss_cls"], m["loss_landm"],
                )
        dt = time.time() - t_ep
        log.info(
            "epoch %d done: %d steps in %.1fs (%.2f img/s)",
            epoch, n_steps, dt, n_steps * args.batch_size / max(dt, 1e-9),
        )
        if eval_fn is not None:
            run_validation(epoch)
        if args.ckpt_dir and ((epoch + 1) % args.save_every == 0 or epoch + 1 == args.epochs):
            path = save_train_state(os.path.join(args.ckpt_dir, f"ep{epoch + 1:04d}"), state)
            log.info("checkpoint: %s", path)

    if metrics:
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"training diverged: final loss {loss}")
    log.info("training done in %.1fs (%d steps)", time.time() - t_start, state.step)

    if args.export:
        export_inference_variables(args.export, state)
        log.info("inference weights exported: %s", args.export)
    return state


def main(argv=None) -> int:
    from video_desensitization_torch.utils.logging import setup_logger

    setup_logger()
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
