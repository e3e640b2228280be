"""The comparison's control and planted faults, read on the card at a
cell's own size; the benchmark's own runs never run this.

    python -m portbench.control --workload <cell> --seeds 11,12,13 [--fault half_batch]

The control is the plain reference put in the program's place and
computed in the nearest precision below the configuration's: bf16 ->
8-bit float (e4m3) convolutions, one scale a tensor. Each line printed
is one seed's compared numbers beside their limits, and ``correct`` by a
run's own rule, as a run of the cell would report them with the
program's outputs replaced:

* fused stream cell: the control's detections of the seed's pool of
  frames (every batch of a window is one of them), and the reference
  mosaic of the frames with the control's own boxes, judged against the
  float32 reference as a run's outputs are;
* training cell: the control's first three steps (or, with ``--fault
  half_batch``, the float32 reference taking each step's loss over the
  first half of the batch), judged as a run's steps are.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from portbench import common, traffic
from portbench.common import subseed


def engine_numbers(cfg, tp, seed, device, qdtype):
    from portbench.drivers import fused_stream as fs
    from portbench.reference import detect

    pool = traffic.frame_pool(tp, subseed(seed, "frames"), device)
    seeded = fs._seeded(cfg, device, fs.DTYPES[cfg["dtype"]])
    ref = fs.reference_detections(cfg, seeded, pool, device)
    ctrl = fs.reference_detections(cfg, seeded, pool, device, qdtype=qdtype)
    boxes, held = [], {}
    for j, (faces, plates) in enumerate(ctrl):
        fb = [f["kept"][:, :4].tolist() for f in faces]
        pb = [p["kept"][:, :4].tolist() for p in plates]
        boxes.append((fb, pb))
        held[j] = [detect.mosaic_(torch.tensor(pool[j][i], device=device),
                                  fs._frame_boxes(fb[i], pb[i]), cfg["mosaic_level"]).cpu().numpy()
                   for i in range(len(fb))]
    numbers = fs.judge(boxes, ref, pool, held, cfg["mosaic_level"], device, cfg)
    numbers.pop("_worst")
    return numbers


def train_numbers(cfg, tp, seed, device, qdtype, fault, witness=None):
    from portbench.drivers import train_step as tsd

    opt = cfg["optimizer"]
    if opt["warmup_epochs"] != 0:
        raise SystemExit("the control reads a constant learning rate (warmup_epochs 0)")
    lrs = [opt["lr"]] * tsd.CHECKED_STEPS
    args = SimpleNamespace(batch_size=cfg["batch_size"], max_gt=cfg["max_gt"])
    examples = traffic.labelled_images(tp, subseed(seed, "images"))
    root = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        tsd.write_set(root, examples)
        ref = tsd.reference_steps(cfg, seed, root, device, lrs, args)
        ours = tsd.reference_steps(cfg, seed, root, device, lrs, args,
                                   qdtype=None if fault or witness else qdtype, fault=fault,
                                   autocast=witness)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return tsd.gaps(ours, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--fault", choices=("half_batch",), default=None,
                   help="training cell: a planted fault in place of the control")
    p.add_argument("--witness", choices=("bfloat16",), default=None,
                   help="training cell: the reference under autocast in this type in place of "
                        "the control (what the type alone does)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    spec = common.benchmark_spec()
    entry = next(w for w in spec["workloads"] if w["name"] == args.workload)
    workload = common.load_workload(args.workload)
    cfg = common.load_config(entry["config"])
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if workload["driver"] == "fused_stream":
            numbers = engine_numbers(cfg, workload["traffic"], seed, device, torch.float8_e4m3fn)
        else:
            numbers = train_numbers(cfg, workload["traffic"], seed, device, torch.float8_e4m3fn,
                                    args.fault, getattr(torch, args.witness) if args.witness else None)
        checks, correct = common.judged(numbers, workload["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "what": args.fault or args.witness or "control fp8", "correct": correct,
                          "checks": checks, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
