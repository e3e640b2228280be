"""The comparison's control for the cell that ``control.py`` does not
dispatch: the RT-DETR stream cell, read on the card at the cell's own
size; the benchmark's own runs never run this.

    python -m portbench.control_detr --workload <cell> --seeds 11,12,13

As ``control.py``: the plain reference put in the program's place and
computed in the nearest precision below the configuration's (bf16 ->
e4m3, one scale a tensor), each seed's compared numbers beside their
limits and ``correct`` by a run's own rule, on one line each:
RetinaFace's convolutions and RT-DETR's convolutions and linear layers
(its attention projections too) in 8-bit floats, the detections of the
seed's pool judged by ``drivers/fused_stream_detr.py`` against the float32
reference (the control's plates by the tokens its own selection took), the
held frames mosaicked with the control's own boxes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import common, traffic
from portbench.common import subseed


def detr_numbers(cfg, tp, seed, device, qdtype):
    from portbench.drivers import fused_stream as fs
    from portbench.drivers import fused_stream_detr as fsd
    from portbench.reference import detect

    pool = traffic.frame_pool(tp, subseed(seed, "frames"), device)
    seeded = fsd._seeded(cfg, device, fs.DTYPES[cfg["dtype"]])
    ref = fsd.reference_detections(cfg, seeded, pool, device)
    ctrl = fsd.reference_detections(cfg, seeded, pool, device, qdtype=qdtype)
    boxes, held = [], {}
    for j, (faces, plates) in enumerate(ctrl):
        fb = [f["kept"][:, :4].tolist() for f in faces]
        pb = [p["kept"][:, :4].tolist() for p in plates]
        boxes.append((fb, pb))
        held[j] = [detect.mosaic_(torch.tensor(pool[j][i], device=device),
                                  fs._frame_boxes(fb[i], pb[i]), cfg["mosaic_level"]).cpu().numpy()
                   for i in range(len(fb))]
    tokens = [[p["kept_tokens"] for p in plates] for _, plates in ctrl]
    numbers = fsd.judged(cfg, boxes, tokens, ref, pool, held, device)
    numbers.pop("_worst")
    return numbers


NUMBERS = {"fused_stream_detr": detr_numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control_detr: no CUDA device", file=sys.stderr)
        return 2
    spec = common.benchmark_spec()
    entry = next(w for w in spec["workloads"] if w["name"] == args.workload)
    workload = common.load_workload(args.workload)
    cfg = common.load_config(entry["config"])
    numbers_of = NUMBERS[workload["driver"]]
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = numbers_of(cfg, workload["traffic"], seed, device, torch.float8_e4m3fn)
        checks, correct = common.judged(numbers, workload["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed, "what": "control fp8",
                          "correct": correct, "checks": checks, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
