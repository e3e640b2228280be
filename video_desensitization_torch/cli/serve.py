"""Serving entry point: the resident watch-folder desensitization daemon.

    python -m video_desensitization_torch.cli.serve config.ini \\
        [--inbox DIR --out DIR] [--port N] [--max-jobs N] [--device cpu]

The config.ini gives the models and pipeline settings (the file the
one-shot CLI reads, ``cli/main.py``) and an optional [SERVICE] section:

    [SERVICE]
    inbox_dir = /data/inbox
    output_dir = /data/out
    poll_interval = 2.0
    stable_polls = 1
    http_port = 8080
    delete_inputs = false

Drop `.record` files (or `.record.0000N` segment sets, or plain videos)
into the inbox; outputs land under output_dir, finished inputs move to
`<inbox>/.done` (`.failed` with an error.txt on error), and every job
appends one JSON line to `<output_dir>/service_journal.jsonl`. An uploader
that writes a `<name>.complete` marker LAST has its job claimed on the next
scan. Several daemons may share one inbox: claims are atomic renames.
SIGTERM/SIGINT drain: the job in flight finishes, then the daemon exits 0.
The engine is built once, on ``cuda`` unless ``--device cpu`` is given,
and serves every job.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    from video_desensitization_torch.api.config import load_config
    from video_desensitization_torch.cli.main import build_engine
    from video_desensitization_torch.pipeline.service import (
        DesensitizationService,
        ServiceConfig,
        load_service_config,
    )
    from video_desensitization_torch.utils.logging import setup_logger

    p = argparse.ArgumentParser(description="Video desensitization service on PyTorch/CUDA")
    p.add_argument("config", nargs="?", default="config.ini")
    p.add_argument("--inbox", help="watch directory (overrides [SERVICE])")
    p.add_argument("--out", help="output directory (overrides [SERVICE])")
    p.add_argument("--port", type=int, help="HTTP status port (0 = ephemeral)")
    p.add_argument("--poll", type=float, help="poll interval seconds")
    p.add_argument("--max-jobs", type=int, help="exit after N jobs")
    p.add_argument("--no-plates", action="store_true")
    p.add_argument(
        "--device",
        help="torch device to run on (default: cuda; 'cpu' must be asked for)",
    )
    p.add_argument("--allow-random-weights", action="store_true")
    args = p.parse_args(argv)

    log = setup_logger()
    pcfg = load_config(args.config, strict=False)
    try:
        # --inbox/--out apply BEFORE ServiceConfig is built, so the derived
        # work/done/failed dirs follow them.
        scfg = load_service_config(args.config, inbox_dir=args.inbox, output_dir=args.out)
    except ValueError:
        if not (args.inbox and args.out):
            raise SystemExit("no [SERVICE] section in config and no --inbox/--out given")
        scfg = ServiceConfig(inbox_dir=args.inbox, output_dir=args.out)
    if args.port is not None:
        scfg.http_port = args.port
    if args.poll is not None:
        scfg.poll_interval_s = args.poll

    engine = build_engine(
        pcfg,
        with_plates=not args.no_plates,
        allow_random=args.allow_random_weights,
        device=args.device,
    )
    service = DesensitizationService(scfg, pcfg, engine)

    stop = threading.Event()

    def _drain(signum, frame):
        log.info("signal %d: draining (the current job will finish)", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)

    handled = service.run(stop, max_jobs=args.max_jobs)
    log.info("service exiting after %d job(s)", handled)
    return 0


if __name__ == "__main__":
    sys.exit(main())
