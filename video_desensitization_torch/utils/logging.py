"""Logger setup — parity with the reference's ``VideoProcessor.*`` hierarchy
(combine_detect.py:21-51): INFO to console, DEBUG to a log file."""

from __future__ import annotations

import logging
from typing import Optional

ROOT_NAME = "VideoProcessor"


def setup_logger(
    log_file: Optional[str] = "video_processing.log", level=logging.INFO
) -> logging.Logger:
    logger = logging.getLogger(ROOT_NAME)
    logger.setLevel(logging.DEBUG)
    # Library imports (absl via orbax) install root handlers mid-run; don't
    # double-emit every record through them.
    logger.propagate = False
    if logger.handlers:
        return logger
    console = logging.StreamHandler()
    console.setLevel(level)
    console.setFormatter(
        logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    )
    logger.addHandler(console)
    if log_file:
        fh = logging.FileHandler(log_file, encoding="utf-8")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(
            logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        )
        logger.addHandler(fh)
    return logger


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT_NAME}.{name}")
