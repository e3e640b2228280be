"""The 12-camera Apollo topic registry (the string table of the reference's
``recordDeal`` module). File naming: ``topic_<camera_name>.h265`` under an
``hevcs/`` directory."""

from __future__ import annotations

import os
from typing import Optional

CAMERA_NAMES = (
    "front_narrow",
    "front_wide",
    "front_wide_left",
    "left_back",
    "left_front",
    "rear",
    "right_back",
    "right_front",
    "surround_front",
    "surround_left",
    "surround_rear",
    "surround_right",
)

CAMERA_TOPICS = tuple(
    f"/drivers/camera/{name}/compressed/image" for name in CAMERA_NAMES
)

COMPRESSED_IMAGE_TYPE = "apollo.drivers.CompressedImage"

HEVC_SUBDIR = "hevcs"
TOPIC_FILE_PREFIX = "topic_"


def camera_name_from_topic(topic: str) -> str:
    parts = topic.strip("/").split("/")
    # /drivers/camera/<name>/compressed/image
    return parts[2] if len(parts) >= 3 else topic.replace("/", "_")


def hevc_filename_for_topic(topic: str) -> str:
    return f"{TOPIC_FILE_PREFIX}{camera_name_from_topic(topic)}.h265"


def topic_from_filename(filename: str) -> Optional[str]:
    """Invert topic_<camera>.h265-style names back to the camera topic.

    Accepts processed variants like topic_front_wide_processed.mp4
    (the reference's match_topics_and_hevcs: match by camera_name)."""
    stem = os.path.splitext(os.path.basename(filename))[0]
    if not stem.startswith(TOPIC_FILE_PREFIX):
        return None
    stem = stem[len(TOPIC_FILE_PREFIX) :]
    if stem.endswith("_processed"):
        stem = stem[: -len("_processed")]
    for name in CAMERA_NAMES:
        if stem == name:
            return f"/drivers/camera/{name}/compressed/image"
    return None
