"""Per-video and per-record jobs: the reference's L5 orchestration
(process_video_pipeline / process_single_video / process_mf4 /
copy_unprocessed_video, combine_detect.py:597-783, and its __main__ flow)."""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Dict, Optional

from video_desensitization_torch.api.config import PipelineConfig
from video_desensitization_torch.pipeline.streaming import process_video_stream
from video_desensitization_torch.record.repack import write_allH265_record_all
from video_desensitization_torch.record.topics import HEVC_SUBDIR
from video_desensitization_torch.record.unpack import read_record2h265_all
from video_desensitization_torch.utils.logging import get_logger


@dataclass
class VideoResult:
    success: bool
    frames: int = 0
    faces: int = 0
    plates: int = 0
    wall_s: float = 0.0


def process_single_video(
    video_path: str,
    output_dir: str,
    engine,
    batch_size: int = 16,
    output_fps: Optional[float] = None,
    output_ext: Optional[str] = None,
    encode_kwargs: Optional[dict] = None,
    transport: str = "rgb",
) -> VideoResult:
    """Desensitize one video with ``engine`` (fused or tiered); the output
    is named <name>_processed.<ext> (the reference's naming,
    combine_detect.py:658), ``ext`` being the input's unless
    ``output_ext`` is given. A failure is logged and reported in the
    result, so one bad stream does not end a record job."""
    log = get_logger("process_single_video")
    os.makedirs(output_dir, exist_ok=True)
    name, ext = os.path.splitext(os.path.basename(video_path))
    ext = output_ext or ext
    out_path = os.path.join(output_dir, f"{name}_processed{ext}")
    t0 = time.time()
    try:
        stats = process_video_stream(
            video_path, out_path, engine, batch_size=batch_size,
            fps=output_fps, encode_kwargs=encode_kwargs, transport=transport,
        )
    except Exception as e:  # noqa: BLE001 - the job goes on with the next stream
        log.error("failed on %s: %s", video_path, e)
        return VideoResult(False, wall_s=time.time() - t0)
    return VideoResult(
        True, stats.frames, stats.faces, stats.plates, time.time() - t0
    )


def copy_unprocessed_video(video_path: str, output_dir: str) -> bool:
    """Copy non-video files through (the reference, combine_detect.py:701-715)."""
    log = get_logger("copy_unprocessed")
    try:
        os.makedirs(output_dir, exist_ok=True)
        shutil.copy2(video_path, os.path.join(output_dir, os.path.basename(video_path)))
        return True
    except OSError as e:
        log.error("copy failed for %s: %s", video_path, e)
        return False


def process_mf4(file_path: str, output_dir: str) -> bool:
    """.mf4 measurement files are copied, not desensitized (the reference,
    combine_detect.py:768-783)."""
    return copy_unprocessed_video(file_path, output_dir)


class JobManifest:
    """Per-video resume state for a record job.

    Each completed stream is recorded in ``.vdt_manifest.json`` inside the
    output videos directory; on rerun, completed entries whose outputs
    still exist are skipped (the reference reprocesses everything after a
    crash).
    """

    NAME = ".vdt_manifest.json"

    def __init__(self, output_dir: str, root: Optional[str] = None):
        self.path = os.path.join(output_dir, self.NAME)
        self.root = root
        self.done: Dict[str, dict] = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self.done = json.load(f)
            except (OSError, ValueError):
                self.done = {}

    def _key(self, src_path: str) -> str:
        # Keyed by path relative to the job root (not basename): two videos
        # with the same filename in different subdirs must not collide.
        if self.root:
            try:
                return os.path.relpath(src_path, self.root)
            except ValueError:
                pass
        return os.path.abspath(src_path)

    def is_done(self, src_path: str) -> bool:
        entry = self.done.get(self._key(src_path))
        return bool(entry) and os.path.exists(entry.get("output", ""))

    def mark(self, src_path: str, output_path: str, **stats) -> None:
        self.done[self._key(src_path)] = {"output": output_path, **stats}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.done, f, indent=1)
        os.replace(tmp, self.path)


@dataclass
class RecordJobStats:
    videos_processed: int = 0
    videos_copied: int = 0
    videos_failed: int = 0
    frames: int = 0
    faces: int = 0
    plates: int = 0
    record_path: Optional[str] = None
    wall_s: float = 0.0


def process_record_job(config: PipelineConfig, engine) -> RecordJobStats:
    """Full record job: unpack -> per-stream desensitize -> repack (the
    reference's __main__ flow, combine_detect.py:786-990), one stream after
    another. ``co_batch`` (the camera streams co-batched) needs the
    multicam module, which is not ported yet: it is refused."""
    if config.co_batch:
        raise ValueError(
            "[TPU] co_batch = true needs the multicam module, which is not "
            "ported yet (ROADMAP.md item 13); set [TPU] co_batch = false"
        )
    log = get_logger("record_job")
    stats = RecordJobStats()
    t0 = time.time()

    read_record2h265_all(config.record_dir, config.output_h265_dir)
    hevc_dir = os.path.join(config.output_h265_dir, HEVC_SUBDIR)
    os.makedirs(config.output_videos_dir, exist_ok=True)
    manifest = (
        JobManifest(config.output_videos_dir, root=hevc_dir)
        if config.resume
        else None
    )

    for root, _dirs, files in os.walk(hevc_dir):
        for fname in sorted(files):
            fpath = os.path.join(root, fname)
            ext = os.path.splitext(fname)[1].lower().lstrip(".")
            if ext == "mf4":
                if process_mf4(fpath, config.output_videos_dir):
                    stats.videos_copied += 1
                continue
            if ext in config.video_formats:
                if manifest is not None and manifest.is_done(fpath):
                    log.info("resume: skipping completed %s", fname)
                    stats.videos_processed += 1
                    continue
                res = process_single_video(
                    fpath,
                    config.output_videos_dir,
                    engine,
                    batch_size=config.batch_size,
                    output_fps=config.output_fps,
                    encode_kwargs=config.encode_kwargs,
                    transport=config.transfer,
                )
                if res.success:
                    stats.videos_processed += 1
                    stats.frames += res.frames
                    stats.faces += res.faces
                    stats.plates += res.plates
                    if manifest is not None:
                        name, e = os.path.splitext(fname)
                        manifest.mark(
                            fpath,
                            os.path.join(
                                config.output_videos_dir, f"{name}_processed{e}"
                            ),
                            frames=res.frames,
                            faces=res.faces,
                            plates=res.plates,
                        )
                else:
                    stats.videos_failed += 1
            elif config.copy_unprocessed_videos:
                if copy_unprocessed_video(fpath, config.output_videos_dir):
                    stats.videos_copied += 1

    stats.record_path = write_allH265_record_all(
        config.record_dir, config.output_videos_dir, config.record_output_dir
    )
    stats.wall_s = time.time() - t0
    log.info(
        "record job done: %d processed, %d copied, %d failed, %d frames, "
        "%d faces, %d plates, %.1fs",
        stats.videos_processed,
        stats.videos_copied,
        stats.videos_failed,
        stats.frames,
        stats.faces,
        stats.plates,
        stats.wall_s,
    )
    return stats
