"""Frame extraction and video assembly (the reference's L2,
combine_detect.py:279 and :479, video2picture.py, picture2video.py),
in-process through ``video/av.py`` (native libav, or cv2 where that is
absent): no ffmpeg subprocess. ``iter_frames`` is the streaming form,
batched RGB arrays straight from the decoder.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from video_desensitization_torch.utils.logging import get_logger
from video_desensitization_torch.video.av import (
    VideoDecoder,
    VideoEncoder,
    default_codec_for,
    native_available,
)


def iter_frames(
    video_path: str, batch_size: int = 16, interval: int = 1
) -> Iterator[np.ndarray]:
    """Yield (b, H, W, 3) uint8 RGB batches (b <= batch_size) of every
    ``interval``-th frame."""
    with VideoDecoder(video_path) as dec:
        batch = []
        for i, frame in enumerate(dec):
            if i % interval != 0:
                continue
            batch.append(frame)
            if len(batch) == batch_size:
                yield np.stack(batch)
                batch = []
        if batch:
            yield np.stack(batch)


def convert_video_to_frames(
    video_path: str, output_dir: str, interval: int = 1
) -> int:
    """Extract every ``interval``-th frame to ``frame_%06d.jpg`` files;
    returns the frame count (the reference's combine_detect.py:279-476)."""
    import cv2

    log = get_logger("extract")
    os.makedirs(output_dir, exist_ok=True)
    count = 0
    with VideoDecoder(video_path) as dec:
        for i, frame in enumerate(dec):
            if i % interval != 0:
                continue
            count += 1
            out = os.path.join(output_dir, f"frame_{count:06d}.jpg")
            cv2.imwrite(out, cv2.cvtColor(frame, cv2.COLOR_RGB2BGR),
                        [cv2.IMWRITE_JPEG_QUALITY, 95])
    log.info("extracted %d frames from %s", count, video_path)
    return count


def create_video(
    frame_dir: str,
    output_path: str,
    fps: float = 60,
    codec: Optional[str] = None,
) -> bool:
    """Assemble the sorted ``*.jpg``/``*.jpeg``/``*.png`` frames of
    ``frame_dir`` into a video (the reference's combine_detect.py:479-595),
    resizing any frame of another size to the first's. The codec defaults
    by extension (``video.av.default_codec_for``); if it cannot open,
    mpeg4."""
    import cv2

    log = get_logger("assemble")
    frames = sorted(
        f for f in os.listdir(frame_dir) if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    if not frames:
        log.error("no frames in %s", frame_dir)
        return False
    first = cv2.imread(os.path.join(frame_dir, frames[0]))
    if first is None:
        log.error("unreadable first frame")
        return False
    h, w = first.shape[:2]
    if codec is None:
        codec = default_codec_for(output_path)
    try:
        enc = VideoEncoder(output_path, w, h, fps=fps, codec=codec)
    except IOError:
        enc = VideoEncoder(output_path, w, h, fps=fps, codec="mpeg4")
    with enc:
        for name in frames:
            img = cv2.imread(os.path.join(frame_dir, name))
            if img is None:
                continue
            if img.shape[:2] != (h, w):
                img = cv2.resize(img, (w, h))
            enc.write(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    log.info("wrote %s (%d frames @ %.1f fps)", output_path, len(frames), fps)
    return True


def video_info(video_path: str) -> Tuple[int, int, float, Optional[int]]:
    """(width, height, fps, frame count or None) of a video."""
    with VideoDecoder(video_path) as dec:
        return dec.width, dec.height, dec.fps, dec.nframes


def batch_convert_videos(
    input_dir: str,
    output_parent_dir: str,
    video_format: str = "h265,hevc,265,mp4,mov,avi",
    interval: int = 1,
) -> Tuple[int, int]:
    """Extract frames for every matching video under ``input_dir`` into
    ``<output_parent_dir>/<video path relative to input_dir, no ext>/``
    (the reference's video2picture.py:82-142). Returns (videos converted,
    total frames); a video that fails is logged and skipped."""
    log = get_logger("extract")
    exts = {e.strip().lower().lstrip(".") for e in video_format.split(",") if e.strip()}
    videos = 0
    frames = 0
    for root, _dirs, files in os.walk(input_dir):
        for name in sorted(files):
            if name.rsplit(".", 1)[-1].lower() not in exts:
                continue
            src = os.path.join(root, name)
            # Keyed by the path relative to input_dir: same-named videos in
            # different subdirectories must not overwrite each other.
            rel = os.path.relpath(src, input_dir)
            dst = os.path.join(output_parent_dir, os.path.splitext(rel)[0])
            try:
                n = convert_video_to_frames(src, dst, interval=interval)
            except Exception as e:  # noqa: BLE001 - the batch goes on
                log.error("failed to convert %s: %s", src, e)
                continue
            videos += 1
            frames += n
    log.info("converted %d videos (%d frames) under %s", videos, frames, input_dir)
    return videos, frames


def check_available_codecs(codecs: Tuple[str, ...] = ("libx265", "libx264", "mpeg4", "mjpeg")):
    """Probe encoders by opening a writer of each and writing one frame
    (the reference's combine_detect.py:53-89, video2picture.py
    check_h265_support). Returns {codec: bool}. Without the native libav
    layer the writer is cv2's, which writes mp4v (MPEG-4 part 2) whatever
    codec is asked for: only ``mpeg4`` is reported there, so no other
    codec is claimed for it."""
    native = native_available()
    out = {c: _probe(c) if native or c == "mpeg4" else False for c in codecs}
    get_logger("codecs").info(
        "available codecs (%s): %s", "libav" if native else "cv2 writer, mp4v only", out
    )
    return out


def _probe(codec: str) -> bool:
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        ext = ".avi" if codec == "mjpeg" else ".mp4"
        try:
            with VideoEncoder(os.path.join(d, f"probe_{codec}{ext}"), 64, 64, fps=10,
                              codec=codec) as e:
                e.write(np.zeros((64, 64, 3), np.uint8))
            return True
        except Exception:  # noqa: BLE001 - any failure means unavailable
            return False


def check_h265_support() -> bool:
    """True when HEVC can be encoded (the reference's video2picture.py:5-31)."""
    return check_available_codecs(("libx265",)).get("libx265", False)
