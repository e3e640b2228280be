"""Directory batch processing — reference ``batch_process_images`` parity
(combine_detect.py:183-277).

Differences by design: the reference runs face and plate models in a 2-thread
pool and mosaics on the CPU; here both detectors and the mosaic run in the
engine on one device (pipeline.engine), and host threads only load and save
the images. Images are grouped by shape into batches.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Optional, Tuple

import numpy as np

from video_desensitization_torch.pipeline.engine import DesensitizationEngine
from video_desensitization_torch.utils.logging import get_logger

IMAGE_EXTS = (".png", ".jpg", ".jpeg")


def load_image_rgb(image_path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(image_path)
    if img is None:
        raise ValueError(f"cannot read image: {image_path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def save_output_image(image_array: np.ndarray, output_path: str) -> None:
    import cv2

    cv2.imwrite(output_path, cv2.cvtColor(image_array, cv2.COLOR_RGB2BGR))


def batch_process_images(
    input_dir: str,
    output_dir: str,
    engine: DesensitizationEngine,
    batch_size: int = 16,
    num_workers: int = 6,
) -> Tuple[int, int, int]:
    """Process every image in input_dir; returns (processed, faces, plates)."""
    log = get_logger("batch_process_images")
    image_paths = [
        os.path.join(input_dir, f)
        for f in sorted(os.listdir(input_dir))
        if f.lower().endswith(IMAGE_EXTS)
    ]
    os.makedirs(output_dir, exist_ok=True)
    total_processed = total_faces = total_plates = 0

    saver = ThreadPoolExecutor(max_workers=num_workers)
    save_futures = []
    t_start = time.time()
    with ThreadPoolExecutor(max_workers=num_workers) as loader:
        for i in range(0, len(image_paths), batch_size):
            files = image_paths[i : i + batch_size]
            images = list(loader.map(load_image_rgb, files))
            # Group by shape (mixed-resolution dirs still work).
            by_shape = {}
            for j, im in enumerate(images):
                by_shape.setdefault(im.shape, []).append(j)
            results = [None] * len(images)
            for shape, idxs in by_shape.items():
                batch = np.stack([images[j] for j in idxs])
                res = engine.process_batch(batch)
                for row, j in enumerate(idxs):
                    results[j] = res.frames[row]
                total_faces += res.num_faces
                total_plates += res.num_plates
            for path, out_img in zip(files, results):
                out_path = os.path.join(
                    output_dir, f"processed_{os.path.basename(path)}"
                )
                save_futures.append(saver.submit(save_output_image, out_img, out_path))
            total_processed += len(files)

    for fut in as_completed(save_futures):
        exc = fut.exception()
        if exc is not None:
            log.error("image save failed: %s", exc)
    saver.shutdown()
    log.info(
        "batch done: %d images, %d faces, %d plates in %.2fs",
        total_processed,
        total_faces,
        total_plates,
        time.time() - t_start,
    )
    return total_processed, total_faces, total_plates
