"""Environment diagnostics: can this machine run the CLI's record job?

    python -m video_desensitization_torch.cli.doctor [--link]

Prints one JSON report: torch and CUDA (versions, the device's name and
count), the toolchain (``nvcc``, and whether ``csrc/mosaic.cu`` builds and
loads), the codec layer (``video.av.codec_path()``, the encoders
``video.frames.check_available_codecs`` finds), the native LZ4 codec, and
with ``--link`` the host-to-device copy rate and the engine ``engine =
auto`` would pick at it. ``ok`` is false, with the reasons listed, exactly
when the CLI's default record job cannot run end to end here: no CUDA
device, the mosaic kernel does not build or load, or no HEVC encoder for
the repack. Exit code 0 when ok, 1 otherwise.
"""

from __future__ import annotations

import json
import sys


def collect(probe_link: bool = False) -> dict:
    import numpy as np
    import torch

    from video_desensitization_torch.ops import cuda_mosaic
    from video_desensitization_torch.record import lz4block
    from video_desensitization_torch.video import av
    from video_desensitization_torch.video.frames import check_available_codecs

    reasons = []
    cuda = torch.cuda.is_available()
    report: dict = {
        "torch_version": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "numpy_version": np.__version__,
    }
    if not cuda:
        reasons.append("no CUDA device")
    try:
        import cv2

        report["opencv_version"] = cv2.__version__
    except ImportError:
        report["opencv_version"] = None
        reasons.append("no OpenCV (letterbox, host mosaic and cv2 codecs need it)")

    try:
        report["nvcc"] = cuda_mosaic._nvcc()
    except RuntimeError:
        report["nvcc"] = None
    try:
        report["mosaic_kernel"] = str(cuda_mosaic.build_library())
        cuda_mosaic.load_library()
        report["mosaic_kernel_error"] = None
    except (OSError, RuntimeError) as e:
        report["mosaic_kernel"] = None
        report["mosaic_kernel_error"] = " ".join(str(e).split())[:300]
        reasons.append("csrc/mosaic.cu does not build or load")

    report["codec_path"] = av.codec_path()
    report["native_av"] = av.native_available()
    report["codecs"] = check_available_codecs()
    if not report["codecs"].get("libx265"):
        reasons.append("no HEVC encoder (libx265) for the record repack")
    report["native_lz4"] = lz4block.native_available()

    if probe_link:
        if cuda:
            from video_desensitization_torch.cli.main import pick_engine, probe_link_gib_s

            gib_s = probe_link_gib_s()
            report["link_h2d_gib_s"] = round(gib_s, 3)  # gigaBYTES/s
            report["recommended_engine"] = pick_engine(gib_s)
            report["recommended_engine_yuv420"] = pick_engine(gib_s, "yuv420")
        else:
            report["link_h2d_gib_s"] = None
    report["ok"] = not reasons
    report["reasons"] = reasons
    return report


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="environment diagnostics")
    p.add_argument(
        "--link",
        action="store_true",
        help="also probe the host-to-device copy rate and recommend an engine",
    )
    args = p.parse_args(argv)
    report = collect(probe_link=args.link)
    print(json.dumps(report, indent=1))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
