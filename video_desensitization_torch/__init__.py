"""PyTorch/CUDA port of the video desensitization engine.

Face (RetinaFace) and licence-plate (YOLOv8, or RT-DETR) detection plus
in-place mosaic of every detected box, on uint8 NHWC frames. The
hand-written CUDA kernels, the mosaic and RT-DETR's multi-scale deformable
attention, live in ``csrc/`` and are built with ``nvcc`` at first use
(``ops/cuda_mosaic.py``, ``ops/cuda_msda.py``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    With no device given and no CUDA device present this raises: the port
    never continues on the CPU unless the caller asks for it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
