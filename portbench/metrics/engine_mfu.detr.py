"""The fused engine's model FLOPs with RT-DETR in the plate slot (the
reference networks a frame: RetinaFace's convolutions, and RT-DETR's
convolutions, linear layers and attention products, ``arith/flops.py``,
``arith/detr_flops.py``) at the traced window's frames/s, as a share of
the card's bf16 dense peak (``arith/peaks.py``), in %."""

from portbench.arith.peaks import BF16_FLOPS


def read(obs):
    if not obs.get("detr_flops_per_frame") or obs.get("trace") is None or not obs["trace"].ops:
        return None
    return obs["detr_flops_per_frame"] * obs["frames_window"] / obs["window_s"] / BF16_FLOPS * 100.0
